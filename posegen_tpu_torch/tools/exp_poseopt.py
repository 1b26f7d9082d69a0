"""Pose-refinement proof and long-horizon pose-opt soak (port of
tools/exp_poseopt.py).

Test-time pose refinement, with gradients through the sampler and the
compositor, exists to fix noisy estimated poses. On a synthetic scene,
where the ground truth is known:

  prepare   build a 264-image 256^2 synthetic scene whose H5 carries
            PERTURBED poses (bones + pelvis noise = the "SPIN estimate")
            while the images stay ground-truth renders; GT saved alongside.
  soak      run the h36m_prot2 workload (cli/run_nerf: pose-opt every 50
            iterations, L1 + background + framecodes) on that scene for
            --n_iters steps: the pose error must converge toward GT and
            stay there.
  evalpose  turn the run's *.pose.npz checkpoints into a pose-error-to-GT
            trajectory ({out_dir}/soak_pose_err.json).
  testopt   from the soak's trained NeRF, freshly perturb the poses and run
            --testopt (NeRF frozen, poses optimised): per-joint error and
            val PSNR against the frozen-noisy start, for each anchor
            tolerance ({out_dir}/testopt_recovery.json).

    python -m posegen_tpu_torch.tools.exp_poseopt prepare
    python -m posegen_tpu_torch.tools.exp_poseopt soak --n_iters 30000
    python -m posegen_tpu_torch.tools.exp_poseopt evalpose
    python -m posegen_tpu_torch.tools.exp_poseopt testopt --tols 0.01 0.05 0.0

Every subcommand takes --data_dir (the scene: {data_dir}/synthetic/demo.h5
and gt.npz; JAX's data_poseopt/), --out_dir (the JSONs; JAX's
logs/poseopt/), --basedir (the soak's run is {basedir}/poseopt_soak unless
--log_dir says otherwise) and --cpu; soak and testopt also --nerf_flags,
run_nerf flags appended to the soak's (a smaller net or loader for a short
run). prepare takes the scene's size (--n_images, --hw, --focal; JAX's
264, 256, 320). The soak and testopt run on the card unless --cpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.tools.proof import (
    checkout_path, config_path, required, set_tf32, tool_device,
)

DATA_DIR = checkout_path("data_poseopt")
GT_PATH = None if DATA_DIR is None else os.path.join(DATA_DIR, "synthetic", "gt.npz")
H5_PATH = None if DATA_DIR is None else os.path.join(DATA_DIR, "synthetic", "demo.h5")
LOG_DIR = checkout_path("logs", "poseopt")
SCALE = 0.4  # the synthetic scene's skeleton scale (its rest_pose is SMPL_REST_POSE * 0.4)


def gt_path(data_dir: str) -> str:
    return os.path.join(data_dir, "synthetic", "gt.npz")


def h5_path(data_dir: str) -> str:
    return os.path.join(data_dir, "synthetic", "demo.h5")


def _fk(bones: np.ndarray, pelvis: np.ndarray) -> np.ndarray:
    """Axis-angle bones (F,24,3) + pelvis (F,3) -> world joints (F,24,3)."""
    from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws

    with torch.no_grad():
        l2ws = smpl_l2ws(torch.as_tensor(np.asarray(bones, np.float32)), scale=SCALE).numpy()
    kps = l2ws[..., :3, 3]
    return kps - kps[:, :1] + pelvis[:, None]


def perturb(bones, kp3d, seed, bone_std, pelvis_std):
    """The 'SPIN estimate': bones + N(0, bone_std) rad, pelvis + N(0, t)."""
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws

    rng = np.random.default_rng(seed)
    b_n = bones + rng.standard_normal(bones.shape).astype(np.float32) * bone_std
    delta = rng.standard_normal((len(bones), 3)).astype(np.float32) * pelvis_std
    with torch.no_grad():
        l2ws = smpl_l2ws(torch.as_tensor(np.asarray(b_n, np.float32)), scale=SCALE).numpy()
        # rigid pelvis shift: keep each noisy pose rooted near its GT pelvis
        shift = (kp3d[:, 0] + delta) - l2ws[:, 0, :3, 3]
        l2ws[..., :3, 3] += shift[:, None]
        kp_n = l2ws[..., :3, 3]
        skts_n = invert_rigid(torch.as_tensor(l2ws)).numpy()
        cyls_n = get_kp_bounding_cylinder(torch.as_tensor(kp_n),
                                          ext_scale=0.001).numpy().astype(np.float32)
    return b_n.astype(np.float32), kp_n.astype(np.float32), skts_n, cyls_n


def cmd_prepare(args) -> str:
    """Write the perturbed scene and its GT -> the H5's path. The scene is
    make_synthetic_h5's, rewritten whole with the four pose datasets
    replaced (the port's HDF5 code writes whole files)."""
    from posegen_tpu_torch.data.hdf5 import read_h5, write_h5
    from posegen_tpu_torch.data.synthetic import make_synthetic_h5

    data_dir = required(args.data_dir, "--data_dir")
    h5, gtp = h5_path(data_dir), gt_path(data_dir)
    os.makedirs(os.path.dirname(h5), exist_ok=True)
    make_synthetic_h5(h5, n_images=args.n_images, H=args.hw, W=args.hw, focal=args.focal,
                      seed=args.seed)
    data, _ = read_h5(h5)
    gt_bones, gt_kp3d = data["bones"], data["kp3d"]
    b_n, kp_n, skts_n, cyls_n = perturb(gt_bones, gt_kp3d, args.seed + 1, args.bone_std,
                                        args.pelvis_std)
    for k, v in (("bones", b_n), ("kp3d", kp_n), ("skts", skts_n), ("cyls", cyls_n)):
        if v.shape != data[k].shape:
            raise ValueError(f"prepare: {k} {v.shape} != the scene's {data[k].shape}")
        data[k] = v.astype(data[k].dtype)
    write_h5(h5, data)
    np.savez(gtp, gt_bones=gt_bones, gt_kp3d=gt_kp3d, bone_std=args.bone_std,
             pelvis_std=args.pelvis_std, seed=args.seed)
    err0 = float(np.mean(np.linalg.norm(
        _fk(b_n, kp_n[:, 0]) - _fk(gt_bones, gt_kp3d[:, 0]), axis=-1)))
    print(f"prepared {h5}: initial MPJPE {err0:.4f} units "
          f"({err0 / 0.001 * 0.4:.1f} mm-ish at ext_scale 0.001)")
    return h5


SOAK_ARGS = [
    "--config", "configs/h36m/h36m_prot2.txt",
    # the h36m config sets datadir=./data/h36m/, which (faithfully to the
    # reference's datadir semantics) would override data_root and silently
    # swap in the default 8-image synthetic H5: blank it out so that
    # data_root wins
    "--datadir", "",
    "--data_root", "./data_poseopt", "--dataset_type", "synthetic",
    "--subject", "demo", "--expname", "poseopt_soak", "--basedir", "./logs",
    "--i_print", "500", "--i_pose_weights", "2000", "--i_weights", "20000",
    "--i_testset", "10000", "--i_video", "0",
]


def soak_argv(data_dir: str, basedir: str, extra: Sequence[str] = ()) -> List[str]:
    """SOAK_ARGS with the config under the checkout, the scene's and the
    run's directories, then `extra`."""
    argv = list(SOAK_ARGS)
    for flag, value in (("--config", config_path(SOAK_ARGS[1])), ("--data_root", data_dir),
                        ("--basedir", basedir)):
        argv[argv.index(flag) + 1] = value
    return argv + list(extra)


def _flags(args) -> List[str]:
    return shlex.split(getattr(args, "nerf_flags", "") or "")


def cmd_soak(args, device="cuda") -> str:
    from posegen_tpu_torch.cli.run_nerf import train

    argv = soak_argv(required(args.data_dir, "--data_dir"), required(args.basedir, "--basedir"),
                     _flags(args))
    return train(argv + ["--n_iters", str(args.n_iters)], device=device)


def pose_err_vs_gt(pose_params, gt, kp_map=None) -> dict:
    """MPJPE(FK(params), FK(gt)) and its root-centred variant, over all
    frames (on the host)."""
    from posegen_tpu_torch.pose.opt import pose_apply
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE

    F = len(gt["gt_bones"])
    params = {k: torch.as_tensor(v).detach().float().cpu() for k, v in pose_params.items()}
    with torch.no_grad():
        kps, _, _, _ = pose_apply(
            params, torch.arange(F), torch.as_tensor(SMPL_REST_POSE * SCALE),
            kp_map=None if kp_map is None else torch.as_tensor(kp_map))
    kps = kps.numpy()
    gt_kps = _fk(gt["gt_bones"], gt["gt_kp3d"][:, 0])
    mpjpe = float(np.mean(np.linalg.norm(kps - gt_kps, axis=-1)))
    # the root-centred variant isolates articulation from pelvis placement
    pa = kps - kps[:, :1]
    gb = gt_kps - gt_kps[:, :1]
    mpjpe_rc = float(np.mean(np.linalg.norm(pa - gb, axis=-1)))
    return {"mpjpe": mpjpe, "mpjpe_rc": mpjpe_rc}


def cmd_evalpose(args) -> str:
    from posegen_tpu_torch.data.hdf5 import H5File
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params
    from posegen_tpu_torch.train.checkpoints import load_pose_params

    data_dir = required(args.data_dir, "--data_dir")
    gt = dict(np.load(gt_path(data_dir)))
    rows = []
    # step 0 = the dataset estimates themselves (the frozen-noisy control)
    with H5File(h5_path(data_dir)) as f:
        p0, _ = init_pose_params(PoseOptConfig(use_rot6d=True), f.read("bones"), f.read("kp3d"),
                                 device="cpu")
    rows.append({"step": 0, **pose_err_vs_gt(p0, gt)})
    for p in sorted(glob.glob(os.path.join(args.log_dir, "*.pose.npz"))):
        step = int(os.path.basename(p).split(".")[0])
        rows.append({"step": step, **pose_err_vs_gt(load_pose_params(p, device="cpu"), gt)})
        print(rows[-1], flush=True)
    out_dir = required(args.out_dir, "--out_dir")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "soak_pose_err.json")
    with open(out, "w") as f:
        json.dump({"gt_meta": {k: float(np.asarray(v).reshape(-1)[0])
                               for k, v in gt.items() if k in ("bone_std", "pelvis_std")},
                   "rows": rows}, f, indent=1)
    print(f"wrote {out}")
    return out


def _rd_with_params(render_data, pose_params):
    """render_data with its pose fields replaced by the CURRENT pose params
    (FK'd as the train step does): evaluate_testset otherwise renders the
    dataset's stored estimates, and testopt renders with the refined
    poses."""
    from posegen_tpu_torch.pose.opt import pose_apply
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE

    dev = next(iter(pose_params.values())).device
    idx = torch.as_tensor(np.asarray(render_data["kp_idxs"], np.int64), device=dev)
    with torch.no_grad():
        kps, bones, skts, _ = pose_apply(
            pose_params, idx, torch.as_tensor(SMPL_REST_POSE * SCALE, device=dev))
        cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001)
    rd = dict(render_data)
    rd["kp3d"] = kps.cpu().numpy()
    rd["bones"] = bones.cpu().numpy()
    rd["skts"] = skts.cpu().numpy()
    rd["cyls"] = cyls.cpu().numpy().astype(np.float32)
    return rd


def testopt_state(ckpt: str, cfg, tcfg_soak, tcfg, pose_params, anchors, device):
    """The soak's checkpoint loaded with the SOAK's optimizer layout
    (opt_pose_step 50: MultiSteps' accumulation), then a FRESH testopt
    state from its weights and the given noisy poses."""
    from posegen_tpu_torch.render.raycast import init_raycaster
    from posegen_tpu_torch.train.checkpoints import load_checkpoint
    from posegen_tpu_torch.train.trainer import create_train_state

    variables = init_raycaster(cfg, torch.Generator().manual_seed(0), device=device)
    state_l = create_train_state(variables, tcfg_soak,
                                 {k: v.detach().clone() for k, v in pose_params.items()},
                                 {k: v.clone() for k, v in anchors.items()})
    state_l = load_checkpoint(ckpt, state_l)
    return create_train_state({**state_l.params, **state_l.embeds}, tcfg, pose_params, anchors)


def testopt_loop(step_fn: Callable, state, batches: Iterator[Dict], n_iters: int, gt,
                 device, key_seed: int = 1, log: Optional[Callable] = print):
    """n_iters testopt steps on the loader's batches -> (state, trajectory,
    the last step's stats). Step i's noise generator is seeded from
    (key_seed, i) alone (the JAX tool folds i into PRNGKey(1)); the pose
    error is recorded every n_iters // 8 steps."""
    from posegen_tpu_torch.cli.run_nerf import step_generator

    dev = torch.device(device)
    traj, stats = [], {}
    for i in range(n_iters):
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in next(batches).items()}
        state, stats = step_fn(state, batch, step_generator(key_seed, i, dev))
        if (i + 1) % max(n_iters // 8, 1) == 0:
            e = pose_err_vs_gt(state.pose_params, gt)
            traj.append({"iter": i + 1, **e})
            if log:
                log(f"iter {i + 1}: {e} kp_loss {float(stats.get('kp_loss', 0)):.5f}")
    return state, traj, stats


def testopt_cli(args):
    """The soak's flags with --testopt and opt_pose_step 1 (the NeRF frozen,
    the pose optimizer at full cadence) -> (testopt args, the soak's)."""
    from posegen_tpu_torch.cli.config import nerf_config_parser, parse_with_config

    base = soak_argv(required(args.data_dir, "--data_dir"), required(args.basedir, "--basedir"),
                     _flags(args))
    cli = parse_with_config(nerf_config_parser(),
                            base + ["--testopt", "--n_iters", str(args.n_iters),
                                    "--opt_pose_step", "1"])
    cli_load = parse_with_config(nerf_config_parser(), base + ["--n_iters", "1"])
    return cli, cli_load


def cmd_testopt(args, device="cuda") -> Dict:
    """Fresh perturbation -> --testopt refinement from the trained NeRF."""
    from posegen_tpu_torch.cli.config import (
        args_to_data_config, args_to_raycast_config, args_to_train_config,
    )
    from posegen_tpu_torch.cli.run_nerf import evaluate_testset
    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params
    from posegen_tpu_torch.train.checkpoints import latest_checkpoint
    from posegen_tpu_torch.train.trainer import make_train_step

    dev = torch.device(device)
    data_dir = required(args.data_dir, "--data_dir")
    gt = dict(np.load(gt_path(data_dir)))
    ckpt = args.ckpt or latest_checkpoint(args.log_dir)
    if ckpt is None:
        raise SystemExit(f"testopt: no checkpoint under {args.log_dir}")
    print(f"testopt from {ckpt}")
    cli, cli_load = testopt_cli(args)
    dcfg = args_to_data_config(cli)
    results = {"ckpt": ckpt, "n_iters": args.n_iters, "bone_std": args.bone_std,
               "pelvis_std": args.pelvis_std, "sweeps": [], "tf32": set_tf32(False)}
    # fresh noise, another seed than the soak's dataset perturbation
    b_n, kp_n, _, _ = perturb(gt["gt_bones"], gt["gt_kp3d"], args.seed + 7, args.bone_std,
                              args.pelvis_std)
    out_dir = required(args.out_dir, "--out_dir")
    for tol in args.tols:
        loader, render_data, attrs = load_data(dcfg, pin_memory=dev.type == "cuda")
        try:
            cfg = args_to_raycast_config(cli, n_framecodes=attrs["n_framecodes"])
            tcfg = args_to_train_config(cli)
            assert tcfg.testopt
            pcfg = PoseOptConfig(use_rot6d=True, opt_pose_tol=tol)
            pose_params, anchors = init_pose_params(pcfg, b_n, kp_n, device=dev)
            state = testopt_state(ckpt, cfg, args_to_train_config(cli_load), tcfg,
                                  pose_params, anchors, dev)
            err_before = pose_err_vs_gt(state.pose_params, gt)
            m_before, _ = evaluate_testset(
                cfg, state, _rd_with_params(render_data, state.pose_params), cli.chunk,
                render_factor=2)
            step_fn = make_train_step(cfg, tcfg, pcfg,
                                      rest_pose=torch.as_tensor(attrs["rest_pose"], device=dev),
                                      n_frames=attrs["n_kps"])
            state, traj, _ = testopt_loop(
                step_fn, state, iter(loader), args.n_iters, gt, dev,
                log=lambda m: print(f"tol {tol} {m}", flush=True))
            err_after = pose_err_vs_gt(state.pose_params, gt)
            m_after, _ = evaluate_testset(
                cfg, state, _rd_with_params(render_data, state.pose_params), cli.chunk,
                render_factor=2)
        finally:
            loader.close()
        results["sweeps"].append({
            "tol": tol,
            "mpjpe_before": err_before["mpjpe"],
            "mpjpe_after": err_after["mpjpe"],
            "mpjpe_rc_before": err_before["mpjpe_rc"],
            "mpjpe_rc_after": err_after["mpjpe_rc"],
            "val_psnr_before": m_before["psnr"],
            "val_psnr_after": m_after["psnr"],
            "traj": traj,
        })
        print(f"[testopt tol={tol}] MPJPE {err_before['mpjpe']:.4f} -> "
              f"{err_after['mpjpe']:.4f}; val PSNR {m_before['psnr']:.2f} -> "
              f"{m_after['psnr']:.2f}", flush=True)
        # written after every sweep: a run cut at its time limit keeps the
        # sweeps it finished
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "testopt_recovery.json")
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {out}")
    return results


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("exp_poseopt", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, runs: bool):
        sp.add_argument("--data_dir", default=DATA_DIR)
        sp.add_argument("--out_dir", default=LOG_DIR)
        sp.add_argument("--basedir", default=checkout_path("logs"),
                        help="the soak's run is {basedir}/poseopt_soak")
        sp.add_argument("--cpu", action="store_true", help="run on the host")
        if runs:
            sp.add_argument("--nerf_flags", default="",
                            help="run_nerf flags appended to the soak's, one string")

    pr = sub.add_parser("prepare")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--bone_std", type=float, default=0.08)
    pr.add_argument("--pelvis_std", type=float, default=0.02)
    pr.add_argument("--n_images", type=int, default=264)
    pr.add_argument("--hw", type=int, default=256)
    pr.add_argument("--focal", type=float, default=320.0)
    common(pr, False)
    so = sub.add_parser("soak")
    so.add_argument("--n_iters", type=int, default=100000)
    common(so, True)
    ev = sub.add_parser("evalpose")
    ev.add_argument("--log_dir", default=None, help="the soak's run ({basedir}/poseopt_soak)")
    common(ev, False)
    to = sub.add_parser("testopt")
    to.add_argument("--log_dir", default=None, help="the soak's run ({basedir}/poseopt_soak)")
    to.add_argument("--ckpt", default=None)
    to.add_argument("--n_iters", type=int, default=1500)
    to.add_argument("--seed", type=int, default=0)
    to.add_argument("--bone_std", type=float, default=0.08)
    to.add_argument("--pelvis_std", type=float, default=0.02)
    to.add_argument("--tols", type=float, nargs="+", default=[0.01, 0.05, 0.0])
    common(to, True)
    return p


def main(argv: Optional[Sequence[str]] = None, device="cuda"):
    args = parser().parse_args(argv)
    if args.cmd == "prepare":
        return cmd_prepare(args)
    if args.cmd != "soak" and args.log_dir is None:
        args.log_dir = os.path.join(required(args.basedir, "--basedir"), "poseopt_soak")
    if args.cmd == "evalpose":
        return cmd_evalpose(args)
    dev = tool_device(device, args.cpu)
    if args.cmd == "soak":
        return cmd_soak(args, dev)
    return cmd_testopt(args, dev)


if __name__ == "__main__":
    main()
