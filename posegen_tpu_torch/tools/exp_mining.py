"""Hard-pose-mining proof (port of tools/exp_mining.py).

Generator poses -> NeRF renders -> a frozen SPIN's error is a reward that
steers the generator toward the estimator's failures (reference run_gan.py:
2041-2100); SPIN fine-tuned on the mined set improves (:1849-1952). This
experiment shows whether the loop does its job, in-image:

  Phase 1  Render a pretraining set and a held-out eval split of random
           poses through the trained demo NeRF.
  Phase 2  Pretrain the HMR on the pretraining set until it has a real
           MPJPE signal on blob-person renders.
  Phase 3  Two seeded GAN runs with the SAME frozen pretrained SPIN:
           feedback ON vs OFF. A fixed-noise probe measures the mean SPIN
           error of generated poses for both runs every --probe_every
           iterations; the ON run's sink accumulates the mined (image, pose)
           set, and an equal-size random-pose control set is rendered.
  Phase 4  Fine-tune two copies of the pretrained SPIN, on the mined set and
           on the random control, and evaluate both on the held-out splits
           (easy, hard_gen: the final ON generator's poses, hard_nat: the
           worst quartile of random poses for the pretrained SPIN).

    python -m posegen_tpu_torch.tools.exp_mining \\
        --nerf_args logs/flagship_demo/args.txt \\
        --ckptpath logs/flagship_demo/00001500.ckpt.npz --out /tmp/mining

Writes {out}/summary.json (the JAX tool's keys, and the TF32 setting), the
rendered splits as {split}/image/%05d.png + poses_axis_angles0.npy (the
port's PNG codec) and {out}/spin_pretrained.npz (the JAX package's SPIN
.npz, which run_gan --spin_ckpt and exp_capstone_ft --pretrained take).
The renders run the eval kernels on the card; the image sets stay on the
host, and each batch goes up when it is used. --cpu runs it all on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from posegen_tpu_torch.tools.proof import set_tf32, tool_device

BATCH = 32  # the renders' and SPIN's batch (the JAX tool's)


def draw(seed: int, n: int, pose_std: float) -> np.ndarray:
    """n random axis-angle poses (n, 24, 3), N(0, pose_std) from numpy."""
    rng_d = np.random.default_rng(seed)
    return (rng_d.standard_normal((n, 24, 3)) * pose_std).astype(np.float32)


def feedback_c2w() -> np.ndarray:
    from posegen_tpu_torch.gen.loop import FEEDBACK_EXTRINSIC
    from posegen_tpu_torch.skeleton.cameras import nerf_extrinsic_to_c2w

    return nerf_extrinsic_to_c2w(FEEDBACK_EXTRINSIC)


def render_set(renderer, bones: np.ndarray, out_dir: str) -> None:
    """Render poses with the feedback camera into a sink-layout dir."""
    from posegen_tpu_torch.utils.png import write_png

    img_dir = os.path.join(out_dir, "image")
    os.makedirs(img_dir, exist_ok=True)
    c2ws = np.broadcast_to(feedback_c2w(), (len(bones), 4, 4))
    n = 0
    for s in range(0, len(bones), BATCH):
        imgs = renderer.render_poses(bones[s:s + BATCH], c2ws[s:s + BATCH])
        for img in imgs:
            write_png(os.path.join(img_dir, f"{n:05d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            n += 1
    np.save(os.path.join(out_dir, "poses_axis_angles0.npy"), bones)


def _device(params) -> torch.device:
    return params["conv1"]["w"].device


def mpjpe_per_sample(params, state, x, bones) -> np.ndarray:
    """Per-sample root-centred 14-joint error of SPIN on prepared crops x
    (host or device), the quantity the feedback reward maximises
    (gen/gan.py)."""
    from posegen_tpu_torch.gen.gan import j14_index
    from posegen_tpu_torch.gen.hmr import hmr_apply
    from posegen_tpu_torch.gen.loop import fk_joints
    from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws_from_rots

    dev = _device(params)
    j14 = j14_index(dev)
    with torch.no_grad():
        rotmat = hmr_apply(params, state, torch.as_tensor(x).to(dev))[0]
        pred = smpl_l2ws_from_rots(rotmat, scale=0.4)[..., :3, 3].index_select(1, j14)
        gt = fk_joints(torch.as_tensor(np.asarray(bones, np.float32)).to(dev)).index_select(1, j14)
        pred = pred - pred[:, :1]
        gt = gt - gt[:, :1]
        return torch.linalg.norm(pred - gt, dim=-1).mean(-1).cpu().numpy()


def mpjpe_prepared(params, state, x, bones) -> float:
    """The mean of `mpjpe_per_sample` over all of x, BATCH crops a forward."""
    return float(np.mean(np.concatenate([
        mpjpe_per_sample(params, state, x[s:s + BATCH], bones[s:s + BATCH])
        for s in range(0, len(bones), BATCH)])))


def spin_mpjpe(params, state, imgs: np.ndarray, bones: np.ndarray) -> float:
    """Mean root-centred 14-joint error of SPIN on rendered frames."""
    from posegen_tpu_torch.gen.loop import prepare_spin_input

    return mpjpe_prepared(params, state, prepare_spin_input(imgs, device=_device(params)), bones)


def _read_frames(img_dir: str, idxs) -> np.ndarray:
    from posegen_tpu_torch.utils.png import read_png

    return np.stack([read_png(os.path.join(img_dir, f"{int(i):05d}.png"))[..., :3] / 255.0
                     for i in idxs]).astype(np.float32)


def _prepared(img_dir: str, idxs, device) -> np.ndarray:
    """PNGs -> prepared SPIN crops (N, 3, 224, 224) float32 on the host."""
    from posegen_tpu_torch.gen.loop import prepare_spin_input

    idxs = list(idxs)
    return np.concatenate([
        prepare_spin_input(_read_frames(img_dir, idxs[s:s + BATCH]), device=device).cpu().numpy()
        for s in range(0, len(idxs), BATCH)])


def _joints(bones: np.ndarray, device) -> np.ndarray:
    from posegen_tpu_torch.gen.loop import fk_joints

    with torch.no_grad():
        return fk_joints(torch.as_tensor(np.asarray(bones, np.float32)).to(device)).cpu().numpy()


def load_split(out_dir: str, bones: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """Read a rendered split ONCE -> (prepared crops on the host, FK'd
    24-joint GT): PNG decode, crop / resize / normalise happen here a single
    time, and all training and eval then runs from memory."""
    x = _prepared(os.path.join(out_dir, "image"), range(len(bones)), device)
    return x, _joints(bones, device)


def train_spin_inmem(params, state, x, gt, epochs: int, lr: float, seed: int, eval_xy=None,
                     tag: str = "", log_every: int = 20):
    """BN-frozen SPIN training over in-memory prepared crops (train_spin's
    make_spin_finetune_step, minus the per-epoch PNG decode) -> a trained
    copy of params. Batches of BATCH in a numpy permutation per
    epoch, each uploaded when used; the dropout masks from a torch
    generator seeded `seed`."""
    from posegen_tpu_torch.gen.hmr import dropout_masks
    from posegen_tpu_torch.gen.spin_train import make_spin_finetune_step
    from posegen_tpu_torch.train.trainer import trainable

    dev = _device(params)
    opt, step = make_spin_finetune_step(lr=lr, hinge=None)
    params = trainable(params)
    opt_state = opt.init(params)
    rng_l = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for epoch in range(epochs):
        perm = rng_l.permutation(len(x))
        losses = []
        for s in range(0, len(perm) - BATCH + 1, BATCH):
            b = perm[s:s + BATCH]
            params, opt_state, st = step(params, state, opt_state,
                                         torch.as_tensor(x[b]).to(dev),
                                         torch.as_tensor(gt[b]).to(dev),
                                         dropout_masks(gen, BATCH))
            losses.append(float(st["spin_loss"]))
        if epoch % log_every == 0 or epoch == epochs - 1:
            msg = f"[{tag}] epoch {epoch}: loss {np.mean(losses) if losses else float('nan'):.5f}"
            if eval_xy is not None:
                msg += f" eval MPJPE {mpjpe_prepared(params, state, *eval_xy):.4f}"
            print(msg, flush=True)
    return params


def eval_on_dir(params, state, out_dir: str, bones: np.ndarray) -> float:
    """The mean of the per-batch mean errors on a rendered split."""
    x, _ = load_split(out_dir, bones, _device(params))
    return float(np.mean([
        float(np.mean(mpjpe_per_sample(params, state, x[s:s + BATCH], bones[s:s + BATCH])))
        for s in range(0, len(bones), BATCH)]))


def probe(trainer, probe_real: np.ndarray, probe_noises: Dict[str, torch.Tensor]) -> float:
    """Mean SPIN error on poses generated from FIXED inputs and noises, the
    whole frame rendered: the hardness of the generator's current output
    distribution. (gen/loop.probe_hardness renders only the crop window,
    whose chunks differ, so it is not this rule.)"""
    from posegen_tpu_torch.gen.generators import pose_generator_apply

    with torch.no_grad():
        out, _ = pose_generator_apply(
            trainer.g_params, trainer.g_state, None,
            torch.as_tensor(probe_real, dtype=torch.float32).to(trainer.device),
            trainer.gen_cfg, noises=probe_noises)
    bones = out["pose_ba"].cpu().numpy()
    imgs = trainer.renderer.render_poses(bones,
                                         np.broadcast_to(feedback_c2w(), (len(bones), 4, 4)))
    return spin_mpjpe(trainer.spin_params, trainer.spin_state, imgs, bones)


def generate(g_params, g_state, gen_cfg, real: np.ndarray, seed: int, device) -> np.ndarray:
    """Generator poses (pose_ba) of `real` rows, the noises from a torch
    generator seeded `seed` on `device` (the JAX tool's PRNGKey(seed))."""
    from posegen_tpu_torch.gen.generators import draw_noises, pose_generator_apply

    noises = draw_noises(torch.Generator(device=device).manual_seed(seed), len(real), gen_cfg)
    with torch.no_grad():
        out, _ = pose_generator_apply(g_params, g_state, None,
                                      torch.as_tensor(real, dtype=torch.float32).to(device),
                                      gen_cfg, noises=noises)
    return out["pose_ba"].cpu().numpy()


def save_spin(path: str, params, state) -> str:
    """The JAX package's SPIN .npz ({params, state}, HWIO convs)."""
    from posegen_tpu_torch.train.checkpoints import _flatten
    from posegen_tpu_torch.utils.convert import hmr_to_numpy

    np.savez(path, **_flatten(dict(zip(("params", "state"), hmr_to_numpy(params, state)))))
    return path


def load_spin(path: str, params, state):
    """`save_spin`'s file (or the JAX tool's) into the given HMR's tree."""
    from posegen_tpu_torch.train.checkpoints import _unflatten_into
    from posegen_tpu_torch.train.trainer import tree_map
    from posegen_tpu_torch.utils.convert import hmr_from_numpy, hmr_to_numpy

    template = tree_map(torch.as_tensor, dict(zip(("params", "state"),
                                                   hmr_to_numpy(params, state))))
    tree = _unflatten_into(template, dict(np.load(path)))
    return hmr_from_numpy(tree["params"], tree["state"], _device(params))


def load_mined_subset(mined_dir: str, mined_sel: np.ndarray, mined_bones: np.ndarray,
                      device) -> Tuple[np.ndarray, np.ndarray]:
    """The selected sink images, prepared, and their FK'd GT."""
    x = _prepared(os.path.join(mined_dir, "image"), mined_sel, device)
    return x, _joints(mined_bones, device)


def eval_all(params, state, splits: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> Dict[str, float]:
    """Mean error on each held-out split {name: (crops, bones)}."""
    return {name: mpjpe_prepared(params, state, x, bones) for name, (x, bones) in splits.items()}


def worst_quartile(errs: np.ndarray, n: int) -> np.ndarray:
    """The n samples of largest error (the naturally-hard split's rule)."""
    return np.argsort(errs)[-n:]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("exp_mining", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nerf_args", required=True)
    p.add_argument("--ckptpath", required=True)
    p.add_argument("--out", default="/tmp/mining")
    p.add_argument("--n_pretrain", type=int, default=256)
    p.add_argument("--n_eval", type=int, default=64)
    p.add_argument("--pretrain_epochs", type=int, default=200)
    p.add_argument("--finetune_epochs", type=int, default=30)
    p.add_argument("--gan_epochs", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--pool_n", type=int, default=2048)
    p.add_argument("--rpi", type=int, default=8)
    p.add_argument("--probe_every", type=int, default=16,
                   help="G-iters between fixed-noise hardness probes")
    p.add_argument("--probe_n", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render_hw", type=int, default=512)
    p.add_argument("--feedback_every", type=int, default=5,
                   help="reference cadence 5 (run_gan.py:2041); lower = "
                        "stronger mining signal per iteration")
    p.add_argument("--spin_coef", type=float, default=0.1,
                   help="reference 0.1 (run_gan.py:2099)")
    p.add_argument("--ft_n", type=int, default=288,
                   help="fine-tune set size (mined subsampled, control "
                        "rendered, both equal)")
    p.add_argument("--pose_std", type=float, default=0.3,
                   help="std of every random pose draw; keep at/below the "
                        "NeRF's training-pose std (0.15 for the demo "
                        "scene) or renders of out-of-range poses degrade")
    p.add_argument("--feedback_start_epoch", type=int, default=-1,
                   help="feedback active when epoch > this (reference 2)")
    p.add_argument("--pretrain_gen_n", type=int, default=0,
                   help="extra pretraining renders drawn from the INITIAL "
                        "(t=0) generator distribution")
    p.add_argument("--cpu", action="store_true", help="run on the host")
    return p


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    args = parser().parse_args(argv)
    dev = tool_device(device, args.cpu)

    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.gen.datasets import RenderedPoseDataset
    from posegen_tpu_torch.gen.generators import GenConfig, draw_noises, init_pose_generator
    from posegen_tpu_torch.gen.hmr import init_hmr
    from posegen_tpu_torch.gen.loop import GanLoopConfig, GanTrainer, NeRFRenderer

    os.makedirs(args.out, exist_ok=True)
    summary = {"args": vars(args), "tf32": set_tf32(False)}
    d = lambda seed, n: draw(seed, n, args.pose_std)  # noqa: E731

    _, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=dev)
    renderer = NeRFRenderer(cfg, variables, hw=args.render_hw, white_bkgd=False, chunk=32768)

    # ---- Phase 1: pretrain + eval splits -----------------------------------
    t0 = time.time()
    pool_pre = d(args.seed + 100, args.n_pretrain + args.n_eval)
    pre_bones = pool_pre[:args.n_pretrain]
    eval_bones = pool_pre[args.n_pretrain:]
    pre_dir = os.path.join(args.out, "pretrain")
    eval_dir = os.path.join(args.out, "eval")
    if not os.path.exists(os.path.join(pre_dir, "poses_axis_angles0.npy")):
        render_set(renderer, pre_bones, pre_dir)
        render_set(renderer, eval_bones, eval_dir)
    print(f"phase 1 (splits rendered): {time.time() - t0:.0f} s")

    # optional generator-distribution pretraining additions (the t=0
    # generator, the init the A/B's GanTrainer starts from: seed)
    if args.pretrain_gen_n > 0:
        gen_dir = os.path.join(args.out, "pretrain_gen")
        g0_params, g0_state = init_pose_generator(torch.Generator().manual_seed(args.seed),
                                                  GenConfig(), dev)
        gen_pre_bones = generate(g0_params, g0_state, GenConfig(),
                                 d(args.seed + 4242, args.pretrain_gen_n), args.seed + 4242, dev)
        if not os.path.exists(os.path.join(gen_dir, "poses_axis_angles0.npy")):
            render_set(renderer, gen_pre_bones, gen_dir)

    # ---- Phase 2: pretrain the HMR -----------------------------------------
    t0 = time.time()
    spin_params, spin_state = init_hmr(torch.Generator().manual_seed(args.seed + 2), device=dev)
    x_pre, gt_pre = load_split(pre_dir, pre_bones, dev)
    if args.pretrain_gen_n > 0:
        x_g, gt_g = load_split(gen_dir, gen_pre_bones, dev)
        x_pre = np.concatenate([x_pre, x_g])
        gt_pre = np.concatenate([gt_pre, gt_g])
    x_eval, _ = load_split(eval_dir, eval_bones, dev)
    mpjpe_init = mpjpe_prepared(spin_params, spin_state, x_eval, eval_bones)
    print(f"random-init SPIN eval MPJPE: {mpjpe_init:.4f}", flush=True)

    pretrained_npz = os.path.join(args.out, "spin_pretrained.npz")
    if os.path.exists(pretrained_npz):
        spin_params, spin_state = load_spin(pretrained_npz, spin_params, spin_state)
    else:
        spin_params = train_spin_inmem(
            spin_params, spin_state, x_pre, gt_pre, epochs=args.pretrain_epochs, lr=3e-4,
            seed=args.seed, eval_xy=(x_eval, eval_bones), tag="pretrain")
        save_spin(pretrained_npz, spin_params, spin_state)
    mpjpe_pre = mpjpe_prepared(spin_params, spin_state, x_eval, eval_bones)
    print(f"pretrained SPIN eval MPJPE: {mpjpe_pre:.4f} "
          f"(phase 2: {time.time() - t0:.0f} s)", flush=True)
    summary["spin_eval_mpjpe_random_init"] = mpjpe_init
    summary["spin_eval_mpjpe_pretrained"] = mpjpe_pre

    # ---- Phase 3: GAN A/B, feedback ON vs OFF ------------------------------
    pool = d(args.seed, args.pool_n)
    probe_real = d(args.seed + 300, args.probe_n)
    probe_noises = draw_noises(torch.Generator(device=dev).manual_seed(args.seed + 777),
                               args.probe_n, GenConfig())
    steps_per_epoch = args.pool_n // args.batch_size
    curves = {}
    on_trainer = None
    for tag, fb in (("feedback_on", True), ("feedback_off", False)):
        t0 = time.time()
        loop_cfg = GanLoopConfig(
            n_epochs=args.gan_epochs, df=2, feedback_every=args.feedback_every,
            feedback_start_epoch=(args.feedback_start_epoch if fb else 10**9),
            rpi=args.rpi, render_hw=args.render_hw, spin_coef=args.spin_coef,
            output_dir=os.path.join(args.out, "mined") if fb else None)
        trainer = GanTrainer(loop_cfg, renderer, spin_params, spin_state, gen_cfg=GenConfig(),
                             steps_per_epoch=steps_per_epoch, seed=args.seed, device=dev)
        curve = []
        rng = np.random.default_rng(args.seed)
        stats = {}
        for epoch in range(args.gan_epochs):
            trainer.epoch = epoch  # train_step is driven directly so that probes interleave
            perm = rng.permutation(len(pool))
            for s in range(0, len(perm) - args.batch_size + 1, args.batch_size):
                if trainer.iter_num % args.probe_every == 0:
                    curve.append((trainer.iter_num, probe(trainer, probe_real, probe_noises)))
                    print(f"[{tag}] iter {trainer.iter_num}: probe MPJPE {curve[-1][1]:.4f}",
                          flush=True)
                stats = trainer.train_step(pool[perm[s:s + args.batch_size]])
            print(f"[{tag}] epoch {epoch}: {stats}", flush=True)
        trainer.flush_sink()
        curve.append((trainer.iter_num, probe(trainer, probe_real, probe_noises)))
        curves[tag] = curve
        print(f"[{tag}] done in {time.time() - t0:.0f} s; final probe MPJPE {curve[-1][1]:.4f}",
              flush=True)
        if fb:
            on_trainer = trainer
    summary["probe_curves"] = curves

    # ---- equal-size sets: mined subsample vs random control ----------------
    mined_dir = os.path.join(args.out, "mined")
    mined_ds = RenderedPoseDataset(mined_dir)
    n_mined_total = len(mined_ds)
    if n_mined_total == 0:
        raise RuntimeError("exp_mining: the feedback-on run produced no mined renders")
    n_ft = min(args.ft_n, n_mined_total)
    # subsample the mined sink uniformly (spread over the whole run)
    mined_sel = np.linspace(0, n_mined_total - 1, n_ft).astype(int)
    mined_bones = mined_ds.bones[mined_sel]
    control_dir = os.path.join(args.out, "control")
    control_bones = d(args.seed + 400, n_ft)
    ctrl_imgs = os.path.join(control_dir, "image")
    if (len(os.listdir(ctrl_imgs)) if os.path.exists(ctrl_imgs) else 0) < n_ft:
        render_set(renderer, control_bones, control_dir)
    summary["n_mined"] = n_mined_total
    summary["n_ft"] = n_ft

    # ---- hard held-out split: poses from the final feedback-on generator at
    # held-out noise (the failure modes mining targets) ----------------------
    hard_dir = os.path.join(args.out, "eval_hard")
    hard_bones = generate(on_trainer.g_params, on_trainer.g_state, on_trainer.gen_cfg,
                          d(args.seed + 999, args.n_eval), args.seed + 888, dev)
    render_set(renderer, hard_bones, hard_dir)
    x_hard, _ = load_split(hard_dir, hard_bones, dev)

    # ---- naturally-hard split: the worst quartile of RANDOM poses by the
    # pretrained error (nothing here came from the generator) ----------------
    nat_dir = os.path.join(args.out, "eval_nat")
    nat_pool = d(args.seed + 1234, 4 * args.n_eval)
    if not os.path.exists(os.path.join(nat_dir, "poses_axis_angles0.npy")):
        render_set(renderer, nat_pool, nat_dir)
    x_nat_all, _ = load_split(nat_dir, nat_pool, dev)
    errs_nat = np.concatenate([
        mpjpe_per_sample(spin_params, spin_state, x_nat_all[s:s + BATCH], nat_pool[s:s + BATCH])
        for s in range(0, len(nat_pool), BATCH)])
    worst = worst_quartile(errs_nat, args.n_eval)
    splits = {"easy": (x_eval, eval_bones), "hard_gen": (x_hard, hard_bones),
              "hard_nat": (x_nat_all[worst], nat_pool[worst])}

    # hardness of each training set for the PRETRAINED estimator
    x_mined, gt_mined = load_mined_subset(mined_dir, mined_sel, mined_bones, dev)
    x_ctrl, gt_ctrl = load_split(control_dir, control_bones, dev)
    summary["mined_set_mpjpe_pretrained"] = mpjpe_prepared(spin_params, spin_state, x_mined,
                                                           mined_bones)
    summary["control_set_mpjpe_pretrained"] = mpjpe_prepared(spin_params, spin_state, x_ctrl,
                                                             control_bones)
    print(f"set hardness (pretrained SPIN): mined "
          f"{summary['mined_set_mpjpe_pretrained']:.4f} vs random "
          f"{summary['control_set_mpjpe_pretrained']:.4f}", flush=True)

    # ---- Phase 4: fine-tune on mined vs control; eval easy + hard splits ---
    summary["pretrained_eval"] = eval_all(spin_params, spin_state, splits)
    print(f"pretrained eval: {summary['pretrained_eval']}", flush=True)
    results = {}
    for tag, (x_ft, gt_ft) in (("mined", (x_mined, gt_mined)), ("control", (x_ctrl, gt_ctrl))):
        t0 = time.time()
        ft_params = train_spin_inmem(spin_params, spin_state, x_ft, gt_ft,
                                     epochs=args.finetune_epochs, lr=5e-5, seed=args.seed + 5,
                                     eval_xy=(x_eval, eval_bones), tag=f"ft-{tag}")
        results[tag] = eval_all(ft_params, spin_state, splits)
        print(f"fine-tuned on {tag}: held-out MPJPE {results[tag]} ({time.time() - t0:.0f} s)",
              flush=True)
    summary["finetune_eval_mpjpe"] = results

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "probe_curves"}, indent=2))
    return summary


if __name__ == "__main__":
    main()
