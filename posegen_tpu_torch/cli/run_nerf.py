"""Training CLI (port of posegen_tpu/cli/run_nerf.py):

    python -m posegen_tpu_torch.cli.run_nerf --config configs/...txt

Capability parity with reference run_nerf.py train() (:493-627): data ->
raycaster -> train loop with periodic val renders (PSNR/SSIM to tensorboard
+ txt), checkpoints with auto-resume, args dumping. The flags are the JAX
package's (cli/config.py), so `args.txt` is byte-equal between the packages
and the checkpoints load in either. It trains on the card unless the caller
asks for the CPU: `train(argv, device="cpu")` (a keyword argument, not a
flag). The loader hands out pinned batches on CUDA, uploaded without a
stream synchronisation; the steps run the trainable field kernels and the
val renders the eval kernels.

Data parallelism (JAX run_nerf.py:245-275; parallel/mesh.py): `--n_devices`
picks the ranks (`rank_count`), which `train` spawns on this node, or

    torchrun --nproc_per_node N -m posegen_tpu_torch.cli.run_nerf ...

starts them (WORLD_SIZE set: every rank of torchrun's world joins). Each
rank reads the node's whole batch and trains on its whole image groups
(`shard_batch`), gradients and stats averaged over the ranks; the val
frames and the spiral video render over the ranks too. Rank 0 alone writes
checkpoints, logs and images; at the end the ranks' states are checked
bit-equal.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as tnf

from posegen_tpu_torch.cli.config import (
    args_to_data_config,
    args_to_raycast_config,
    args_to_train_config,
    dump_args,
    nerf_config_parser,
    parse_with_config,
    validate_args,
)
from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.parallel import mesh as pmesh


def _resize_bilinear(img: np.ndarray, hw, dev: torch.device, antialias: bool) -> np.ndarray:
    """(h, w, 3) -> (H, W, 3) float32, half-pixel centres: jax.image.resize's
    "bilinear", which antialiases when it shrinks."""
    t = torch.as_tensor(np.asarray(img, np.float32), device=dev).permute(2, 0, 1)[None]
    out = tnf.interpolate(t, size=tuple(hw), mode="bilinear", align_corners=False,
                          antialias=antialias)
    return out[0].permute(1, 2, 0).cpu().numpy()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Step `step`'s noise generator, seeded from (seed, step) alone, so a
    resumed run draws what an unbroken run draws (JAX folds the step into
    its key: run_nerf.py:289)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def evaluate_testset(cfg, state, render_data, chunk: int = 4096, render_factor: int = 0,
                     mesh=None):
    """Render held-out views and compute PSNR/SSIM
    (reference render_testset + evaluate_metric, run_nerf.py:557-604), on
    the device of the state.

    Matches the reference's val conventions: real per-frame codes when
    opt_framecode (cams_val, run_nerf.py:574), GT composited over the
    stored backgrounds when the H5 has them (masked_gts, :580-584), and
    render_factor > 0 renders at H//f then bilinear-upsamples back to GT
    resolution for the metrics (evaluation_helpers.py:309-313).

    mesh: a mesh of more than one rank splits each chunk's rays over its
    ranks (`parallel.mesh.make_shardmap_render_cam`, the chunk rounded down
    to a multiple of the ranks; JAX run_nerf.py:54-59); every rank gets the
    frames."""
    from posegen_tpu_torch.evals.image import evaluate_metric
    from posegen_tpu_torch.kernels.field import fused_config_disqualification
    from posegen_tpu_torch.render.image import render_image
    from posegen_tpu_torch.render.raycast import PoseCtx

    if fused_config_disqualification(cfg) is not None:
        # the plain pipeline materializes the per-point encodings
        chunk = min(chunk, 8192)
    render_fn = None
    if mesh is not None and mesh.size > 1:
        chunk = chunk - (chunk % mesh.size) or mesh.size
        render_fn = pmesh.make_shardmap_render_cam(cfg, mesh, chunk)
    params = {**state.params, **state.embeds}
    dev = state.params["coarse"]["pts_linears"][0]["w"].device
    on_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    H, W, _ = render_data["hwf"]
    RH, RW = (H, W) if render_factor <= 0 else (H // render_factor, W // render_factor)
    bgs = render_data.get("bkgds")
    focals = np.ravel(render_data["focals"])
    rgbs, gts = [], []
    with torch.no_grad():
        for i in range(render_data["imgs"].shape[0]):
            ci = int(render_data["cam_idxs"][i])
            # a genuinely held-out view (--use_val) may carry a cam idx with no
            # trained framecode row: render it with the mean code
            use_code = cfg.opt_framecode and 0 <= ci < max(cfg.n_framecodes, 1)
            ctx = PoseCtx(
                kps=on_dev(render_data["kp3d"][i:i + 1]),
                skts=on_dev(render_data["skts"][i:i + 1]),
                bones=on_dev(render_data["bones"][i:i + 1]),
                cyls=on_dev(render_data["cyls"][i:i + 1]),
                cam_idxs=(torch.tensor([[ci]], dtype=torch.int32, device=dev)
                          if use_code else None),
            )
            focal = float(focals[min(i, focals.size - 1)])
            bg = None
            if bgs is not None:
                bg = bgs[min(i, len(bgs) - 1)]
                if render_factor > 0:
                    bg = _resize_bilinear(bg, (RH, RW), dev, antialias=True)
            out = render_image(
                cfg, params, RH, RW, focal / max(render_factor, 1),
                render_data["c2ws"][i], ctx, chunk=chunk, bg=bg, render_fn=render_fn,
            )
            rgb = out["rgb"]
            if render_factor > 0:
                rgb = _resize_bilinear(rgb, (H, W), dev, antialias=False)
            rgbs.append(rgb)
            mask = render_data["masks"][i]
            if mask.ndim == 2:
                mask = mask[..., None]
            gt = render_data["imgs"][i] * mask
            if bgs is not None:
                gt = gt + (1.0 - mask) * bgs[min(i, len(bgs) - 1)]
            gts.append(gt)
    metrics = evaluate_metric(np.stack(rgbs), np.stack(gts), device=dev)
    return {k: float(np.mean(v)) for k, v in metrics.items()}, np.stack(rgbs)


def save_spiral_video(
    cfg, state, render_data, log_dir: str, step: int,
    n_frames: int = 10, factor: int = 2, chunk: int = 8192,
) -> str:
    """Bullet-time turn-around of val pose 0 written as rgb + disp GIFs
    (reference i_video render_poses mp4s, run_nerf.py:557-604 — format
    adapted: GIFs through the port's own `utils/gif.write_gif`). The frames
    render through `parallel.mesh.auto_render_fn` (over every rank of a
    world); rank 0 writes the GIFs."""
    from posegen_tpu_torch.utils.gif import write_gif

    from posegen_tpu_torch.render.image import _bullet_c2ws, render_path
    from posegen_tpu_torch.render.raycast import PoseCtx

    params = {**state.params, **state.embeds}
    dev = state.params["coarse"]["pts_linears"][0]["w"].device
    on_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    H, W, focal = render_data["hwf"]
    H, W, focal = H // factor, W // factor, float(np.ravel(focal)[0]) / factor
    kp0 = np.asarray(render_data["kp3d"])[0, 0]
    dist = float(np.linalg.norm(np.asarray(render_data["c2ws"])[0][:3, 3] - kp0))
    c2ws = _bullet_c2ws(kp0, dist, n_frames)
    ctx = PoseCtx(
        kps=on_dev(render_data["kp3d"][:1]), skts=on_dev(render_data["skts"][:1]),
        bones=on_dev(render_data["bones"][:1]), cyls=on_dev(render_data["cyls"][:1]),
    )
    # u8 GIF output: f16 readback is free accuracy-wise
    render_fn, chunk = pmesh.auto_render_fn(cfg, chunk, half_readback=True)
    with torch.no_grad():
        out = render_path(cfg, params, c2ws, (H, W, focal), [ctx], chunk=chunk,
                          render_fn=render_fn, half_readback=True)
    rgb_path = os.path.join(log_dir, f"spiral_{step:06d}_rgb.gif")
    if pmesh.world_rank() != 0:
        return rgb_path
    write_gif(rgb_path, (np.clip(out["rgbs"], 0, 1) * 255).astype(np.uint8), fps=5, loop=0)
    disp = out["disps"] / max(float(out["disps"].max()), 1e-8)
    write_gif(os.path.join(log_dir, f"spiral_{step:06d}_disp.gif"),
              (np.clip(disp, 0, 1) * 255).astype(np.uint8), fps=5, loop=0)
    return rgb_path


def rank_count(n_devices: int, dev: torch.device) -> int:
    """The ranks `train` spawns for --n_devices on `dev` (the JAX package's
    rule over its devices): on CUDA every card for 0, else min(n, cards),
    never more ranks than cards; on the CPU n gloo ranks for n > 1, else
    one."""
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        return cards if n_devices == 0 else max(min(n_devices, cards), 1)
    return max(n_devices, 1)


def train(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Train a NeRF from the config and flags of `argv` on `device` (CUDA
    by default; raises without a card) -> the run's log dir. Data-parallel
    over `rank_count` ranks, or over torchrun's world."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_with_config(nerf_config_parser(), argv)
    validate_args(args)
    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        pmesh.init_from_env(dev.type)
        try:
            return _train(args, pmesh.make_mesh())
        finally:
            pmesh.shutdown()
    n = rank_count(args.n_devices, dev)
    if n > 1:
        _check_groups(args, n)
        pmesh.launch(_train_rank, n, dev.type, args=(argv,))
        return os.path.join(args.basedir, args.expname)
    return _train(args, None, dev)


def _check_groups(args, n: int) -> None:
    if args.N_sample_images % n != 0:
        raise SystemExit(
            f"--N_sample_images ({args.N_sample_images}) must be a multiple of the device "
            f"count ({n}) so each chip gets whole image groups")


def _train_rank(mesh, argv) -> None:
    _train(parse_with_config(nerf_config_parser(), argv), mesh)


def _train(args, mesh, dev=None) -> str:
    """The training run of one rank of `mesh` (None: one device, `dev`)."""
    dev = mesh.device if mesh is not None else dev
    writer_rank = mesh is None or pmesh.world_rank() == 0
    log_dir = os.path.join(args.basedir, args.expname)
    if writer_rank:
        dump_args(log_dir, args)

    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params
    from posegen_tpu_torch.render.raycast import init_raycaster
    from posegen_tpu_torch.train.checkpoints import (
        latest_checkpoint,
        load_checkpoint,
        load_pose_params,
        save_checkpoint,
        save_pose_checkpoint,
    )
    from posegen_tpu_torch.train.trainer import create_train_state, make_train_step

    dcfg = args_to_data_config(args)
    if mesh is not None:
        _check_groups(args, mesh.size)
        # multi-node: each node draws a disjoint image shard per epoch; the
        # ranks of a node all build its whole batch (JAX run_nerf.py:174-175)
        dcfg.process_index, dcfg.process_count = pmesh.node_index_count()
    loader, render_data, attrs = load_data(dcfg, pin_memory=dev.type == "cuda")
    cfg = args_to_raycast_config(args, n_framecodes=attrs["n_framecodes"])
    tcfg = args_to_train_config(args)

    variables = init_raycaster(
        cfg, torch.Generator().manual_seed(args.seed), cutoff_mm=args.cutoff_mm,
        ext_scale=attrs["ext_scale"], device=dev,
    )
    pose_params = anchors = None
    pcfg = None
    kp_map = attrs.get("kp_map")
    if kp_map is not None:
        kp_map = torch.as_tensor(kp_map, dtype=torch.long, device=dev)
    if args.opt_pose:
        pcfg = PoseOptConfig(
            use_rot6d=args.opt_rot6d, opt_pose_tol=args.opt_pose_tol,
            opt_pose_type=args.opt_pose_type, ext_scale=args.ext_scale,
        )
        pose_params, anchors = init_pose_params(
            pcfg, attrs["bones"], attrs["kp3d"],
            kp_map=attrs.get("kp_map"), kp_uidxs=attrs.get("kp_uidxs"), device=dev,
        )
        if args.init_poseopt:
            # initialize the poseopt layer from a specific checkpoint
            # (reference --init_poseopt, pose_opt.py:212)
            loaded = load_pose_params(args.init_poseopt, device=dev)
            pose_params = {k: v.detach().float().clone().requires_grad_(True)
                           for k, v in loaded.items()}
            print(f"initialized pose params from {args.init_poseopt}")
            if args.use_ckpt_anchor:
                # anchor the reg loss to the CHECKPOINT's poses instead of
                # the dataset estimates (reference pose_opt.py:62-67)
                anchors = {k: v.detach().clone() for k, v in pose_params.items()}
    state = create_train_state(variables, tcfg, pose_params, anchors)

    # auto-resume (reference raycasters.py:124-142)
    start = 0
    if not args.no_reload:
        ckpt = args.ft_path or latest_checkpoint(log_dir)
        if ckpt:
            fresh_pose = (state.pose_params, state.pose_anchors)
            state = load_checkpoint(ckpt, state)
            if args.no_poseopt_reload and state.pose_params is not None:
                # keep NeRF weights from the ckpt but restart poses (and
                # their optimizer/anchors) from the dataset estimates
                # (reference create_popt skips the poseopt restore,
                # pose_opt.py:51-60)
                fresh = create_train_state(
                    {**state.params, **state.embeds}, tcfg, *fresh_pose
                )
                state = state._replace(
                    pose_params=fresh.pose_params,
                    pose_anchors=fresh.pose_anchors,
                    pose_opt_state=fresh.pose_opt_state,
                )
                print("poseopt state NOT restored (--no_poseopt_reload)")
            if args.finetune:
                # fine-tune: weights only — fresh optimizer + step counter
                # (reference --finetune, raycasters.py:140-141)
                state = create_train_state(
                    {**state.params, **state.embeds}, tcfg,
                    state.pose_params, state.pose_anchors,
                )
            else:
                start = int(state.step)
            print(f"resumed from {ckpt} at step {start}")

    rest_pose = torch.as_tensor(attrs["rest_pose"], device=dev)
    if mesh is not None:
        # the full step per rank on its whole image groups, gradients and
        # stats averaged over the ranks (JAX run_nerf.py:245-275)
        state = pmesh.replicate(state, mesh)
        step_fn = pmesh.make_shardmap_train_step(
            cfg, tcfg, pcfg, mesh=mesh, rest_pose=rest_pose, kp_map=kp_map,
            n_frames=attrs["n_kps"])
        prep = lambda b: pmesh.shard_batch(b, mesh)  # noqa: E731
    else:
        step_fn = make_train_step(
            cfg, tcfg, pcfg, rest_pose=rest_pose, kp_map=kp_map, n_frames=attrs["n_kps"],
        )
        # pinned batches go up without a stream synchronisation
        prep = lambda b: {k: torch.as_tensor(v).to(dev, non_blocking=True)  # noqa: E731
                          for k, v in b.items()}

    writer = None
    if writer_rank:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir)
        except Exception:
            pass

    it = iter(loader)
    try:
        t0 = time.time()
        for i in range(start, args.n_iters):
            batch = prep(next(it))
            state, stats = step_fn(state, batch, step_generator(args.seed, i, dev))

            if writer_rank and args.i_print > 0 and (i + 1) % args.i_print == 0:
                s = {k: float(v) for k, v in stats.items()}
                rate = args.i_print / (time.time() - t0)
                t0 = time.time()
                print(
                    f"iter {i + 1}: loss {s['total_loss']:.5f} psnr {s['psnr']:.2f} "
                    f"({rate:.1f} it/s, {rate * args.N_rand:.0f} rays/s)"
                )
                if writer:
                    for k, v in s.items():
                        writer.add_scalar(f"Train/{k}", v, i + 1)
                # schedule trajectories (tau anneal, BARF alpha, LR decay)
                # (cutoff_embedder.py:181-190, trainer.py:175-192)
                sched = {
                    "lrate": tcfg.lrate * tcfg.lrate_decay_rate
                    ** ((i + 1) / (tcfg.lrate_decay * tcfg.decay_unit))
                }
                ek = state.embeds.get("embed_kp") or {}
                for name in ("tau", "alpha"):
                    if name in ek:
                        sched[name] = float(ek[name].reshape(-1)[0])
                if writer:
                    for k, v in sched.items():
                        writer.add_scalar(f"Sched/{k}", v, i + 1)
                with open(os.path.join(log_dir, "sched.txt"), "a") as f:
                    f.write(
                        f"{i + 1}\t"
                        + "\t".join(f"{k}={v:.6g}" for k, v in sorted(sched.items()))
                        + "\n"
                    )

            if writer_rank and args.i_weights > 0 and (i + 1) % args.i_weights == 0:
                path = save_checkpoint(log_dir, state, step=i + 1)
                print(f"saved {path}")

            if (writer_rank and args.opt_pose and args.i_pose_weights > 0
                    and (i + 1) % args.i_pose_weights == 0):
                save_pose_checkpoint(log_dir, state, step=i + 1)

            if args.i_video > 0 and (i + 1) % args.i_video == 0:
                try:
                    save_spiral_video(cfg, state, render_data, log_dir, i + 1,
                                      factor=max(args.render_factor, 2))
                except Exception as e:  # video output must never kill training
                    print(f"i_video render failed: {e}")

            if args.i_testset > 0 and (i + 1) % args.i_testset == 0:
                metrics, _ = evaluate_testset(
                    cfg, state, render_data, args.chunk, render_factor=args.render_factor,
                    mesh=mesh,
                )
                if not writer_rank:
                    continue
                print(f"iter {i + 1} val: {metrics}")
                if writer:
                    writer.add_scalar("Val/PSNR", metrics["psnr"], i + 1)
                    writer.add_scalar("Val/SSIM", metrics["ssim"], i + 1)
                with open(os.path.join(log_dir, "psnr.txt"), "a") as f:
                    f.write(f"{i + 1}\t{metrics['psnr']:.4f}\n")
                with open(os.path.join(log_dir, "ssim.txt"), "a") as f:
                    f.write(f"{i + 1}\t{metrics['ssim']:.4f}\n")
    finally:
        loader.close()
        if writer:
            writer.close()
    if mesh is not None:
        pmesh.check_replicated(state, mesh)
    if writer_rank:
        save_checkpoint(log_dir, state, step=args.n_iters)
    return log_dir


if __name__ == "__main__":
    train()
