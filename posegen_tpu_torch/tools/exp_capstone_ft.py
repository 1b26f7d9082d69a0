"""Capstone phase 2: fine-tune SPIN on a run_gan sink and report the easy /
hard_gen / hard_nat split table (port of tools/exp_capstone_ft.py;
reference run_gan.py:1849-1952 train_spin + :1551-1581 eval).

Inputs: the sink of a run_gan run (image/%05d.png + poses_axis_angles{count}
.npy blocks of rpi bones, and gan_ckpts/gan_*.npz, whose latest gives the
FINAL generator for the hard_gen split), the trained NeRF, and the
pretrained SPIN that exp_mining writes. The eval splits follow exp_mining's
conventions (the same draw seeds, the same worst-quartile rule); a split
whose saved poses under --splits_dir match this run's draw is reused, and
rendered under {sink}_eval/ otherwise.

    python -m posegen_tpu_torch.tools.exp_capstone_ft --sink render_output/capstone \\
        --nerf_args logs/flagship_demo/args.txt \\
        --ckptpath logs/flagship_demo/00001500.ckpt.npz \\
        --pretrained /tmp/mining/spin_pretrained.npz

Writes --out (the JAX tool's keys, and the TF32 setting). The renders run
the eval kernels on the card; --cpu runs it all on the host.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.tools.exp_mining import (
    BATCH, _joints, _prepared, draw, eval_all, mpjpe_per_sample, mpjpe_prepared, render_set,
    train_spin_inmem, worst_quartile,
)
from posegen_tpu_torch.tools.proof import checkout_path, required, set_tf32, tool_device


def ensure_split(renderer, name: str, bones: np.ndarray, splits_dir: str, sink: str) -> str:
    """A split dir whose saved poses match `bones` under splits_dir, else a
    fresh render under {sink}_eval/ (never over the other run's files)."""
    d = os.path.join(splits_dir, name)
    npy = os.path.join(d, "poses_axis_angles0.npy")
    if os.path.exists(npy):
        saved = np.load(npy)
        if len(saved) == len(bones) and np.allclose(saved, bones, atol=1e-6):
            return d
    d = os.path.join(sink + "_eval", name)
    if not os.path.exists(os.path.join(d, "poses_axis_angles0.npy")):
        print(f"rendering split {name} ({len(bones)})", flush=True)
        render_set(renderer, bones, d)
    return d


def finetune(spin_params, spin_state, x, gt, epochs: int, seed: int, tag: str):
    """The reference's lr_spin 5e-5, BN frozen, logged every 10 epochs."""
    return train_spin_inmem(spin_params, spin_state, x, gt, epochs=epochs, lr=5e-5,
                            seed=seed + 5, tag=f"ft-{tag}", log_every=10)


def sink_rows(sink: str):
    """-> (bones, image indices) of a sink's pose blocks, the images that
    are on disk only (the last event may be mid-write)."""
    blocks = {}
    for path in glob.glob(os.path.join(sink, "poses_axis_angles*.npy")):
        m = re.fullmatch(r"poses_axis_angles(\d+)\.npy", os.path.basename(path))
        if m:
            blocks[int(m.group(1))] = np.load(path)
    if not blocks:
        raise SystemExit(f"no sink pose blocks under {sink}")
    bones, idx = [], []
    for start in sorted(blocks):
        bones.append(blocks[start])
        idx.extend(range(start, start + len(blocks[start])))
    bones, idx = np.concatenate(bones), np.asarray(idx)
    on_disk = np.asarray([os.path.exists(os.path.join(sink, "image", f"{i:05d}.png"))
                          for i in idx], bool)
    return bones[on_disk], idx[on_disk]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("exp_capstone_ft", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sink", default=checkout_path("render_output", "capstone"))
    p.add_argument("--nerf_args", default=checkout_path("logs", "flagship_demo", "args.txt"))
    p.add_argument("--ckptpath",
                   default=checkout_path("logs", "flagship_demo", "00001500.ckpt.npz"))
    p.add_argument("--pretrained", default=checkout_path("logs", "mining", "spin_pretrained.npz"))
    p.add_argument("--splits_dir", default="/tmp/mining_v4",
                   help="exp_mining's eval / control render dirs (re-rendered if absent)")
    p.add_argument("--ft_n", type=int, default=768)
    p.add_argument("--finetune_epochs", type=int, default=30)
    p.add_argument("--n_eval", type=int, default=48)
    p.add_argument("--n_pretrain", type=int, default=256,
                   help="exp_mining's pretrain count (fixes the eval draw offset)")
    p.add_argument("--pose_std", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=checkout_path("logs", "mining", "capstone_finetune.json"))
    p.add_argument("--cpu", action="store_true", help="run on the host")
    return p


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    args = parser().parse_args(argv)
    for flag in ("sink", "nerf_args", "ckptpath", "pretrained", "out"):
        required(getattr(args, flag), f"--{flag}")
    dev = tool_device(device, args.cpu)

    from posegen_tpu_torch.cli.run_gan import latest_gan_checkpoint
    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.gen.hmr import init_hmr
    from posegen_tpu_torch.gen.loop import GanLoopConfig, GanTrainer, NeRFRenderer
    from posegen_tpu_torch.tools.exp_mining import generate, load_spin

    summary = {"args": vars(args), "tf32": set_tf32(False)}
    d = lambda seed, n: draw(seed, n, args.pose_std)  # noqa: E731

    _, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=dev)
    renderer = NeRFRenderer(cfg, variables, hw=512, chunk=32768)
    spin_params, spin_state = init_hmr(torch.Generator().manual_seed(args.seed + 2), device=dev)
    spin_params, spin_state = load_spin(args.pretrained, spin_params, spin_state)

    # ---- mined sink: image idx <-> bone rows from the npy blocks ----------
    sink_bones, sink_idx = sink_rows(args.sink)
    summary["sink_size"] = int(len(sink_idx))
    print(f"mined sink: {len(sink_idx)} images", flush=True)
    rng = np.random.default_rng(args.seed + 42)
    sel = rng.choice(len(sink_idx), size=min(args.ft_n, len(sink_idx)), replace=False)
    mined_bones = sink_bones[sel]
    x_mined = _prepared(os.path.join(args.sink, "image"), sink_idx[sel], dev)
    gt_mined = _joints(mined_bones, dev)

    # ---- final generator -> hard_gen split (exp_mining's seeds) -----------
    trainer = GanTrainer(GanLoopConfig(), None, seed=args.seed, device=dev)
    gan_ckpt = latest_gan_checkpoint(os.path.join(args.sink, "gan_ckpts"))
    if not gan_ckpt:
        raise SystemExit(f"no gan checkpoint in {args.sink}/gan_ckpts")
    trainer.load_checkpoint(gan_ckpt)
    summary["gan_ckpt"] = gan_ckpt
    print(f"final generator from {gan_ckpt} (epoch {trainer.epoch})", flush=True)
    hard_bones = generate(trainer.g_params, trainer.g_state, trainer.gen_cfg,
                          d(args.seed + 999, args.n_eval), args.seed + 888, dev)
    hard_dir = os.path.join(args.sink + "_eval", "hard_gen")
    render_set(renderer, hard_bones, hard_dir)
    x_hard = _prepared(os.path.join(hard_dir, "image"), range(len(hard_bones)), dev)

    # ---- easy + naturally-hard splits (exp_mining's draws) ----------------
    pool_pre = d(args.seed + 100, args.n_pretrain + args.n_eval)
    eval_bones = pool_pre[args.n_pretrain:]
    eval_dir = ensure_split(renderer, "eval", eval_bones, args.splits_dir, args.sink)
    x_eval = _prepared(os.path.join(eval_dir, "image"), range(len(eval_bones)), dev)
    nat_pool = d(args.seed + 1234, 4 * args.n_eval)
    nat_dir = ensure_split(renderer, "eval_nat", nat_pool, args.splits_dir, args.sink)
    x_nat_all = _prepared(os.path.join(nat_dir, "image"), range(len(nat_pool)), dev)
    errs_nat = np.concatenate([
        mpjpe_per_sample(spin_params, spin_state, x_nat_all[s:s + BATCH], nat_pool[s:s + BATCH])
        for s in range(0, len(nat_pool), BATCH)])
    worst = worst_quartile(errs_nat, args.n_eval)
    splits = {"easy": (x_eval, eval_bones), "hard_gen": (x_hard, hard_bones),
              "hard_nat": (x_nat_all[worst], nat_pool[worst])}

    # ---- control: equal-size random-pose renders (exp_mining's seed+400) --
    ctrl_bones = d(args.seed + 400, len(mined_bones))
    ctrl_dir = ensure_split(renderer, "control", ctrl_bones, args.splits_dir, args.sink)
    x_ctrl = _prepared(os.path.join(ctrl_dir, "image"), range(len(ctrl_bones)), dev)
    gt_ctrl = _joints(ctrl_bones, dev)

    summary["mined_set_mpjpe_pretrained"] = mpjpe_prepared(spin_params, spin_state, x_mined,
                                                           mined_bones)
    summary["control_set_mpjpe_pretrained"] = mpjpe_prepared(spin_params, spin_state, x_ctrl,
                                                             ctrl_bones)
    print(f"set hardness (pretrained): mined {summary['mined_set_mpjpe_pretrained']:.4f} vs "
          f"random {summary['control_set_mpjpe_pretrained']:.4f}", flush=True)
    summary["pretrained_eval"] = eval_all(spin_params, spin_state, splits)
    print(f"pretrained eval: {summary['pretrained_eval']}", flush=True)

    # ---- fine-tune mined vs control ---------------------------------------
    results = {}
    for tag, (x_ft, gt_ft) in (("mined", (x_mined, gt_mined)), ("control", (x_ctrl, gt_ctrl))):
        t0 = time.time()
        ft_params = finetune(spin_params, spin_state, x_ft, gt_ft, args.finetune_epochs,
                             args.seed, tag)
        results[tag] = eval_all(ft_params, spin_state, splits)
        print(f"fine-tuned on {tag}: {results[tag]} ({time.time() - t0:.0f} s)", flush=True)
    summary["finetune_eval_mpjpe"] = results

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
