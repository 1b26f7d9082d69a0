"""The purpose experiments at their full size, each through its tool, in one
command (the figures of PERF.md's full-size runs come from here).

    python -m posegen_tpu_torch.tools.run_proofs render --out /tmp/proofs
    python -m posegen_tpu_torch.tools.run_proofs poseopt --out /tmp/proofs \\
        [--soak_iters 30000]

render: the flagship demo NeRF (1500 steps, the JAX run's), exp_bf16_delta
at 512^2 on it (the kernels' and the plain f32 frames on the card, then
--cpu: the plain f32 frame on the host, into the same directory), then
exp_mining at the JAX package's round-4 strong dial (spin_coef 0.5,
feedback every 2 iterations, 8 GAN epochs of 16 iterations: the
128-iteration budget; its other knobs from logs/mining/
summary_v4_strong_dial_boundary.json). poseopt: exp_poseopt prepare (264
images of 256^2), soak (--soak_iters h36m_prot2 steps), evalpose, and
testopt at 1500 iterations and tols 0.01 0.05 0.0. Each run's JSONs, the
card's name and power limit, and the seconds of each step go under --out;
the scenes, checkpoints and renders under a scratch directory that is
removed at the end. Loaders run in the main process (--num_workers 0).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional, Sequence

MINING_STRONG_DIAL = (
    "--n_pretrain", "256", "--n_eval", "48", "--pretrain_epochs", "150",
    "--finetune_epochs", "30", "--gan_epochs", "8", "--batch_size", "128", "--pool_n", "2048",
    "--rpi", "8", "--probe_every", "16", "--probe_n", "8", "--feedback_every", "2",
    "--spin_coef", "0.5", "--ft_n", "224", "--pose_std", "0.15", "--feedback_start_epoch", "1",
    "--pretrain_gen_n", "192",
)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _timed(record: Dict, tag: str, fn, *args, **kwargs):
    t0 = time.time()
    out = fn(*args, **kwargs)
    record[tag] = time.time() - t0
    print(f"[run_proofs] {tag}: {record[tag]:.1f} s", flush=True)
    return out


def run_render(out: str, work: str, device) -> Dict:
    from posegen_tpu_torch.tools import exp_bf16_delta, exp_mining
    from posegen_tpu_torch.tools.flagship_demo import train_flagship

    seconds: Dict[str, float] = {}
    nerf_args, ckpt = _timed(seconds, "flagship_demo", train_flagship,
                             os.path.join(work, "logs"), os.path.join(work, "data"),
                             num_workers=0, device=device)
    nerf = ["--nerf_args", nerf_args, "--ckptpath", ckpt]
    bf16 = nerf + ["--hw", "512", "--out", os.path.join(out, "bf16ab")]
    _timed(seconds, "exp_bf16_delta", exp_bf16_delta.main, bf16, device=device)
    _timed(seconds, "exp_bf16_delta_cpu", exp_bf16_delta.main, bf16 + ["--cpu"])
    mining_out = os.path.join(work, "mining")
    _timed(seconds, "exp_mining", exp_mining.main,
           nerf + ["--out", mining_out, *MINING_STRONG_DIAL], device=device)
    shutil.copy(os.path.join(mining_out, "summary.json"),
                os.path.join(out, "mining_summary.json"))
    val = os.path.join(os.path.dirname(nerf_args), "psnr.txt")  # run_nerf's val PSNR a line
    if os.path.exists(val):
        shutil.copy(val, os.path.join(out, "flagship_psnr.txt"))
    return seconds


def run_poseopt(out: str, work: str, device, soak_iters: int) -> Dict:
    from posegen_tpu_torch.tools import exp_poseopt

    seconds: Dict[str, float] = {}
    common = ["--data_dir", os.path.join(work, "data_poseopt"), "--out_dir", out,
              "--basedir", os.path.join(work, "logs")]
    flags = ["--nerf_flags", "--num_workers 0"]
    _timed(seconds, "prepare", exp_poseopt.main, ["prepare"] + common)
    _timed(seconds, "soak", exp_poseopt.main,
           ["soak", "--n_iters", str(soak_iters)] + flags + common, device=device)
    _timed(seconds, "evalpose", exp_poseopt.main, ["evalpose"] + common)
    _timed(seconds, "testopt", exp_poseopt.main,
           ["testopt", "--n_iters", "1500", "--tols", "0.01", "0.05", "0.0"] + flags + common,
           device=device)
    return seconds


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    p = argparse.ArgumentParser("run_proofs", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("what", choices=("render", "poseopt"))
    p.add_argument("--out", required=True)
    p.add_argument("--soak_iters", type=int, default=30000)
    args = p.parse_args(argv)

    from posegen_tpu_torch.device import resolve_device
    from posegen_tpu_torch.tools.proof import set_tf32

    dev = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="run_proofs_")
    record = {"card": card_line(), "what": args.what, "tf32": set_tf32(False)}
    print(f"[run_proofs] {record['card']}", flush=True)
    try:
        if args.what == "render":
            record["seconds"] = run_render(args.out, work, dev)
        else:
            record["soak_iters"] = args.soak_iters
            record["seconds"] = run_poseopt(args.out, work, dev, args.soak_iters)
    finally:
        with open(os.path.join(args.out, f"run_{args.what}.json"), "w") as f:
            json.dump(record, f, indent=1)
        shutil.rmtree(work, ignore_errors=True)
    return record


if __name__ == "__main__":
    main()
