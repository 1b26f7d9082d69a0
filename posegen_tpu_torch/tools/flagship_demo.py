"""Train the flagship demo NeRF that the purpose experiments render through:
configs/synthetic/demo.txt with the overrides of the JAX run recorded in
logs/flagship_demo/args.txt (two 8 x 256 nets, 64 + 16 samples, multires
7 / 4, 2048 rays a step, 1500 steps) on the synthetic 8-image scene.

    python -m posegen_tpu_torch.tools.flagship_demo [--basedir logs]
        [--data_root data] [--n_iters 1500] [--num_workers 16] [--cpu]

Writes {basedir}/flagship_demo/args.txt and its {n_iters:08d}.ckpt.npz,
which exp_bf16_delta, exp_mining and run_gan take as --nerf_args /
--ckptpath. The scene is made under {data_root}/synthetic/ when absent.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

from posegen_tpu_torch.tools.proof import checkout_path, config_path, required, tool_device

DEMO_CONFIG = os.path.join("configs", "synthetic", "demo.txt")
# logs/flagship_demo/args.txt against configs/synthetic/demo.txt: every key
# that differs (n_devices aside: one device here)
FLAGSHIP_FLAGS: Tuple[str, ...] = (
    "--expname", "flagship_demo",
    "--netdepth", "8", "--netwidth", "256", "--netdepth_fine", "8", "--netwidth_fine", "256",
    "--multires", "7", "--multires_views", "4",
    "--N_samples", "64", "--N_importance", "16", "--N_rand", "2048",
    "--i_print", "100", "--i_testset", "500", "--i_weights", "1500",
)


def flagship_argv(basedir: str, data_root: str, n_iters: int = 1500,
                  num_workers: Optional[int] = None) -> List[str]:
    """run_nerf's argv of the flagship demo run."""
    argv = ["--config", config_path(DEMO_CONFIG), *FLAGSHIP_FLAGS, "--basedir", basedir,
            "--data_root", data_root, "--n_iters", str(n_iters)]
    if num_workers is not None:
        argv += ["--num_workers", str(num_workers)]
    return argv


def train_flagship(basedir: str, data_root: str, n_iters: int = 1500,
                   num_workers: Optional[int] = None, device="cuda") -> Tuple[str, str]:
    """Train (or resume) the run -> (its args.txt, its last checkpoint)."""
    from posegen_tpu_torch.cli.run_nerf import train
    from posegen_tpu_torch.train.checkpoints import latest_checkpoint

    log_dir = train(flagship_argv(basedir, data_root, n_iters, num_workers), device=device)
    return os.path.join(log_dir, "args.txt"), latest_checkpoint(log_dir)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Tuple[str, str]:
    p = argparse.ArgumentParser("flagship_demo", description=__doc__)
    p.add_argument("--basedir", default=checkout_path("logs"))
    p.add_argument("--data_root", default=checkout_path("data"))
    p.add_argument("--n_iters", type=int, default=1500)
    p.add_argument("--num_workers", type=int, default=None,
                   help="loader workers (the config's 16 when absent)")
    p.add_argument("--cpu", action="store_true", help="train on the host")
    args = p.parse_args(argv)
    dev = tool_device(device, args.cpu)
    nerf_args, ckpt = train_flagship(required(args.basedir, "--basedir"),
                                     required(args.data_root, "--data_root"), args.n_iters,
                                     args.num_workers, device=dev)
    print(f"flagship demo: {nerf_args}, {ckpt}")
    return nerf_args, ckpt


if __name__ == "__main__":
    main()
