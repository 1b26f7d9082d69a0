"""Where `run_nerf.train`'s start goes: a cProfile of the CLI on a synthetic
SURREAL-shaped file, as a user runs `configs/surreal/surreal.txt` (its 16
loader workers, started by spawn once CUDA is up).

    python -m posegen_tpu_torch.tools.profile_cli_start [--n_images 128] [--hw 512]

On a machine with one NVIDIA GPU and nvcc (the training kernels build
first). Writes the file under a temporary directory, then profiles two
calls of `train` for a few steps each and prints, for each call, its
seconds, the seconds until its first step, the time in multiprocessing's
spawn launch (`popen_spawn_posix._launch`, which writes each worker its
pickled arguments) and the top entries by cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import shutil
import tempfile
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser("posegen_tpu_torch.tools.profile_cli_start")
    p.add_argument("--n_images", type=int, default=128)
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--n_iters", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from posegen_tpu_torch.cli import run_nerf as RN
    from posegen_tpu_torch.data import catalog as CAT
    from posegen_tpu_torch.data import native
    from posegen_tpu_torch.data.synthetic import make_synthetic_h5
    from posegen_tpu_torch.kernels import build
    from posegen_tpu_torch.train import trainer as TR

    if not torch.cuda.is_available():
        raise SystemExit("profile_cli_start: no CUDA device")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    native.get_lib()
    build.load()
    tmp = tempfile.mkdtemp(prefix="profile_cli_start_")
    try:
        path = CAT.resolve_h5_path(CAT.DataConfig(dataset="surreal", subject="female",
                                                  data_root=tmp))
        os.makedirs(os.path.dirname(path))
        make_synthetic_h5(path, n_images=args.n_images, H=args.hw, W=args.hw,
                          focal=args.hw * 1.25)
        first = {}
        real_make = TR.make_train_step

        def make(*a, **k):  # note when the first step starts
            step = real_make(*a, **k)

            def timed(state, batch, generator=None):
                first.setdefault("t", time.perf_counter())
                return step(state, batch, generator)

            return timed

        TR.make_train_step = make
        try:
            for call in range(2):
                argv_ = ["--config", "configs/surreal/surreal.txt",
                         "--datadir", os.path.join(tmp, "surreal"),
                         "--basedir", os.path.join(tmp, "logs"), "--expname", f"start{call}",
                         "--n_iters", str(args.n_iters), "--i_testset", "0", "--i_weights", "0",
                         "--i_print", "0", "--i_video", "0"]
                first.clear()
                prof = cProfile.Profile()
                t0 = time.perf_counter()
                prof.enable()
                RN.train(argv_, device="cuda")
                prof.disable()
                total = time.perf_counter() - t0
                st = pstats.Stats(prof)
                spawn = sum(v[3] for k, v in st.stats.items()
                            if k[0].endswith("popen_spawn_posix.py") and k[2] == "_launch")
                print(f"call {call}: {total:.2f} s, {first['t'] - t0:.2f} s to the first step, "
                      f"{spawn:.2f} s in popen_spawn_posix._launch", flush=True)
                st.sort_stats("cumulative").print_stats(args.top)
        finally:
            TR.make_train_step = real_make
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
