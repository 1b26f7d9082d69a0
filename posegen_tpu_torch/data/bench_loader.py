"""Input-pipeline throughput at workload scale (port of
posegen_tpu/data/bench_loader.py).

Measures RayBatchLoader batches/s and rays/s at the flagship training shape
(512 x 512 images, N_rand 3072 over 64 sample images: reference
configs/h36m/h36m_prot2.txt:35-41) with the native C++ sampler and with the
numpy one, so that the loader's rate can be held against the train step's.

CLI: python -m posegen_tpu_torch.data.bench_loader [--res 512] [--n_images 64] ...
Prints one JSON line per variant.

It times the host loader that feeds the card and launches nothing there,
as the JAX package's benchmark does. The numpy variant is the loader with
`native.get_lib` substituted by one that returns None (as the tests reach
it). Worker processes see that substitution only when they are forked: a
process that has initialised CUDA starts them by spawn, so there the numpy
variant with workers raises rather than time the native sampler under the
numpy name. The CLI initialises no CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np


def bench_loader(
    h5_path: str,
    n_rand: int = 3072,
    n_sample_images: int = 64,
    n_batches: int = 30,
    use_native: bool = True,
    prefetch: int = 4,
    num_workers: int = 0,
) -> dict:
    from posegen_tpu_torch.data import native
    from posegen_tpu_torch.data.h5dataset import H5RayDataset, RayBatchLoader

    torch_mod = sys.modules.get("torch")
    if (not use_native and num_workers > 0 and torch_mod is not None
            and torch_mod.cuda.is_initialized()):
        raise RuntimeError(
            "bench_loader: the numpy variant's worker processes would start by spawn "
            "(CUDA is initialised here) and load the native sampler; run it in a process "
            "that has not initialised CUDA (python -m posegen_tpu_torch.data.bench_loader)")
    real_lib = native.get_lib
    if not use_native:
        native.get_lib = lambda: None
    try:
        ds = H5RayDataset(
            h5_path, n_rays_per_image=max(n_rand // n_sample_images, 1), seed=0
        )
        # the variant that runs: the native sampler builds batches only on
        # a file the loader could map
        native_path = ds.sample_batch(np.arange(min(2, ds.n_images)), seed=0) is not None
        loader = RayBatchLoader(
            ds, n_images_per_batch=n_sample_images, prefetch=prefetch, seed=0,
            num_workers=num_workers,
        )
        try:
            it = iter(loader)
            # warmup (thread or worker start + first fills)
            for _ in range(3):
                next(it)
            t0 = time.perf_counter()
            n_rays = 0
            for _ in range(n_batches):
                b = next(it)
                n_rays += b["rays_o"].shape[0]
            dt = time.perf_counter() - t0
            workers = len(loader._procs)
        finally:
            loader.close()
            ds.close()
    finally:
        native.get_lib = real_lib
    return {
        "variant": "native" if native_path else "numpy",
        "num_workers": num_workers,
        "workers_started": workers,  # the loader caps them at the host's cores - 1
        "batches_per_s": n_batches / dt,
        "rays_per_s": n_rays / dt,
        "n_rand": n_rand,
        "n_sample_images": n_sample_images,
    }


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser("posegen_tpu_torch.data.bench_loader")
    p.add_argument("--h5", type=str, default=None, help="existing H5 (else synthetic)")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--N_rand", type=int, default=3072)
    p.add_argument("--N_sample_images", type=int, default=64)
    p.add_argument("--n_batches", type=int, default=30)
    p.add_argument("--num_workers", type=int, default=0)
    args = p.parse_args(argv)

    path = args.h5
    with tempfile.TemporaryDirectory() as tmp:
        if path is None:
            from posegen_tpu_torch.data.synthetic import make_synthetic_h5

            path = os.path.join(tmp, f"bench_{args.res}.h5")
            print(f"generating synthetic {args.res}x{args.res} H5 ({args.n_images} images)...")
            make_synthetic_h5(
                path, n_images=args.n_images, H=args.res, W=args.res,
                focal=args.res * 1.2,
            )

        for use_native in (True, False):
            r = bench_loader(
                path, n_rand=args.N_rand, n_sample_images=args.N_sample_images,
                n_batches=args.n_batches, use_native=use_native,
                num_workers=args.num_workers,
            )
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
