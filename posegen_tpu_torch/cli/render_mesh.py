"""Mesh turntable CLI (port of posegen_tpu/cli/render_mesh.py):

    python -m posegen_tpu_torch.cli.render_mesh --ply mesh.ply

Capability parity with reference render_mesh.py (:1-184): load a marched
mesh, orbit a camera around it, write numbered PNGs (+ an mp4 where imageio
and its ffmpeg are installed). The views are rasterized by
`render/rasterizer.turntable_render`, its pixel work on the card; the PNGs
go through the port's own codec (`utils/png.write_png`), the mp4 through
`utils/experiment.save_video`. Where the mp4 is not written the CLI says so
(JAX passes silently there). The device is a keyword argument,
`main(argv, device="cpu")`, and CUDA by default (raising without a card).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from posegen_tpu_torch.device import resolve_device


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an ASCII .ply written by render/mesh.py:save_ply."""
    verts, faces = [], []
    with open(path) as f:
        n_v = n_f = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        for _ in range(n_v):
            verts.append([float(v) for v in next(f).split()[:3]])
        for _ in range(n_f):
            parts = next(f).split()
            faces.append([int(v) for v in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Render the turntable of `--ply` on `device` -> the output dir."""
    p = argparse.ArgumentParser("posegen_tpu.render_mesh")
    p.add_argument("--ply", type=str, required=True)
    p.add_argument("--outputdir", type=str, default="mesh_render")
    p.add_argument("--n_views", type=int, default=12)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--fps", type=int, default=12)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    from posegen_tpu_torch.render.rasterizer import turntable_render
    from posegen_tpu_torch.utils.experiment import save_video
    from posegen_tpu_torch.utils.png import write_png

    verts, faces = load_ply(args.ply)
    frames = turntable_render(verts, faces, n_views=args.n_views, H=args.res, W=args.res,
                              device=dev)
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    os.makedirs(args.outputdir, exist_ok=True)
    for i, fr in enumerate(u8):
        write_png(os.path.join(args.outputdir, f"{i:05d}.png"), fr)
    if save_video(os.path.join(args.outputdir, "turntable.mp4"), u8, fps=args.fps) is None:
        print("turntable.mp4 not written: imageio with an ffmpeg writer is not installed; "
              "the PNGs are written")
    print(f"wrote {len(frames)} views to {args.outputdir}")
    return args.outputdir


if __name__ == "__main__":
    main()
