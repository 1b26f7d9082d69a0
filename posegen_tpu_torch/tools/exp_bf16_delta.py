"""The bf16 kernels' quality delta on a trained frame (port of
tools/exp_bf16_delta.py).

Renders ONE frame of a trained model and reports pairwise PSNR:

  * fused  -- the eval kernels (posegen_dual, posegen_field: bf16 operands,
              f32 accumulation and compositing) on the card;
  * xla32  -- the plain float32 PyTorch pipeline on the same card (the JAX
              tool's XLA f32 pipeline; the tag is kept so that the files
              compare);
  * cpu32  -- the plain float32 pipeline on the host (--cpu; a later card
              run loads its saved frame for the cross-device numbers).

    python -m posegen_tpu_torch.tools.exp_bf16_delta --nerf_args logs/x/args.txt \\
        --ckptpath logs/x/00001500.ckpt.npz --hw 512 --out /tmp/bf16ab
    python -m posegen_tpu_torch.tools.exp_bf16_delta ... --cpu --out /tmp/bf16ab

Each frame goes to {out}/{tag}.npy, its opacity to {tag}_acc.npy; every
pair's PSNR, max|diff|, the pixels that differ by more than 0.1, the
opacity flips (opacity apart by more than 0.5) with the PSNR off them, and
the pixels whose opacity is apart by more than 0.01 with the PSNR off those,
are printed and written with the render times and the TF32 setting to
{out}/psnr.json. The kernel route refuses a config the kernels' gate
refuses (no silent fall back to the plain pipeline).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.tools.proof import set_tf32, tool_device


def np_psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _one(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def load_frame(targs, image_idx: int, device):
    """The trained run's H5 frame `image_idx` -> (PoseCtx on `device`, c2w,
    focal, the stored frames' height)."""
    from posegen_tpu_torch.data.catalog import DataConfig, resolve_h5_path
    from posegen_tpu_torch.data.hdf5 import H5File
    from posegen_tpu_torch.render.raycast import PoseCtx

    h5path = resolve_h5_path(DataConfig(dataset=_one(targs.dataset_type),
                                        subject=_one(targs.subject),
                                        data_root=_one(targs.data_root)))
    with H5File(h5path) as f:
        ki = int(f.read("kp_idxs")[image_idx])
        row = lambda name: torch.as_tensor(  # noqa: E731
            np.asarray(f.read(name)[ki:ki + 1], np.float32), device=device)
        ctx = PoseCtx(kps=row("kp3d"), skts=row("skts"), bones=row("bones"), cyls=row("cyls"))
        c2w = np.asarray(f.read("c2ws")[image_idx], np.float32)
        focal = float(f.read("focals")[image_idx])
        src_h = int(f.datasets["imgs"].shape[1])
    return ctx, c2w, focal, src_h


def render_frame(cfg, variables, hw: int, focal: float, c2w, ctx, use_fused: bool,
                 chunk: int):
    """One hw x hw frame on white, through the eval kernels (use_fused) or the
    plain float32 pipeline -> (rgb (hw, hw, 3), acc (hw, hw)) float32."""
    from posegen_tpu_torch.kernels.field import fused_config_disqualification
    from posegen_tpu_torch.render.image import _raygen_render_fn, render_image

    if use_fused:
        reason = fused_config_disqualification(cfg)
        if reason is not None:
            raise ValueError(f"exp_bf16_delta: the eval kernels refuse this config: {reason}")
        if ctx.kps.device.type != "cuda":
            raise ValueError("exp_bf16_delta: the kernel route runs on the card")
    with torch.no_grad():
        out = render_image(cfg, variables, hw, hw, focal, c2w, ctx, chunk=chunk,
                           white_bkgd=True, render_fn=_raygen_render_fn(cfg, use_fused))
    return out["rgb"], out["acc"]


def frame_diff(a: np.ndarray, b: np.ndarray, acc_a=None, acc_b=None) -> Dict:
    """Where two frames differ: PSNR, max|diff|, the pixels whose largest
    channel differs by more than 0.1, and (given both opacity maps) the
    pixels whose opacity differs by more than 0.5 (a flip) with the PSNR over
    the rest, and those whose opacity differs by more than 0.01 with the
    PSNR over the rest (the pixels where both routes agree on coverage)."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max(-1)
    out = {"psnr": np_psnr(a, b), "max_abs": float(d.max()),
           "pixels_over_0.1": int((d > 0.1).sum())}
    if acc_a is not None and acc_b is not None:
        d_acc = np.abs(acc_a - acc_b)
        kept = d_acc <= 0.5
        out["opacity_flips"] = int((~kept).sum())
        out["psnr_unflipped"] = np_psnr(a[kept], b[kept])
        kept = d_acc <= 0.01
        out["opacity_over_0.01"] = int((~kept).sum())
        out["psnr_opacity_within_0.01"] = np_psnr(a[kept], b[kept])
    return out


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Dict:
    p = argparse.ArgumentParser("exp_bf16_delta", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nerf_args", required=True)
    p.add_argument("--ckptpath", required=True)
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--image_idx", type=int, default=0)
    p.add_argument("--out", default="/tmp/bf16ab")
    p.add_argument("--cpu", action="store_true",
                   help="render only the f32 CPU anchor frame")
    args = p.parse_args(argv)

    from posegen_tpu_torch.cli.run_render import load_trained

    dev = tool_device(device, args.cpu)
    tf32 = set_tf32(False)
    targs, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=dev)
    ctx, c2w, focal, src_h = load_frame(targs, args.image_idx, dev)
    H = args.hw
    focal = focal * H / src_h  # scale intrinsics with the render resolution
    os.makedirs(args.out, exist_ok=True)
    seconds = {}

    def run(tag, fused, chunk):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        rgb, acc = render_frame(cfg, variables, H, focal, c2w, ctx, fused, chunk)
        seconds[tag] = time.time() - t0
        np.save(os.path.join(args.out, f"{tag}.npy"), rgb)
        np.save(os.path.join(args.out, f"{tag}_acc.npy"), acc)
        print(f"{tag}: rendered {H}x{H} in {seconds[tag]:.2f} s (device={dev})")
        return rgb, acc

    frames = {}
    if dev.type == "cpu":
        frames["cpu32"] = run("cpu32", fused=False, chunk=8192)
    else:
        frames["fused"] = run("fused", fused=True, chunk=32768)
        frames["xla32"] = run("xla32", fused=False, chunk=8192)

    # load any frames a previous invocation (the other device) saved
    for tag in ("fused", "xla32", "cpu32"):
        path = os.path.join(args.out, f"{tag}.npy")
        if tag not in frames and os.path.exists(path):
            acc = os.path.join(args.out, f"{tag}_acc.npy")
            frames[tag] = (np.load(path), np.load(acc) if os.path.exists(acc) else None)

    tags = sorted(frames)
    psnr, diff = {}, {}
    for a in range(len(tags)):
        for b in range(a + 1, len(tags)):
            pair = f"{tags[a]}|{tags[b]}"
            (fa, aa), (fb, ab) = frames[tags[a]], frames[tags[b]]
            diff[pair] = frame_diff(fa, fb, aa, ab)
            psnr[pair] = diff[pair]["psnr"]
            print(f"PSNR({tags[a]}, {tags[b]}) = {psnr[pair]:.2f} dB; {diff[pair]}")
    summary = {"hw": H, "image_idx": args.image_idx, "device": str(dev), "psnr": psnr,
               "diff": diff, "render_s": seconds, "tf32": tf32}
    with open(os.path.join(args.out, "psnr.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
