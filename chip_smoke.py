#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (posegen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one NVIDIA card, nvcc
and PyTorch built for CUDA. Phases, each of which fails the run:

  1. build    compile the kernels from posegen_tpu_torch/kernels/csrc with
              nvcc (the build's seconds and ptxas' register counts printed);
  2. kernels  at the flagship render's shapes (8192 rays, 64 + 16 samples)
              and at one ragged size (a last tile of 16 points),
              fused_dual against dual_plain and fused_field (full and
              density_only) against field_plain, bf16 operands on both
              sides, elementwise |kernel - plain| <= 1e-3 + 2e-2 |plain|;
  3. render   render_rays on make_problem(RaycastConfig(), 8192 rays) with
              coarse_rgb False (dual + field) and True (field x 2): the
              launch counters prove the kernels ran, rgb_map is finite and
              within 5e-3 of the plain PyTorch pipeline on every ray but
              those (at most 1%) whose opacity flips on a knife edge: the
              fine net's sigma at the ray's far sample must change sign
              between the kernel and the float32 net for each of them;
  4. timing   CUDA-event times of both render variants (30 iterations after
              warm-up) and of each kernel and plain version, beside the
              kernel's bound and the card's name and power limit.

The last two lines of standard output are one JSON object of per-kernel
numbers and one JSON object naming the device. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
RTOL, ATOL = 2e-2, 1e-3  # kernel vs plain, both with bf16 operands
RENDER_TOL = 5e-3  # fused render vs the plain pipeline (rgb_map)
MAX_FLIP_FRAC = 0.01  # rays allowed to flip opacity at a knife edge (see phase 3)
N_RAYS = 8192
N_RAGGED = 1001  # rays of the ragged case: 1001 x 16 points = 250 tiles of 64 + 16
N_ITERS = 30
# weight seed: with seed 1 the random nets give the 8192-ray render partial
# opacity (mean fine acc ~0.3, coarse ~1), so the render comparison is not
# vacuous (some seeds give zero density everywhere)
SEED = 1


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def field_flops(L, density_only: bool) -> int:
    """Multiply-add work of one field evaluation per point (x2 FLOP), as the
    JAX kernels' cost estimates count it (posegen_tpu/kernels/field.py:679)."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    macs = sum(L.layer_in(i) * WIDTH for i in range(L.depth)) + WIDTH  # trunk + alpha
    if not density_only:
        macs += WIDTH * WIDTH + (WIDTH + L.vc) * VIEW_WIDTH + VIEW_WIDTH * 3
    return 2 * macs


def bound(flops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref) -> float:
    import torch

    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    bad = err > ATOL + RTOL * ref.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements beyond {ATOL} + {RTOL}|plain| "
          f"(max|diff| {float(err.max()):.3e})")
    return float(err.max())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "posegen_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(posegen_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run(torch) -> int:
    from posegen_tpu_torch.kernels import build
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import RaycastConfig, encode_inputs, render_rays
    from posegen_tpu_torch.utils.fixtures import make_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernels against their plain versions, at the render's shapes -------
    cfg = RaycastConfig()
    cfg, params, ctx, rays_o, rays_d = make_problem(cfg, n_rays=N_RAYS, seed=SEED,
                                                    device="cuda")
    with torch.no_grad():
        near, far = samp.get_near_far_in_cylinder(
            rays_o, rays_d, ctx.cyls.expand(N_RAYS, 5), near=cfg.near, far=cfg.far)
        L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
        pose = F.pack_pose(ctx.skts[0], params["embed_kp"], cfg.multires, cfg.multires_views)
        net_c = F.prepare_net(params["coarse"], L)
        net_f = F.prepare_net(params["fine"], L)
        shapes = {}
        for tag, n_s in (("coarse", cfg.N_samples), ("importance", cfg.N_importance),
                         ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            shapes[tag] = (pts, rays_d, n_s)
        n_s = cfg.N_importance
        shapes["ragged"] = (shapes["importance"][0][:N_RAGGED * n_s],
                            rays_d[:N_RAGGED].contiguous(), n_s)
        bf16 = torch.bfloat16

        err_dual = 0.0
        for tag in ("coarse", "ragged"):
            pts, dirs, n_s = shapes[tag]
            kc, kf = F.fused_dual(pts, dirs, n_s, pose, net_c, net_f)
            pc, pf = F.dual_plain(pts, dirs, n_s, pose, net_c, net_f, mm_dtype=bf16)
            torch.cuda.synchronize()
            e_c, e_f = compare(f"dual coarse {tag}", kc, pc), compare(f"dual fine {tag}", kf, pf)
            check(float(kc[:, :3].abs().max()) == 0.0, "dual: coarse rgb rows not zero")
            err_dual = max(err_dual, e_c, e_f)
            print(f"kernel dual vs dual_plain, {pts.shape[0]} points: max|diff| "
                  f"coarse {e_c:.3e}, fine {e_f:.3e}")

        err_field = 0.0
        for tag in ("importance", "coarse", "fine", "ragged"):
            pts, dirs, n_s = shapes[tag]
            kfull = F.fused_field(pts, dirs, n_s, pose, net_f)
            kden = F.fused_field(pts, dirs, n_s, pose, net_f, density_only=True)
            pfull = F.field_plain(pts, dirs, n_s, pose, net_f, mm_dtype=bf16)
            pden = F.field_plain(pts, dirs, n_s, pose, net_f, density_only=True, mm_dtype=bf16)
            torch.cuda.synchronize()
            e_full = compare(f"field {tag}", kfull, pfull)
            e_den = compare(f"field density_only {tag}", kden, pden)
            check(bool(torch.equal(kden[:, 3], kfull[:, 3])),
                  f"field {tag}: density_only sigma differs from the full kernel's")
            check(float(kden[:, :3].abs().max()) == 0.0, "density_only: rgb rows not zero")
            err_field = max(err_field, e_full, e_den)
            print(f"kernel field vs field_plain, {pts.shape[0]} points: max|diff| "
                  f"full {e_full:.3e}, density_only {e_den:.3e}")

    # 3. the main path, through the launch counters -------------------------
    expected = {False: {"dual": 1, "field": 1}, True: {"dual": 0, "field": 2}}
    launches = {"dual": 0, "field": 0}
    with torch.no_grad():
        # The last sample's interval is 1e10 long, so a ray is opaque iff the
        # fine net's sigma at its far sample is > 0: a ray whose far sigma lies
        # within bf16 rounding of 0 flips between acc 0 and 1 under any bf16
        # kernel. Such a flip is excused only where that sigma changes sign
        # between the kernel and the float32 net; every other ray is held to
        # the JAX package's fused-vs-XLA bound.
        far_pts = (rays_o + rays_d * far).contiguous()
        x_pts, x_views, _ = encode_inputs(cfg, params, far_pts[:, None], rays_d, ctx)
        sig_ref = nerf_apply(cfg.nerf_cfg, params["fine"], x_pts, x_views)[:, 0, 3]
        sig_ker = F.fused_field(far_pts, rays_d, 1, pose, net_f, density_only=True)[:, 3]
        straddles = (sig_ref > 0) != (sig_ker > 0)
        for coarse_rgb in (False, True):
            F.reset_launches()
            out = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                              raw_noise_std=0.0, coarse_rgb=coarse_rgb)
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
            check(got == expected[coarse_rgb],
                  f"render coarse_rgb={coarse_rgb}: launches {got} != {expected[coarse_rgb]}")
            for k in launches:
                launches[k] += got[k]
            rgb = out["rgb_map"]
            check(tuple(rgb.shape) == (N_RAYS, 3), f"rgb_map shape {tuple(rgb.shape)}")
            check(bool(torch.isfinite(rgb).all()), "rgb_map not finite")
            ref = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                              raw_noise_std=0.0, coarse_rgb=coarse_rgb, use_fused=False)
            acc = float(out["acc_map"].mean())
            check(0.0 < acc and float(rgb.abs().max()) > 0.0,
                  f"render coarse_rgb={coarse_rgb}: empty image (mean acc {acc})")
            d_rgb = (rgb - ref["rgb_map"]).abs().amax(-1)
            flipped = (out["acc_map"] - ref["acc_map"]).abs() > 0.5
            n_flip = int(flipped.sum())
            err = float(d_rgb[~flipped].max())
            check(n_flip <= MAX_FLIP_FRAC * N_RAYS,
                  f"render coarse_rgb={coarse_rgb}: {n_flip} rays flipped opacity")
            check(bool(straddles[flipped].all()),
                  f"render coarse_rgb={coarse_rgb}: {int((~straddles[flipped]).sum())} "
                  "rays flipped opacity with no sign change of their far sigma")
            check(err <= RENDER_TOL,
                  f"render coarse_rgb={coarse_rgb}: rgb_map vs plain {err:.3e} > {RENDER_TOL}")
            sig_flip = float(sig_ref[flipped].abs().max()) if n_flip else 0.0
            print(f"render coarse_rgb={coarse_rgb}: launches {got}, rgb_map max|diff| vs "
                  f"plain pipeline {err:.3e} on {N_RAYS - n_flip} rays, {n_flip} rays "
                  f"flipped opacity (max|diff| over all {float(d_rgb.max()):.3e}, mean "
                  f"{float(d_rgb.mean()):.3e}); mean acc {acc:.4f}")
            print(f"  flips: far sigma changes sign on every flipped ray; its float32 "
                  f"|sigma| <= {sig_flip:.3e} there, against a median |sigma| of "
                  f"{float(sig_ref.abs().median()):.3e} over all far samples "
                  f"({int(straddles.sum())} far samples change sign)")

    # 4. timing -------------------------------------------------------------
    with torch.no_grad():
        for coarse_rgb in (False, True):
            ms = cuda_ms(lambda: render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                                             raw_noise_std=0.0, coarse_rgb=coarse_rgb),
                         N_ITERS)
            print(f"timing render coarse_rgb={coarse_rgb}: {ms:.3f} ms per {N_RAYS} rays, "
                  f"{N_RAYS / ms * 1e3:.1f} rays/s [{card}]")

        w_bytes = lambda net: net.w.numel() * 2 + net.b.numel() * 4
        rows = []
        pts_c, _, s_c = shapes["coarse"]
        P = pts_c.shape[0]
        flops = (field_flops(L, True) + field_flops(L, False)) * P
        nbytes = 12 * P + 12 * N_RAYS + pose.numel() * 4 + w_bytes(net_c) + w_bytes(net_f) + 32 * P
        k_ms = cuda_ms(lambda: F.fused_dual(pts_c, rays_d, s_c, pose, net_c, net_f), 10)
        p_ms = cuda_ms(lambda: F.dual_plain(pts_c, rays_d, s_c, pose, net_c, net_f,
                                            mm_dtype=bf16), 3, warmup=1)
        rows.append(("dual", "coarse", P, k_ms, p_ms, *bound(flops, nbytes)))
        for tag in ("importance", "coarse", "fine"):
            pts, _, n_s = shapes[tag]
            P = pts.shape[0]
            for density_only in (False, True):
                flops = field_flops(L, density_only) * P
                nbytes = 12 * P + 12 * N_RAYS + pose.numel() * 4 + w_bytes(net_f) + 16 * P
                k_ms = cuda_ms(lambda: F.fused_field(pts, rays_d, n_s, pose, net_f,
                                                     density_only), 10)
                p_ms = cuda_ms(lambda: F.field_plain(pts, rays_d, n_s, pose, net_f,
                                                     density_only, mm_dtype=bf16), 3, warmup=1)
                name = "field_density_only" if density_only else "field"
                rows.append((name, tag, P, k_ms, p_ms, *bound(flops, nbytes)))
        for name, tag, P, k_ms, p_ms, b_ms, b_by in rows:
            print(f"timing kernel {name} {tag} ({P} points): {k_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms [{card}]")

    by_name = {(r[0], r[1]): r for r in rows}
    kernels = []
    for name, key, src, replaces, err in (
        ("dual", ("dual", "coarse"), "posegen_tpu_torch/kernels/csrc/field.cu",
         "posegen_tpu/kernels/field.py:735", err_dual),
        ("field", ("field", "importance"), "posegen_tpu_torch/kernels/csrc/field.cu",
         "posegen_tpu/kernels/field.py:473", err_field),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = by_name[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
