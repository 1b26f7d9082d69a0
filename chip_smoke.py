#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (posegen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one NVIDIA card, nvcc
and PyTorch built for CUDA. Phases, each of which fails the run:

  1. build    compile the kernels from posegen_tpu_torch/kernels/csrc with
              nvcc (the build's seconds and each kernel's registers and
              spills printed); no kernel spills, the SASS of the eval
              kernels (field.cu, all three modes) and of kernel 4's passes
              (a) and (b) holds wgmma (HGMMA) and TMA (UTMALDG; UTMASTG in
              pass (a)) by cuobjdump, and the library's plans equal their
              Python mirrors: the shared memory of the eval kernels, the
              stash kernel, pass (a) and the variant kernel, the eval
              kernels' scratch slot and persistent grid, pass (b)'s split;
  2. kernels  at the flagship render's shapes (8192 rays, 64 + 16 samples),
              at ragged sizes whose 128-point tiles outnumber the card's
              SMs (131,056 points) and do not (16,016, and one tile of 48),
              on a depth-16 net and on the multires 4 / multires_views 2
              layout of configs/: fused_dual against dual_plain and
              fused_field (full and density_only) against field_plain,
              bf16 operands on both sides, elementwise |kernel - plain| <=
              1e-3 + 2e-2 |plain|, density_only's sigma equal to the full
              kernel's;
  3. render   render_rays on make_problem(RaycastConfig(), 8192 rays) with
              coarse_rgb False (dual + field) and True (field x 2): the
              launch counters prove the kernels ran, rgb_map is finite and
              within 5e-3 of the plain PyTorch pipeline on every ray but
              those (at most 1%) whose opacity flips on a knife edge: the
              fine net's sigma at the ray's far sample must change sign
              between the kernel and the float32 net for each of them;
  4. timing   CUDA-event times of both render variants (30 iterations after
              warm-up) and of each kernel and plain version, beside the
              kernel's bound and the card's name and power limit;
  5. training kernels  at the flagship train step's shapes (128 pose groups
              x 16 rays x 64 and x 80 samples) and at one ragged size (3
              groups, a last tile of 16 points, a view bias per group),
              fused_field_stash against field_stash_plain (raw and both
              stashes, the elementwise rule of phase 2; its raw, the WMMA
              body's, against fused_field's on one group by the same rule)
              and field_backward
              against field_bwd_plain, bf16 operands on both sides, each
              gradient tensor to ||kernel - plain||_2 <= GRAD_TOL ||plain||_2,
              and two backward launches bit-identical; then each pass of
              the backward on its own, from the workspace that the same
              launch left: pass (a)'s regions against
              field_bwd_workspace_plain (hs, feat, hv, ghead by the
              elementwise rule; the cotangents gz, gfeat, gzv by it on every
              point whose ReLU masks agree with the plain version's, at most
              MAX_MASK_FLIP_FRAC of the points not, and each to GRAD_TOL
              relative L2), and the launch's d_w (pass (b)) against
              field_wgrad_plain's products of those regions (elementwise);
  6. train    make_train_step on a flagship batch (N_rand 2048 = 128 groups x
              16 rays, with backgrounds) at perturb 0: the launch counters
              read field_stash 2, field_bwd 2 and no eval kernel, the losses
              are finite, and the step's NeRF gradients hold against the
              same step through the plain float32 pipeline; then 5 steps of
              the config's perturbed, noisy training, every loss finite; the
              eval kernels refuse weights that require grad; and the times
              of a train step (with pass (a)'s and (b)'s device time per
              step) and of each training kernel and plain version, each pass
              of kernel 4 by the profiler beside its share of the backward's
              bound, the two-pass design's floor (its workspace bytes at the
              memory rate) and, for pass (b), one torch.mm (cuBLAS) per
              product of the same workspace;
  7. pose kernels  at the pose-refinement step's shapes (configs/h36m/
              h36m_prot2.txt: 256 pose groups x 12 rays x 64 and x 80
              samples) and at one ragged size whose tiles straddle groups
              (3 groups x 7 rays x 80 samples), field_backward with its
              input-gradient branch against field_bwd_plain +
              encode_bwd_plain, bf16 operands on both sides: d_pts, d_dirs
              and d_poses each to relative L2 <= GRAD_TOL; its weight
              gradients bit-identical to a weights-only launch, and two
              launches bit-identical;
  8. pose     make_train_step with opt_pose on an h36m_prot2 batch (N_rand
              3072 = 256 groups x 12 rays over 512 synthetic frames, rot6d
              pose params, framecodes, L1 loss, backgrounds) at perturb 0:
              the launch counters read field_stash 2, field_bwd 2,
              field_bwd_inputs 2 and no eval kernel, and the NeRF and the
              pose gradients each hold to STEP_GRAD_TOL against the same
              step through the plain float32 pipeline; then 5 perturbed,
              noisy steps at opt_pose_step 50 (finite losses, the pose
              unmoved, 5 gradients accumulated) and one at opt_pose_step 1
              (the pose moves); the step's time (with pass (a)'s and (b)'s
              device time per step), and the input branch's
              device time (the profiler's, of pass (c)'s kernels) beside
              its bound;
  9. variants the field kernel's A/B harness (posegen_tpu_torch/tools/
              exp_kernel_variants.py, the port of tools/exp_kernel_variants.py)
              on its problem (8192 rays x 80 samples = 655,360 points, one
              pose): every case and probe of variant_field at tile 64, and
              at each tile on a ragged grouped problem (3 groups x 7 rays x
              80 samples; a tile may straddle groups), against variant_plain
              with bf16 operands to the elementwise rule of phase 2 (the
              encode probe also to relative L2 <= ENC_SUM_TOL), and base at
              tile 64 against fused_field by the same rule; then the
              harness's sweep over tiles 32, 64 and 128 from launch counts
              of 0: every (case, tile) that fits launched chain + 3 times,
              with its time beside its bound; and the plain version's time.

The last two lines of standard output are one JSON object of per-kernel
numbers and one JSON object naming the device. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import math
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
N_GROUPS, RAYS_PER_GROUP = 128, 16  # the flagship train batch: N_rand 2048
POSE_GROUPS, POSE_RPG = 256, 12  # the h36m_prot2 batch: N_rand 3072 in 256 images
POSE_FRAMES = 512
RAGGED_GROUPS, RAGGED_RPG = 3, 7  # 3 x 7 rays x 80 samples = 26 tiles of 64 + 16
# the kernels of the backward's input-gradient branch, pass (c), by name
PASS_C_KERNELS = ("field_bwd_input_kernel", "pose_reduce_kernel", "ray_sum_kernel")
GRAD_TOL = 1e-2  # training kernel vs plain: relative L2 per gradient tensor
STEP_GRAD_TOL = 5e-2  # train step, kernels vs plain f32 pipeline: relative L2, all gradients
TRAIN_ITERS = 20
VARIANT_CHAIN = 10  # launches per timed chain of the harness's sweep (phase 9)
VARIANT_TILE = 64  # kernel 2's tile: the harness's cases are held at it
# the encode probe, kernel vs plain, relative L2 over all points (not the
# elementwise rule: a point's sum of ~1,080 channels may cancel to near 0):
# an ulp between the card's and PyTorch's f32 sin / cos, or the FMA
# contraction of the double-angle recurrence, flips the bf16 rounding of a
# few channels, 2^-8 of one channel each
ENC_SUM_TOL = 1e-3
TRAIN_STEPS = 5
# the Hopper kernels (by a part of their mangled names: the eval kernel's
# three modes, kernel 4's passes (a) and (b)) and the instructions their SASS
# must hold
SM90_KERNELS = {"eval_sm90_kernelILi0E": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi1E": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi2E": ("HGMMA", "UTMALDG"),
                "field_bwd_sm90_kernel": ("HGMMA", "UTMALDG", "UTMASTG"),
                "wgrad_sm90_kernel": ("HGMMA", "UTMALDG")}
# the eval kernels' persistent walk against eval_tile_walk: (points, slots)
EVAL_WALKS = ((1, 132), (127, 132), (128, 132), (129, 132), (16016, 132), (131056, 132),
              (524288, 132), (300, 2))
PASS_A_KERNELS = ("field_bwd_sm90_kernel",)
PASS_B_KERNELS = ("wgrad_sm90_kernel", "wgrad_reduce_kernel")
# pass (a)'s workspace against field_bwd_workspace_plain: the forward's
# regions by the elementwise rule; the cotangents by it on every point whose
# ReLU masks (trunk and view layer) agree with the plain version's, and to
# GRAD_TOL relative L2 over all (a mask on a knife edge, |z| within the
# wgmma-vs-matmul rounding of 0, flips a whole cotangent entry)
WS_FORWARD = ("hs", "feat", "hv", "ghead")
WS_COTANGENTS = ("gz", "gfeat", "gzv")
MAX_MASK_FLIP_FRAC = 0.01  # points allowed a mask that differs from the plain version's
DEVICE = "cuda"
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


def profile_kernels(torch, fn, n: int):
    """torch.profiler over n calls of fn -> (wall ms per call, every device
    kernel as (name, ms per call, launches per call), most time first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    return wall, [(e.key, e.self_device_time_total / 1e3 / n, e.count / n) for e in kern]


def profile_calls(torch, fn, n: int):
    """torch.profiler over n calls of fn -> (wall ms per call, device kernel
    ms per call, every kernel as (name, ms per call, launches per call), most
    time first)."""
    wall, kern = profile_kernels(torch, fn, n)
    return wall, sum(k[1] for k in kern), kern


def kernel_ms(kern, names) -> float:
    """Device ms per call of the profiled kernels whose names hold one of
    `names`; fails if one of them recorded no time."""
    found = {n for n in names for k in kern if n in k[0]}
    check(found == set(names), f"profiler: no device time of {sorted(set(names) - found)}")
    return sum(k[1] for k in kern if any(n in k[0] for n in names))


def bwd_flops(L) -> int:
    """FLOP per point of the weights-only backward, as the JAX kernel's cost
    estimate counts it (posegen_tpu/kernels/field_grad.py:673-676): three
    products (recompute, input cotangents, weight gradients) of the trunk,
    feature and view layers."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    macs = (sum(L.layer_in(i) * WIDTH for i in range(L.depth)) + WIDTH * WIDTH
            + (WIDTH + L.vc) * VIEW_WIDTH)
    return 3 * 2 * macs


def ws_bytes(L) -> int:
    """Bytes per point that kernel 4's pass (a) writes: the bf16 workspace
    (hs, gz: depth x 256; feat, gfeat: 256; hv, gzv: 128; ghead: 16), gzv in
    f32 for the view bias sums, and its bias column sums per 64 points."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    bf16_cols = 2 * L.depth * WIDTH + 2 * WIDTH + 2 * VIEW_WIDTH + 16
    return 2 * bf16_cols + 4 * VIEW_WIDTH + 4 * (L.depth * WIDTH + WIDTH + 4) // 64


def wgrad_in_bytes(L) -> int:
    """Bytes per point of pass (b)'s workspace operands, each read once
    (hs, gz, feat, hv, gfeat, gzv, ghead; the stashes come on top)."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    return 2 * (2 * L.depth * WIDTH + 2 * WIDTH + 2 * VIEW_WIDTH + 16)


def bound(flops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def compare(name: str, got, ref) -> float:
    import torch

    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    bad = err > ATOL + RTOL * ref.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements beyond {ATOL} + {RTOL}|plain| "
          f"(max|diff| {float(err.max()):.3e})")
    return float(err.max())


def check_build(build) -> None:
    """No kernel spills; the Hopper kernels (SM90_KERNELS) issue wgmma
    (HGMMA) and TMA (UTMALDG, and UTMASTG for pass (a)) in their SASS
    (cuobjdump)."""
    import re
    import shutil

    got = build.ptxas_report()
    check(bool(got), "build: no ptxas report")
    for name, (regs, st, ld) in sorted(got.items()):
        print(f"  ptxas: {regs} registers, spills {st} / {ld} bytes: {name}")
    spill = [name for name, (_, st, ld) in got.items() if st or ld]
    check(not spill, f"ptxas: {spill} spill registers")
    cob = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cob, "-sass", str(build.library_path())], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    sections = {sec.split()[0]: sec for sec in out.stdout.split("Function : ")[1:]}
    for kernel, ops in SM90_KERNELS.items():
        found = [name for name in sections if kernel in name]
        check(len(found) == 1, f"SASS: {kernel} not found once in the library")
        counts = {op: sections[found[0]].count(op) for op in ops}
        check(all(counts.values()), f"SASS: {kernel} lacks {[o for o, n in counts.items() if not n]}")
        regs = [v for k, v in got.items() if kernel in k][0]
        n_instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", sections[found[0]]))
        print(f"  SASS {kernel}: " + ", ".join(f"{op} x{n}" for op, n in counts.items())
              + f", {n_instr} instructions ({16 * n_instr} bytes); ptxas {regs[0]} registers, "
              f"spills {regs[1]} / {regs[2]} bytes")


def check_plans(lib, F, FG) -> None:
    """The library's plans against their Python mirrors: the shared memory
    of the eval kernels (the same at every layout), the stash kernel, pass
    (a) and the variant kernel at each tile, the eval kernels' scratch slot,
    at several depths and multires; the eval kernels' persistent grid."""
    from posegen_tpu_torch.kernels import variants as V

    for depth, mr, mv in ((8, 7, 4), (9, 7, 4), (16, 7, 4), (1, 7, 0), (8, 4, 2), (8, 7, 7),
                          (8, 15, 4)):
        L0 = F.net_layout(depth, mr, mv)
        args = F._layout_arg(L0)
        for name, got, want in (
            ("eval shared memory", lib.posegen_field_eval_smem(*args), F.eval_smem_bytes(L0)),
            ("eval slot", lib.posegen_field_eval_slot_bytes(*args), F.eval_slot_bytes(L0)),
            ("stash shared memory", lib.posegen_field_stash_smem(*args), FG.stash_smem_bytes(L0)),
            ("pass (a) shared memory", lib.posegen_field_bwd_smem(*args), FG.bwd_smem_bytes(L0)),
        ) + tuple((f"variant shared memory at tile {t}{' density_only' if d else ''}",
                   lib.posegen_field_variant_smem(t, int(d), *args),
                   V.variant_smem_bytes(L0, t, d)) for t in V.TILES for d in (False, True)):
            check(got == want, f"{name} at depth {depth}, multires {mr} / {mv}: library {got}, "
                               f"Python {want}")
    for n_pts, n_slots in EVAL_WALKS:
        grid = lib.posegen_field_eval_grid(n_pts, n_slots)
        check(grid == len(F.eval_tile_walk(n_pts, n_slots)),
              f"eval grid on {n_pts} points, {n_slots} slots: library {grid}, "
              f"field.py {len(F.eval_tile_walk(n_pts, n_slots))}")


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
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import (
        RaycastConfig, encode_inputs, init_raycaster, render_rays,
    )
    from posegen_tpu_torch.utils.fixtures import make_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    check_build(build)
    lib = build.load()
    check_plans(lib, F, FG)
    chunk = ctypes.c_int()
    for n_pts in (1, 63, 2047, 2048, 4097, 6000, 131072, 163840, 196608, 245760):
        splits = lib.posegen_field_bwd_splits(n_pts, ctypes.byref(chunk))
        check((splits, chunk.value) == FG.wgrad_split_plan(n_pts),
              f"pass (b)'s split of {n_pts} points: library {(splits, chunk.value)}, "
              f"field_grad.py {FG.wgrad_split_plan(n_pts)}")
    print("  the plans: shared memory of the eval, stash, pass (a) and variant kernels, the eval "
          "kernels' slot and grid, pass (b)'s split: library == Python")

    # 2. kernels against their plain versions, at the render's shapes -------
    cfg = RaycastConfig()
    cfg, params, ctx, rays_o, rays_d = make_problem(cfg, n_rays=N_RAYS, seed=SEED,
                                                    device=DEVICE)
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
        imp_pts = shapes["importance"][0]
        # 128-point tiles: 1,024 (the last of 112 points) over the card's
        # SMs; 126 (the last of 16) and one tile of 48 under them
        shapes["ragged_many"] = (imp_pts[:(N_RAYS - 1) * n_s], rays_d[:N_RAYS - 1].contiguous(),
                                 n_s)
        shapes["ragged"] = (imp_pts[:N_RAGGED * n_s], rays_d[:N_RAGGED].contiguous(), n_s)
        shapes["one_tile"] = (imp_pts[:3 * n_s], rays_d[:3].contiguous(), n_s)
        bf16 = torch.bfloat16
        # (tag, points, dirs, samples per ray, pose, coarse net, fine net)
        cases = [(tag, *shapes[tag], pose, net_c, net_f)
                 for tag in ("coarse", "importance", "fine", "ragged_many", "ragged", "one_tile")]
        for tag, kw, n_rays in (("depth16", dict(netdepth=16), 2048),
                                ("multires4_views2", dict(multires=4, multires_views=2), 1000)):
            cfg_x = RaycastConfig(**kw)
            params_x = init_raycaster(cfg_x, torch.Generator().manual_seed(SEED), device=DEVICE)
            L_x = F.net_layout(cfg_x.netdepth, cfg_x.multires, cfg_x.multires_views)
            cases.append((tag, imp_pts[:n_rays * n_s], rays_d[:n_rays].contiguous(), n_s,
                          F.pack_pose(ctx.skts[0], params["embed_kp"], cfg_x.multires,
                                      cfg_x.multires_views),
                          F.prepare_net(params_x["coarse"], L_x),
                          F.prepare_net(params_x["fine"], L_x)))

        err_dual = err_field = 0.0
        for tag, pts, dirs, n_s, pose_t, nc, nf in cases:
            L_t = nf.layout
            kc, kf = F.fused_dual(pts, dirs, n_s, pose_t, nc, nf)
            pc, pf = F.dual_plain(pts, dirs, n_s, pose_t, nc, nf, mm_dtype=bf16)
            kfull = F.fused_field(pts, dirs, n_s, pose_t, nf)
            kden = F.fused_field(pts, dirs, n_s, pose_t, nf, density_only=True)
            pfull = F.field_plain(pts, dirs, n_s, pose_t, nf, mm_dtype=bf16)
            pden = F.field_plain(pts, dirs, n_s, pose_t, nf, density_only=True, mm_dtype=bf16)
            torch.cuda.synchronize()
            e_c, e_f = compare(f"dual coarse {tag}", kc, pc), compare(f"dual fine {tag}", kf, pf)
            check(float(kc[:, :3].abs().max()) == 0.0, f"dual {tag}: coarse rgb rows not zero")
            e_full = compare(f"field {tag}", kfull, pfull)
            e_den = compare(f"field density_only {tag}", kden, pden)
            check(bool(torch.equal(kden[:, 3], kfull[:, 3])),
                  f"field {tag}: density_only sigma differs from the full kernel's")
            check(float(kden[:, :3].abs().max()) == 0.0, f"density_only {tag}: rgb rows not zero")
            err_dual = max(err_dual, e_c, e_f)
            err_field = max(err_field, e_full, e_den)
            print(f"kernels vs plain, {tag} ({pts.shape[0]} points, {-(-pts.shape[0] // 128)} "
                  f"tiles, depth {L_t.depth}, multires {L_t.nf_kp} / {L_t.nf_view}): max|diff| "
                  f"dual coarse {e_c:.3e}, fine {e_f:.3e}; field full {e_full:.3e}, density_only "
                  f"{e_den:.3e} (its sigma == full's)")

    # 3. the main path, through the launch counters -------------------------
    expected = {False: {"dual": 1, "field": 1, "field_stash": 0, "field_bwd": 0,
                        "field_bwd_inputs": 0, "variant": 0},
                True: {"dual": 0, "field": 2, "field_stash": 0, "field_bwd": 0,
                       "field_bwd_inputs": 0, "variant": 0}}
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
        flops = (F.field_flops(L, True) + F.field_flops(L, False)) * P
        nbytes = 12 * P + 12 * N_RAYS + pose.numel() * 4 + w_bytes(net_c) + w_bytes(net_f) + 32 * P
        k_ms = cuda_ms(lambda: F.fused_dual(pts_c, rays_d, s_c, pose, net_c, net_f), 10)
        p_ms = cuda_ms(lambda: F.dual_plain(pts_c, rays_d, s_c, pose, net_c, net_f,
                                            mm_dtype=bf16), 3, warmup=1)
        rows.append(("dual", "coarse", P, k_ms, p_ms, *bound(flops, nbytes)))
        for tag in ("importance", "coarse", "fine"):
            pts, _, n_s = shapes[tag]
            P = pts.shape[0]
            for density_only in (False, True):
                flops = F.field_flops(L, density_only) * P
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

    train_rows, train_err, train_launches, train_library, train_floors = train_phases(torch, card)
    pose_row, pose_err, pose_launches = pose_phases(torch, card)
    variant_row, variant_err, variant_launches = variant_phases(torch, card)

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
    # kernel 4's weights-only branch is two passes, both launched by each
    # field_backward call (its launch count); their bounds add up to the
    # backward's, and design_floor_ms is the two-pass design's workspace
    # traffic at the memory rate
    for name, counter, replaces in (
        ("field_stash", "field_stash", "posegen_tpu/kernels/field_grad.py:252"),
        ("field_bwd_pass_a", "field_bwd", "posegen_tpu/kernels/field_grad.py:340"),
        ("field_bwd_pass_b", "field_bwd", "posegen_tpu/kernels/field_grad.py:340"),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = train_rows[(name, "coarse")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "posegen_tpu_torch/kernels/csrc/field_grad.cu", "replaces": replaces,
            "launches": train_launches[counter], "max_abs_err": train_err[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": train_library.get((name, "coarse")),
        })
        if (name, "coarse") in train_floors:
            kernels[-1]["design_floor_ms"] = train_floors[(name, "coarse")]
    _, _, _, k_ms, p_ms, b_ms, b_by = pose_row
    kernels.append({
        "name": "field_bwd_inputs", "route": "cuda",
        "source": "posegen_tpu_torch/kernels/csrc/field_grad.cu",
        "replaces": "posegen_tpu/kernels/field_grad.py:506",
        "launches": pose_launches, "max_abs_err": pose_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    k_ms, p_ms, b_ms, b_by = variant_row
    kernels.append({
        "name": "variant_field", "route": "cuda",
        "source": "posegen_tpu_torch/kernels/csrc/field_variants.cu",
        "replaces": "tools/exp_kernel_variants.py:269",
        "launches": variant_launches, "max_abs_err": variant_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_batch(torch, n_groups: int, rpg: int, seed: int):
    """A flagship-style batch: n_groups pose rows, rpg rays per group
    (contiguous), random targets and backgrounds."""
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx, make_rays

    ctx = make_pose_ctx(seed, n_poses=n_groups, device=DEVICE)
    rays_o, rays_d = make_rays(n_groups * rpg, seed + 1, device=DEVICE)
    gen = torch.Generator().manual_seed(seed)
    n = n_groups * rpg
    return {
        "rays_o": rays_o, "rays_d": rays_d,
        "target_s": torch.rand((n, 3), generator=gen).to(DEVICE),
        "bgs": torch.rand((n, 3), generator=gen).to(DEVICE),
        "kp3d": ctx.kps, "skts": ctx.skts, "bones": ctx.bones, "cyls": ctx.cyls,
    }


def grad_tensors(F, d_w, d_b, d_bview, L):
    """(name, tensor) of every gradient: trunk and head weights and biases,
    the view bias per group."""
    layers, (wa, ba), (wf, bf), (wv, _), (wr, br) = F._unpack(F.FieldNet(d_w, d_b, L))
    out = []
    for i, (w, b) in enumerate(layers):
        out += [(f"layer{i}.w", w), (f"layer{i}.b", b)]
    return out + [("alpha.w", wa), ("alpha.b", ba), ("feature.w", wf), ("feature.b", bf),
                  ("view.w", wv), ("view.b", d_bview), ("rgb.w", wr), ("rgb.b", br)]


def train_phases(torch, card: str):
    """Phases 5 (training kernels vs plain) and 6 (the train step) ->
    (timing rows by (kernel, shape), max|diff| by kernel, launches by kernel
    in one flagship train step)."""
    import dataclasses

    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves,
    )

    bf16 = torch.bfloat16
    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0)
    L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    batch = train_batch(torch, N_GROUPS, RAYS_PER_GROUP, SEED)
    rpg = RAYS_PER_GROUP

    # 5. training kernels against their plain versions ---------------------
    err = {"field_stash": 0.0, "field_bwd": 0.0, "field_bwd_pass_a": 0.0, "field_bwd_pass_b": 0.0}
    cases, workspaces = {}, {}
    with torch.no_grad():
        ro, rd = batch["rays_o"], batch["rays_d"]
        near, far = samp.get_near_far_in_cylinder(
            ro, rd, batch["cyls"].repeat_interleave(rpg, 0), near=cfg.near, far=cfg.far)
        poses = F.pack_poses(batch["skts"], variables["embed_kp"], cfg.multires,
                             cfg.multires_views)
        net = F.pack_net_f32(variables["fine"], L)
        bview = F.group_view_bias(variables["fine"], L)
        gen = torch.Generator().manual_seed(SEED)
        for tag, n_s in (("coarse", cfg.N_samples), ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            g = torch.randn((pts.shape[0], 4), generator=gen).to(DEVICE)
            cases[tag] = (pts, rd, n_s, poses, bview, g)
        pts, _, n_s, _, _, _ = cases["fine"]
        n_r = RAGGED_GROUPS * RAGGED_RPG
        bview_r = bview + 0.1 * torch.randn((RAGGED_GROUPS, F.VIEW_WIDTH), generator=gen).to(DEVICE)
        g_r = torch.randn((n_r * n_s, 4), generator=gen).to(DEVICE)
        cases["ragged"] = (pts[:n_r * n_s].contiguous(), rd[:n_r].contiguous(), n_s,
                           poses[:RAGGED_GROUPS].contiguous(), bview_r.contiguous(), g_r)

        stashes = {}
        for tag, (pts, dirs, n_s, poses_t, bview_t, g) in cases.items():
            raw, e_pts, e_view = FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t)
            p_raw, p_ep, p_ev = FG.field_stash_plain(pts, dirs, n_s, poses_t, net, bview_t,
                                                     mm_dtype=bf16)
            torch.cuda.synchronize()
            e = max(compare(f"field_stash raw {tag}", raw, p_raw),
                    compare(f"field_stash e_pts {tag}", e_pts.float(), p_ep.float()),
                    compare(f"field_stash e_view {tag}", e_view.float(), p_ev.float()))
            err["field_stash"] = max(err["field_stash"], e)
            stashes[tag] = (e_pts, e_view)
            ws = FG.bwd_workspace(pts.shape[0], L, bview_t.shape[0], 0, DEVICE)
            d = [FG.field_backward(g, e_pts, e_view, net, bview_t, workspace=ws)
                 for _ in range(2)]
            p = FG.field_bwd_plain(e_pts, e_view, g, net, bview_t, mm_dtype=bf16)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*d)),
                  f"field_bwd {tag}: two launches differ")
            worst = (0.0, "")
            for (name, k), (_, r) in zip(grad_tensors(F, *d[0], L), grad_tensors(F, *p, L)):
                check(bool(torch.isfinite(k).all()), f"field_bwd {tag} {name}: not finite")
                e_l2 = rel_l2(k, r)
                check(e_l2 <= GRAD_TOL, f"field_bwd {tag} {name}: relative L2 {e_l2:.3e} "
                                        f"> {GRAD_TOL}")
                worst = max(worst, (e_l2, name))
                err["field_bwd"] = max(err["field_bwd"], float((k - r).abs().max()))
            print(f"kernel field_stash vs plain, {pts.shape[0]} points, {poses_t.shape[0]} "
                  f"groups: max|diff| {e:.3e}; field_bwd vs plain: worst relative L2 "
                  f"{worst[0]:.3e} ({worst[1]}), two launches bit-identical")
            e_a, e_b = backward_pass_checks(torch, FG, L, tag, g, e_pts, e_view, net, bview_t,
                                            ws, d[1][0])
            workspaces[tag] = ws
            err["field_bwd_pass_a"] = max(err["field_bwd_pass_a"], e_a)
            err["field_bwd_pass_b"] = max(err["field_bwd_pass_b"], e_b)

        # one group: the stash kernel (the WMMA body) and the field kernel (the
        # wgmma body) compute one function; they sum in different orders
        pts, dirs, n_s, poses_t, bview_t, _ = cases["coarse"]
        n1 = rpg * n_s
        raw1, _, _ = FG.fused_field_stash(pts[:n1], dirs[:rpg], n_s, poses_t[:1], net, bview_t)
        ref1 = F.fused_field(pts[:n1], dirs[:rpg], n_s, poses_t[0],
                             F.FieldNet(net.w.to(bf16), net.b, L))
        torch.cuda.synchronize()
        e1 = compare("field_stash raw vs fused_field on one group", raw1, ref1)
        print(f"kernel field_stash raw vs fused_field raw on one group: max|diff| {e1:.3e}")

    # 6. the train step -----------------------------------------------------
    tcfg = TrainConfig(rays_per_image=rpg, use_background=True)
    tcfg_plain = dataclasses.replace(tcfg, fused_train=False)
    state_k = create_train_state(variables, tcfg)
    state_p = create_train_state(variables, tcfg_plain)
    F.reset_launches()
    state_k, stats_k = make_train_step(cfg, tcfg)(state_k, batch)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    want = {"field": 0, "dual": 0, "field_stash": 2, "field_bwd": 2, "field_bwd_inputs": 0,
            "variant": 0}
    check(launches == want, f"train step: launches {launches} != {want}")
    state_p, stats_p = make_train_step(cfg, tcfg_plain)(state_p, batch)
    torch.cuda.synchronize()
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "grad_norm"):
        check(bool(torch.isfinite(stats_k[k])), f"train step: {k} not finite")
    gk = [p.grad for p in param_leaves(state_k.params)]
    gp = [p.grad for p in param_leaves(state_p.params)]
    all_l2 = rel_l2(torch.cat([a.reshape(-1) for a in gk]), torch.cat([b.reshape(-1) for b in gp]))
    per = sorted(rel_l2(a, b) for a, b in zip(gk, gp))
    check(all_l2 <= STEP_GRAD_TOL, f"train step gradients vs plain f32 pipeline: relative L2 "
                                   f"{all_l2:.3e} > {STEP_GRAD_TOL}")
    print(f"train step: launches {launches}; total_loss {float(stats_k['total_loss']):.6f} "
          f"(plain f32 {float(stats_p['total_loss']):.6f}), grad_norm "
          f"{float(stats_k['grad_norm']):.6e} (plain {float(stats_p['grad_norm']):.6e}); "
          f"gradients vs plain: relative L2 {all_l2:.3e} over all, per tensor median "
          f"{per[len(per) // 2]:.3e}, max {per[-1]:.3e}")

    leaves = state_k.params["fine"]
    try:
        F.fused_field(cases["coarse"][0], cases["coarse"][1], cases["coarse"][2], poses[0],
                      F.prepare_net(leaves, L))
    except RuntimeError as e:
        check("trainable" in str(e), f"fused_field under grad: unexpected error {e}")
    else:
        raise SmokeFailure("fused_field accepted weights that require grad")
    print("fused_field refuses weights that require grad under autograd")

    cfg_t = RaycastConfig(raw_noise_std=1.0)
    state_t = create_train_state(variables, tcfg)
    step_t = make_train_step(cfg_t, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    losses = []
    for _ in range(TRAIN_STEPS):
        state_t, st = step_t(state_t, batch, gen)
        losses.append(float(st["total_loss"]))
    check(all(map(math.isfinite, losses)), f"training: losses {losses}")
    print(f"training, perturb {cfg_t.perturb}, raw_noise_std {cfg_t.raw_noise_std}: "
          f"total_loss per step {losses}")

    n_rays = N_GROUPS * rpg
    ms = cuda_ms(lambda: step_t(state_t, batch, gen), TRAIN_ITERS)
    print(f"timing train step: {ms:.3f} ms per {n_rays} rays, {n_rays / ms * 1e3:.1f} trained "
          f"rays/s [{card}]")
    wall, busy, top = profile_calls(torch, lambda: step_t(state_t, batch, gen), 3)
    if busy > 0.0:
        print(f"profile train step (torch.profiler, 3 steps): {wall:.3f} ms per step, device "
              f"kernels {busy:.3f} ms, idle share {1.0 - busy / wall:.1%}; kernel 4's pass (a) "
              f"{kernel_ms(top, PASS_A_KERNELS):.3f} ms, pass (b) {kernel_ms(top, PASS_B_KERNELS):.3f} "
              f"ms per step [{card}]")
        for name, k_ms, n in top[:8]:
            print(f"  {k_ms:8.3f} ms  x{n:g}  {name[:90]}")
    else:
        print("profile train step: torch.profiler recorded no device time")

    rows, library, floors = {}, {}, {}
    w_bytes = 2 * L.n_w + 4 * L.n_b
    with torch.no_grad():
        for tag in ("coarse", "fine"):
            pts, dirs, n_s, poses_t, bview_t, g = cases[tag]
            P = pts.shape[0]
            e_pts, e_view = stashes[tag]
            io = 12 * P + 12 * dirs.shape[0] + poses_t.numel() * 4 + w_bytes + bview_t.numel() * 4
            stash_b = (L.pc + L.vc) * 2 * P
            for name, flops, nbytes, kern, plain in (
                ("field_stash", F.field_flops(L, False) * P, io + 16 * P + stash_b,
                 lambda: FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t),
                 lambda: FG.field_stash_plain(pts, dirs, n_s, poses_t, net, bview_t,
                                              mm_dtype=bf16)),
                ("field_bwd", bwd_flops(L) * P,
                 16 * P + stash_b + w_bytes + bview_t.numel() * 4 + 4 * (L.n_w + L.n_b),
                 lambda: FG.field_backward(g, e_pts, e_view, net, bview_t),
                 lambda: FG.field_bwd_plain(e_pts, e_view, g, net, bview_t, mm_dtype=bf16)),
            ):
                k_ms = cuda_ms(kern, 10)
                p_ms = cuda_ms(plain, 3, warmup=1)
                rows[(name, tag)] = (name, tag, P, k_ms, p_ms, *bound(flops, nbytes))
            ws = workspaces[tag]  # pass (a)'s regions from the profiled launches below
            _, kern = profile_kernels(torch, lambda: FG.field_backward(g, e_pts, e_view, net,
                                                                       bview_t, workspace=ws), 5)
            a_ms, b_ms = kernel_ms(kern, PASS_A_KERNELS), kernel_ms(kern, PASS_B_KERNELS)
            pa_ms = cuda_ms(lambda: FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview_t,
                                                                 mm_dtype=bf16), 3, warmup=1)
            pb_ms = cuda_ms(lambda: FG.field_wgrad_plain(ws.regions, e_pts, e_view, L), 3,
                            warmup=1)
            lib_ms, lib_note = library_wgrad_ms(torch, FG, ws, e_pts, e_view, L)
            # Each pass's bound is its share of the backward's (the function's):
            # pass (a) two of its three products and the function's inputs read
            # and bias gradients written, pass (b) the weight-gradient product
            # and d_w written. The workspace between the passes is this
            # design's, not the function's: its bytes at the memory rate are
            # the design's floor, printed and kept beside the bound.
            a_flops, b_flops = bwd_flops(L) * P * 2 // 3, bwd_flops(L) * P // 3
            a_bytes = 16 * P + stash_b + w_bytes + bview_t.numel() * 4 + 4 * L.n_b
            ws_b = ws_bytes(L) * P  # pass (a)'s workspace, written once
            b_in = (wgrad_in_bytes(L) + stash_b // P) * P  # pass (b)'s operands, read once
            rows[("field_bwd_pass_a", tag)] = (
                "field_bwd_pass_a", tag, P, a_ms, pa_ms, *bound(a_flops, a_bytes))
            rows[("field_bwd_pass_b", tag)] = (
                "field_bwd_pass_b", tag, P, b_ms, pb_ms, *bound(b_flops, 4 * L.n_w))
            library[("field_bwd_pass_b", tag)] = lib_ms
            floors[("field_bwd_pass_a", tag)] = ws_b / PEAK_BYTES * 1e3
            floors[("field_bwd_pass_b", tag)] = b_in / PEAK_BYTES * 1e3
            print(f"timing kernel 4 pass (a) {tag} ({P} points): {a_ms:.3f} ms (profiler), "
                  f"operation bound {a_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms; the design's floor, "
                  f"its workspace written at {PEAK_BYTES / 1e12:.2f} TB/s, "
                  f"{floors[('field_bwd_pass_a', tag)]:.3f} ms; plain {pa_ms:.3f} ms [{card}]")
            print(f"timing kernel 4 pass (b) {tag} ({P} points): {b_ms:.3f} ms (profiler), "
                  f"operation bound {b_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms; the design's floor, "
                  f"its workspace and stash read, {floors[('field_bwd_pass_b', tag)]:.3f} ms; "
                  f"plain {pb_ms:.3f} ms; library (one torch.mm per product, {lib_note}) "
                  f"{lib_ms:.3f} ms [{card}]")
    for name, tag, P, k_ms, p_ms, b_ms, b_by in rows.values():
        print(f"timing kernel {name} {tag} ({P} points, 2 launches per step): {k_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms "
              f"[{card}]")
    return rows, err, launches, library, floors


def backward_pass_checks(torch, FG, L, tag, g, e_pts, e_view, net, bview, ws, d_w):
    """Phase 5's hold on each pass of kernel 4 on its own, from one
    field_backward launch: pass (a)'s regions that it left in its workspace
    `ws` against field_bwd_workspace_plain (see WS_FORWARD, WS_COTANGENTS),
    and its d_w (pass (b)) against field_wgrad_plain's products of those
    regions -> (max|diff| of (a), of (b))."""
    plain = FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview, mm_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    names = WS_FORWARD + WS_COTANGENTS
    k = {n: ws.regions[n].float() for n in names}
    p = {n: plain[n].float() for n in names}
    err_a = max(compare(f"pass (a) {n} {tag}", k[n], p[n]) for n in WS_FORWARD)
    flip = ((k["hs"] > 0) != (p["hs"] > 0)).any(-1).any(0) | ((k["hv"] > 0) != (p["hv"] > 0)).any(-1)
    n_flip, n_pts = int(flip.sum()), flip.numel()
    check(n_flip <= MAX_MASK_FLIP_FRAC * n_pts, f"pass (a) {tag}: {n_flip} of {n_pts} points' "
                                                "ReLU masks differ from the plain version's")
    msg = []
    for n in WS_COTANGENTS:
        e_l2 = rel_l2(k[n], p[n])
        check(e_l2 <= GRAD_TOL, f"pass (a) {n} {tag}: relative L2 {e_l2:.3e} > {GRAD_TOL}")
        ok = ~flip if k[n].dim() == 2 else (~flip)[None].expand(k[n].shape[0], -1)
        err_a = max(err_a, compare(f"pass (a) {n} {tag}, points whose masks agree", k[n][ok],
                                   p[n][ok]))
        msg.append(f"{n} {e_l2:.3e}")
    ref = FG.field_wgrad_plain(ws.regions, e_pts, e_view, L)
    torch.cuda.synchronize()
    err_b = compare(f"pass (b) d_w {tag}", d_w, ref)
    print(f"  pass (a) {tag}: workspace vs field_bwd_workspace_plain max|diff| {err_a:.3e} "
          f"({', '.join(WS_FORWARD)} elementwise; {', '.join(WS_COTANGENTS)} elementwise on the "
          f"{n_pts - n_flip} of {n_pts} points whose ReLU masks agree, relative L2 "
          f"{', '.join(msg)}); pass (b) d_w vs field_wgrad_plain on the kernel's workspace "
          f"max|diff| {err_b:.3e}, relative L2 {rel_l2(d_w, ref):.3e}")
    return err_a, err_b


def library_wgrad_ms(torch, FG, ws, e_pts, e_view, L):
    """Pass (b)'s yardstick, timed and used nowhere in the port: one torch.mm
    (cuBLAS) per product G^T H of the same workspace tensors -> (ms, its
    output type)."""
    prods = FG.wgrad_products(ws.regions, e_pts, e_view, L)
    kw, note = {"out_dtype": torch.float32}, "f32 out"
    try:
        torch.mm(prods[0][1].T, prods[0][2], **kw)
    except (TypeError, RuntimeError):
        kw, note = {}, "bf16 out: this torch.mm takes no out_dtype"
    return cuda_ms(lambda: [torch.mm(gg.T, x, **kw) for _, gg, x, _, _ in prods], 10), note


def input_bwd_flops(L) -> int:
    """FLOP per point of the input-gradient branch's products: g_e_pts from
    layer 0's and the skip consumer's e_pts columns, g_e_view from the view
    layer's e_view columns (not its zero pad columns)."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    n_pc = 2 if L.skip >= 0 else 1
    return 2 * (n_pc * WIDTH * L.pc + VIEW_WIDTH * L.vc)


def pose_batch(torch, n_groups: int, rpg: int, n_frames: int, seed: int):
    """An h36m_prot2-style pose-refinement problem: rot6d pose params and
    anchors over n_frames synthetic frames (axis-angle estimates, SMPL rest
    pose joints), and a batch of n_groups images x rpg rays, each group at a
    random frame with its framecode, cylinders around the frames' joints,
    random targets and backgrounds."""
    import numpy as np

    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params, pose_apply
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
    from posegen_tpu_torch.utils.fixtures import make_rays

    rng = np.random.default_rng(seed)
    bones = (rng.standard_normal((n_frames, 24, 3)) * 0.2).astype(np.float32)
    kp3d = np.tile(SMPL_REST_POSE[None], (n_frames, 1, 1))
    pcfg = PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01, opt_pose_type="BE")
    params, anchors = init_pose_params(pcfg, bones, kp3d, device=DEVICE)
    rest = torch.as_tensor(SMPL_REST_POSE, device=DEVICE)
    kp_idx = torch.as_tensor(rng.integers(0, n_frames, n_groups), device=DEVICE)
    with torch.no_grad():
        kps = pose_apply(params, kp_idx, rest)[0]
    n = n_groups * rpg
    rays_o, rays_d = make_rays(n, seed + 1, device=DEVICE)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "rays_o": rays_o, "rays_d": rays_d,
        "target_s": torch.rand((n, 3), generator=gen).to(DEVICE),
        "bgs": torch.rand((n, 3), generator=gen).to(DEVICE),
        "cyls": get_kp_bounding_cylinder(kps, ext_scale=0.001), "kp_idx": kp_idx,
        "kp3d": kps + 0.01 * torch.randn(kps.shape, generator=gen).to(DEVICE),
        "cam_idxs": kp_idx.repeat_interleave(rpg)[:, None],
    }
    return pcfg, params, anchors, rest, batch


def pose_phases(torch, card: str):
    """Phases 7 (the input-gradient branch vs plain) and 8 (the
    pose-refinement train step) -> (timing row of the input branch at the
    coarse shape, its max|diff| against plain, its launches in one step)."""
    import dataclasses

    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.pose.opt import pose_apply
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves, trainable,
    )

    bf16 = torch.bfloat16
    # configs/h36m/h36m_prot2.txt: the SURREAL architecture with framecodes
    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0, opt_framecode=True,
                        n_framecodes=POSE_FRAMES)
    L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    pcfg, pose0, anchors, rest, batch = pose_batch(torch, POSE_GROUPS, POSE_RPG, POSE_FRAMES,
                                                   SEED)
    rpg = POSE_RPG

    # 7. the input-gradient branch against its plain version ---------------
    err, cases = 0.0, {}
    with torch.no_grad():
        ro, rd = batch["rays_o"], batch["rays_d"]
        skts = pose_apply(pose0, batch["kp_idx"], rest)[2]
        near, far = samp.get_near_far_in_cylinder(
            ro, rd, batch["cyls"].repeat_interleave(rpg, 0), near=cfg.near, far=cfg.far)
        poses = F.pack_poses(skts, variables["embed_kp"], cfg.multires, cfg.multires_views)
        net = F.pack_net_f32(variables["fine"], L)
        codes = variables["fine"]["framecodes"][batch["kp_idx"]]
        bview = F.group_view_bias(variables["fine"], L, codes).contiguous()
        gen = torch.Generator().manual_seed(SEED)
        for tag, n_s in (("coarse", cfg.N_samples), ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            g = torch.randn((pts.shape[0], 4), generator=gen).to(DEVICE)
            cases[tag] = (pts, rd, n_s, poses, bview, g)
        pts, _, n_s, _, _, _ = cases["fine"]
        n_r = RAGGED_GROUPS * RAGGED_RPG
        g_r = torch.randn((n_r * n_s, 4), generator=gen).to(DEVICE)
        rows = torch.arange(RAGGED_GROUPS, device=DEVICE) * rpg
        cases["ragged"] = (torch.cat([pts[r * n_s:(r + RAGGED_RPG) * n_s] for r in rows.tolist()]),
                           torch.cat([rd[r:r + RAGGED_RPG] for r in rows.tolist()]), n_s,
                           poses[:RAGGED_GROUPS].contiguous(),
                           bview[:RAGGED_GROUPS].contiguous(), g_r)
        stashes = {}
        for tag, (pts, dirs, n_s, poses_t, bview_t, g) in cases.items():
            _, e_pts, e_view = FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t)
            stashes[tag] = (e_pts, e_view)
            ins = FG.FieldInputs(pts, dirs, n_s, poses_t)
            d = [FG.field_backward(g, e_pts, e_view, net, bview_t, ins) for _ in range(2)]
            w_only = FG.field_backward(g, e_pts, e_view, net, bview_t)
            *_, g_ep, g_ev = FG.field_bwd_plain(e_pts, e_view, g, net, bview_t, mm_dtype=bf16,
                                                input_grads=True)
            plain = FG.encode_bwd_plain(pts, dirs, n_s, poses_t, g_ep, g_ev, L.nf_kp, L.nf_view)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*d)),
                  f"field_bwd_inputs {tag}: two launches differ")
            check(all(torch.equal(a, b) for a, b in zip(d[0][:3], w_only)),
                  f"field_bwd_inputs {tag}: weight gradients differ from a weights-only launch")
            msg = []
            for name, k, r in zip(("d_pts", "d_dirs", "d_poses"), d[0][3:], plain):
                check(bool(torch.isfinite(k).all()), f"field_bwd_inputs {tag} {name}: not finite")
                e_l2 = rel_l2(k, r)
                check(e_l2 <= GRAD_TOL, f"field_bwd_inputs {tag} {name}: relative L2 "
                                        f"{e_l2:.3e} > {GRAD_TOL}")
                err = max(err, float((k - r).abs().max()))
                msg.append(f"{name} {e_l2:.3e}")
            check(float(d[0][5][:, F.POSE_FLOATS - 25:].abs().max()) == 0.0,
                  f"field_bwd_inputs {tag}: cut / tau / octave slots of d_poses not zero")
            print(f"kernel field_bwd_inputs vs plain, {pts.shape[0]} points, {poses_t.shape[0]} "
                  f"groups: relative L2 {', '.join(msg)}; weight gradients == weights-only "
                  f"launch, two launches bit-identical")

    # 8. the pose-refinement train step ------------------------------------
    tcfg = TrainConfig(loss_fn="L1", use_background=True, lrate_decay=500000, decay_unit=1,
                       opt_pose=True, opt_pose_step=50, opt_pose_lrate=5e-4,
                       opt_pose_decay_rate=1.0, opt_pose_lrate_decay=2,
                       opt_pose_decay_unit=1000, opt_pose_coef=2.0, rays_per_image=rpg)
    tcfg_plain = dataclasses.replace(tcfg, fused_train=False)

    def fresh(t):
        return create_train_state(variables, t, trainable(pose0), anchors)

    def step_of(c, t):
        return make_train_step(c, t, pcfg, rest_pose=rest)

    state_k, state_p = fresh(tcfg), fresh(tcfg_plain)
    F.reset_launches()
    state_k, stats_k = step_of(cfg, tcfg)(state_k, batch)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    want = {"field": 0, "dual": 0, "field_stash": 2, "field_bwd": 2, "field_bwd_inputs": 2,
            "variant": 0}
    check(launches == want, f"pose step: launches {launches} != {want}")
    state_p, stats_p = step_of(cfg, tcfg_plain)(state_p, batch)
    torch.cuda.synchronize()
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "kp_loss", "mpjpc", "grad_norm",
              "pose_grad_norm"):
        check(bool(torch.isfinite(stats_k[k])), f"pose step: {k} not finite")
    check(float(stats_k["pose_grad_norm"]) > 0.0, "pose step: the pose got no gradient")
    out = []
    for what, gk, gp in (
        ("NeRF", [p.grad for p in param_leaves(state_k.params)],
         [p.grad for p in param_leaves(state_p.params)]),
        ("pose", [p.grad for p in state_k.pose_params.values()],
         [p.grad for p in state_p.pose_params.values()]),
    ):
        e_l2 = rel_l2(torch.cat([a.reshape(-1) for a in gk]),
                      torch.cat([b.reshape(-1) for b in gp]))
        check(e_l2 <= STEP_GRAD_TOL, f"pose step {what} gradients vs plain f32 pipeline: "
                                     f"relative L2 {e_l2:.3e} > {STEP_GRAD_TOL}")
        out.append(f"{what} {e_l2:.3e}")
    print(f"pose step: launches {launches}; total_loss {float(stats_k['total_loss']):.6f} (plain "
          f"f32 {float(stats_p['total_loss']):.6f}), pose_grad_norm "
          f"{float(stats_k['pose_grad_norm']):.6e} (plain {float(stats_p['pose_grad_norm']):.6e}); "
          f"gradients vs plain: relative L2 {', '.join(out)}")

    cfg_t = dataclasses.replace(cfg, perturb=1.0, raw_noise_std=1.0)
    state_t = fresh(tcfg)
    step_t = step_of(cfg_t, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    before = {k: v.detach().clone() for k, v in state_t.pose_params.items()}
    losses = []
    for _ in range(TRAIN_STEPS):
        state_t, st = step_t(state_t, batch, gen)
        losses.append(float(st["total_loss"]))
    check(all(map(math.isfinite, losses)), f"pose training: losses {losses}")
    check(all(torch.equal(before[k], v) for k, v in state_t.pose_params.items()),
          "pose training: the pose moved inside an accumulation")
    check(state_t.pose_opt_state.mini_step == TRAIN_STEPS,
          f"pose training: {state_t.pose_opt_state.mini_step} gradients accumulated")
    tcfg1 = dataclasses.replace(tcfg, opt_pose_step=1)
    state_1, _ = step_of(cfg_t, tcfg1)(fresh(tcfg1), batch, gen)
    moved = sum(not torch.equal(pose0[k].detach(), v) for k, v in state_1.pose_params.items())
    check(moved == len(pose0), "pose step at opt_pose_step 1: the pose did not move")
    print(f"pose training, perturb {cfg_t.perturb}, raw_noise_std {cfg_t.raw_noise_std}, "
          f"opt_pose_step 50: total_loss per step {losses}, pose unmoved, "
          f"{state_t.pose_opt_state.mini_step} gradients accumulated; opt_pose_step 1 moves it")

    n_rays = POSE_GROUPS * rpg
    ms = cuda_ms(lambda: step_t(state_t, batch, gen), TRAIN_ITERS)
    print(f"timing pose step: {ms:.3f} ms per {n_rays} rays, {n_rays / ms * 1e3:.1f} trained "
          f"rays/s [{card}]")
    wall, busy, top = profile_calls(torch, lambda: step_t(state_t, batch, gen), 3)
    if busy > 0.0:
        print(f"profile pose step (torch.profiler, 3 steps): {wall:.3f} ms per step, device "
              f"kernels {busy:.3f} ms, idle share {1.0 - busy / wall:.1%}; kernel 4's pass (a) "
              f"{kernel_ms(top, PASS_A_KERNELS):.3f} ms, pass (b) {kernel_ms(top, PASS_B_KERNELS):.3f} "
              f"ms per step [{card}]")
        for name, k_ms, n in top[:8]:
            print(f"  {k_ms:8.3f} ms  x{n:g}  {name[:90]}")
    else:
        print("profile pose step: torch.profiler recorded no device time")

    # the input branch's time: the device time of pass (c)'s kernels in a
    # backward with the branch, by the profiler; the plain version's, its
    # three products and encode_bwd_plain on seeded stand-ins for the
    # workspace's cotangents (dense work: its time does not depend on them)
    layers, _, _, (wv, _), _ = F._unpack(net)
    w_ep = [layers[0][0]] + ([layers[L.skip + 1][0][:, :L.pc]] if L.skip >= 0 else [])
    w_ev = wv[:, F.WIDTH:F.WIDTH + L.vc]

    def tn(gg, w):  # field_bwd_plain's input-cotangent product, bf16 operands
        return gg.to(bf16).float() @ w.to(bf16).float()

    rows, gen_gz = {}, torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for tag in ("coarse", "fine"):
            pts, dirs, n_s, poses_t, bview_t, g = cases[tag]
            e_pts, e_view = stashes[tag]
            P, G = pts.shape[0], poses_t.shape[0]
            ins = FG.FieldInputs(pts, dirs, n_s, poses_t)
            _, kern = profile_kernels(
                torch, lambda: FG.field_backward(g, e_pts, e_view, net, bview_t, ins), 5)
            branch = [k for k in kern if any(n in k[0] for n in PASS_C_KERNELS)]
            k_ms = sum(k[1] for k in branch)
            found = {n for n in PASS_C_KERNELS for k in branch if n in k[0]}
            check(k_ms > 0.0 and found == set(PASS_C_KERNELS),
                  f"field_bwd_inputs {tag}: the profiler read no device time of "
                  f"{sorted(set(PASS_C_KERNELS) - found) or PASS_C_KERNELS}")
            gz = [torch.randn((P, F.WIDTH), generator=gen_gz).to(DEVICE, bf16) for _ in w_ep]
            gzv = torch.randn((P, F.VIEW_WIDTH), generator=gen_gz).to(DEVICE, bf16)

            def plain_in():
                g_ep = sum(tn(a, w) for a, w in zip(gz, w_ep))
                return FG.encode_bwd_plain(pts, dirs, n_s, poses_t, g_ep, tn(gzv, w_ev),
                                           L.nf_kp, L.nf_view)

            p_ms = cuda_ms(plain_in, 3, warmup=1)
            # read: three bf16 cotangent rows per point, pts, dirs, pose rows and
            # the weights' input columns; written: d_pts, d_dirs, d_poses
            nbytes = (2 * (2 * F.WIDTH + F.VIEW_WIDTH) * P + 2 * (12 * P + 12 * dirs.shape[0]
                      + 4 * poses_t.numel()) + 2 * (2 * F.WIDTH * L.pc + F.VIEW_WIDTH * L.vc))
            b_ms, b_by = bound(input_bwd_flops(L) * P, nbytes)
            rows[tag] = ("field_bwd_inputs", tag, P, k_ms, p_ms, b_ms, b_by)
            parts = ", ".join(f"{n.split('(')[0]} {ms:.3f}" for n, ms, _ in branch)
            print(f"timing kernel field_bwd_inputs {tag} ({P} points, {G} groups, 2 launches per "
                  f"step): {k_ms:.3f} ms ({parts}; the whole backward {sum(k[1] for k in kern):.3f}"
                  f" ms of device time), bound {b_ms:.3f} ms ({b_by}, {b_ms / k_ms:.1%} of it), "
                  f"plain {p_ms:.3f} ms [{card}]")
    return rows["coarse"], err, launches["field_bwd_inputs"]



def variant_phases(torch, card: str):
    """Phase 9 (the field kernel's variants vs plain, then the A/B harness's
    sweep) -> ((ms, plain ms, bound ms, bound by) of base at VARIANT_TILE on
    the harness's problem, max|diff| against plain over every case, the
    sweep's launches)."""
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import variants as V
    from posegen_tpu_torch.tools import exp_kernel_variants as H

    bf16 = torch.bfloat16
    prob = H.make_inputs(N_RAYS, DEVICE)
    ragged = H.make_inputs(RAGGED_GROUPS * RAGGED_RPG, DEVICE, n_groups=RAGGED_GROUPS)
    L = prob.net.layout
    cases = H.CASES + H.PROBES
    err = 0.0
    with torch.no_grad():
        for name, kw in cases:
            dens = kw.get("density_only", False)
            fits = [t for t in V.TILES
                    if V.variant_refusal(L, t, bf16enc=kw.get("bf16enc", False),
                                         halves=kw.get("halves", 1),
                                         mxenc=kw.get("mxenc", False)) is None
                    and V.variant_blocks_per_sm(L, t, dens) > 0]
            msg = []
            for tag, pr, tiles in (("flagship", prob, [VARIANT_TILE]), ("ragged", ragged, fits)):
                p = V.variant_plain(*pr, mm_dtype=bf16, **kw)
                for tile in tiles:
                    k = V.variant_field(*pr, tile=tile, **kw)
                    torch.cuda.synchronize()
                    what = f"variant {name} {tag} tile {tile}"
                    if kw.get("encode_only") is True:  # sums that may cancel: relative L2
                        check(bool(torch.isfinite(k).all()), f"{what}: kernel output not finite")
                        e_l2 = rel_l2(k, p)
                        check(e_l2 <= ENC_SUM_TOL, f"{what}: relative L2 {e_l2:.3e} > {ENC_SUM_TOL}")
                        e = float((k - p).abs().max())
                        msg.append(f"{tag}@{tile} {e:.3e} (relative L2 {e_l2:.3e})")
                    else:
                        e = compare(what, k, p)
                        msg.append(f"{tag}@{tile} {e:.3e}")
                    if dens and not kw.get("encode_only"):
                        check(float(k[:, :3].abs().max()) == 0.0, f"{what}: rgb rows not zero")
                    err = max(err, e)
            print(f"kernel variant_field {name} vs variant_plain ({prob.pts.shape[0]} / "
                  f"{ragged.pts.shape[0]} points, {ragged.poses.shape[0]} groups): max|diff| "
                  + ", ".join(msg))

        # base at kernel 2's tile is kernel 2's function on the WMMA body:
        # on the harness's problem, given one direction per ray of S points,
        # fused_field (the wgmma body) computes it in another summation
        # order; their times, taken in turns
        S = prob.pts.shape[0] // N_RAYS
        ray_dirs = prob.dirs[::S].contiguous()
        field2 = lambda: F.fused_field(prob.pts, ray_dirs, S, prob.poses[0], prob.net)
        base64 = lambda: V.variant_field(*prob, tile=VARIANT_TILE)
        e_base = compare(f"variant base at tile {VARIANT_TILE} vs fused_field", base64(), field2())
        turns = [cuda_ms(f, VARIANT_CHAIN) for f in (field2, base64, base64, field2)]
        print(f"variant base at tile {VARIANT_TILE} vs fused_field on the harness's problem: "
              f"max|diff| {e_base:.3e}; ms in turns (field, variant, variant, field): "
              f"{', '.join(f'{t:.3f}' for t in turns)} [{card}]")

        # the harness's sweep: the main path of this phase
        print(f"harness sweep (posegen_tpu_torch.tools.exp_kernel_variants, {N_RAYS} rays x "
              f"{prob.pts.shape[0] // N_RAYS} samples, chain {VARIANT_CHAIN}) [{card}]")
        F.reset_launches()
        rows = H.sweep(prob, V.TILES, VARIANT_CHAIN, log=lambda line: print(f"  {line}"))
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        want = {k: 0 for k in launches}
        want["variant"] = len(rows) * (VARIANT_CHAIN + 3)
        check(launches == want, f"harness sweep: launches {launches} != {want}")
        ran = {(r["name"], r["tile"]) for r in rows}
        check({(n, VARIANT_TILE) for n, _ in cases} <= ran,
              f"harness sweep: cases missing at tile {VARIANT_TILE}")
        check({("base", 32), ("dens_base", 32), ("dens_base", 128)} <= ran,
              "harness sweep: base / dens_base missing at tiles 32 / 128")
        print(f"harness sweep: {len(rows)} (case, tile) pairs ran, launches {launches}")

        base = next(r for r in rows if (r["name"], r["tile"]) == ("base", VARIANT_TILE))
        p_ms = cuda_ms(lambda: V.variant_plain(*prob, mm_dtype=bf16), 3, warmup=1)
        P = prob.pts.shape[0]
        b_ms, b_by = base["bound"]
        print(f"timing kernel variant_field base tile {VARIANT_TILE} ({P} points): "
              f"{base['ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}, {b_ms / base['ms']:.1%} of it), "
              f"plain {p_ms:.3f} ms [{card}]")
    return (base["ms"], p_ms, b_ms, b_by), err, launches["variant"]


if __name__ == "__main__":
    sys.exit(main())
