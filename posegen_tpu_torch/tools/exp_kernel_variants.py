"""A/B experiments on the field kernel's variants (port of
tools/exp_kernel_variants.py's main(), the harness of kernel 2).

    python -m posegen_tpu_torch.tools.exp_kernel_variants [--n_rays 8192]
        [--chain 10] [--tiles 128]
    python -m posegen_tpu_torch.tools.exp_kernel_variants --cpu --n_rays 4

The problem is the JAX harness's: make_problem(RaycastConfig()) with
n_rays rays, 80 samples per ray at z = linspace(0.1, 4.0, 80), one
direction per point, the first pose (one pose group) and the coarse net:
655,360 points at 8192 rays. Each case of the JAX harness, in its order,
then two probes (the encode alone, and the transforms and gates alone),
runs at each tile (points per tile): on the card a chain of --chain
launches after two warm-ups, timed with CUDA events, with its share of the
bf16 tensor-core bound and max|d| against the first output of the same
function (base's at the first tile for the full field). The kernel is the
eval kernel (kernels/variants.py): base and dens_base are the main path's
kernel, the other cases and the probes its variants, all on its 128-point
tile. A (case, tile) the kernel does not take is printed as skipped, with
the reason. --cpu runs the plain versions on the host: the numeric check
alone, no times.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from posegen_tpu_torch.kernels import field as F
from posegen_tpu_torch.kernels import variants as V

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth

# tools/exp_kernel_variants.py main(): the same cases in the same order
CASES: Tuple[Tuple[str, Dict], ...] = (
    ("base", dict()),
    ("skipsplit", dict(skipsplit=True)),
    ("bf16act", dict(bf16act=True)),
    ("both", dict(skipsplit=True, bf16act=True)),
    ("viewsplit", dict(skipsplit=True, viewsplit=True)),
    ("bf16enc", dict(skipsplit=True, viewsplit=True, bf16enc=True)),
    ("pipe2", dict(skipsplit=True, viewsplit=True, bf16enc=True, halves=2)),
    ("pipe4", dict(skipsplit=True, viewsplit=True, bf16enc=True, halves=4)),
    ("mxenc", dict(skipsplit=True, viewsplit=True, mxenc=True)),
    ("dens_mxenc", dict(density_only=True, skipsplit=True, mxenc=True)),
    ("dens_base", dict(density_only=True, skipsplit=True)),
)
# the probes: what share of base is the encode, and of that the transforms
# and gates
PROBES: Tuple[Tuple[str, Dict], ...] = (
    ("enc", dict(encode_only=True)),
    ("gates", dict(encode_only="gates")),
)


class Problem(NamedTuple):
    pts: torch.Tensor  # (P, 3)
    dirs: torch.Tensor  # (P, 3), one per point
    poses: torch.Tensor  # (G, n_pose)
    net: F.FieldNet


def make_inputs(n_rays: int, device="cuda", seed: int = 0, n_groups: int = 1) -> Problem:
    """The harness's problem at n_rays rays x 80 samples: make_problem's
    rays and coarse net; one pose group (make_problem's pose), or n_groups
    random poses (make_pose_ctx) over consecutive runs of rays."""
    from posegen_tpu_torch.render.raycast import RaycastConfig
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx, make_problem

    cfg, params, ctx, rays_o, rays_d = make_problem(RaycastConfig(), n_rays=n_rays, seed=seed,
                                                    device=device)
    if n_rays % n_groups:
        raise ValueError(f"{n_rays} rays do not split into {n_groups} pose groups")
    S = cfg.N_samples + cfg.N_importance
    z = torch.linspace(0.1, 4.0, S, device=rays_o.device)
    pts = (rays_o[:, None] + rays_d[:, None] * z[:, None]).reshape(-1, 3).contiguous()
    dirs = rays_d[:, None].expand(n_rays, S, 3).reshape(-1, 3).contiguous()
    skts = ctx.skts[:1] if n_groups == 1 else make_pose_ctx(seed, n_poses=n_groups,
                                                            device=device).skts
    poses = F.pack_poses(skts, params["embed_kp"], cfg.multires, cfg.multires_views)
    layout = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    return Problem(pts, dirs, poses, F.prepare_net(params["coarse"], layout))


def code_of(kw: Dict) -> Tuple:
    """The kernel arguments a case launches with: cases with one value run
    the same code."""
    enc = V.encode_of(kw.get("bf16enc", False), kw.get("mxenc", False))
    return (kw.get("density_only", False), kw.get("encode_only", False), enc,
            kw.get("halves", 1))


def function_of(kw: Dict) -> str:
    """Which function a case computes, for its max|d| reference."""
    probe = kw.get("encode_only", False)
    if probe == "gates":
        return "gates"
    dens = kw.get("density_only", False)
    if probe:
        return "encode sums, density-only" if dens else "encode sums"
    return "density-only field" if dens else "field"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def chain_ms(fn: Callable[[], torch.Tensor], chain: int, warmup: int = 2) -> float:
    """Milliseconds per call of fn over a chain of `chain` calls after
    `warmup` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(chain):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / chain


def bound(prob: Problem, kw: Dict) -> Optional[Tuple[float, str]]:
    """(ms, "operations" | "bytes"): the least time the card could take for
    the case, operations at the bf16 peak or bytes at the HBM rate (each
    input read once, the output written once), the larger; None for a
    probe, which does no tensor-core work."""
    if kw.get("encode_only", False):
        return None
    P = prob.pts.shape[0]
    t_ops = F.field_flops(prob.net.layout, kw.get("density_only", False)) * P / PEAK_BF16_FLOPS
    t_bytes = ((prob.pts.numel() + prob.dirs.numel() + prob.poses.numel() + prob.net.b.numel()
                + 4 * P) * 4 + prob.net.w.numel() * 2) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sweep(prob: Problem, tiles: Sequence[int], chain: int,
          cases: Sequence[Tuple[str, Dict]] = CASES + PROBES, timed: bool = True,
          log: Callable[[str], None] = print) -> List[Dict]:
    """Run every (case, tile) -> one row per pair that ran: name, tile, ms
    (None untimed), bound (see `bound`), shared-memory bytes, max|d| against
    the first output of the same function and which one that was. timed
    False: the plain versions on the host, no times."""
    L = prob.net.layout
    P = prob.pts.shape[0]
    rows: List[Dict] = []
    refs: Dict[str, Tuple[str, torch.Tensor]] = {}
    for name, kw in cases:
        dens = kw.get("density_only", False)
        for tile in tiles:
            head = f"{name:10s} tile={tile:4d}:"
            reason = V.variant_refusal(L, tile, encode_only=kw.get("encode_only", False),
                                       bf16enc=kw.get("bf16enc", False),
                                       halves=kw.get("halves", 1), mxenc=kw.get("mxenc", False),
                                       density_only=dens)
            if reason is not None:
                log(f"{head} skipped ({reason})")
                continue
            smem = F.eval_smem_bytes(L)  # every variant's plan

            def run(tile=tile, kw=kw):
                return V.variant_field(prob.pts, prob.dirs, prob.poses, prob.net, tile=tile, **kw)

            ms = chain_ms(run, chain) if timed else None
            out = run()
            fn_name = function_of(kw)
            ref_name, ref = refs.setdefault(fn_name, (f"{name}@{tile}", out))
            err = float((out - ref).abs().max())
            b = bound(prob, kw)
            rows.append(dict(name=name, tile=tile, ms=ms, bound=b, smem=smem, err=err,
                             ref=ref_name, code=code_of(kw)))
            d = f"max|d| vs {ref_name} {err:.2e}"
            if ms is None:
                log(f"{head} {d}")
                continue
            rate = f"{ms:8.3f} ms ({P / ms / 1e3:7.1f} Mpts/s)"
            share = ("bound none (probe)" if b is None
                     else f"{b[0] / ms:6.1%} of bound {b[0]:.3f} ms ({b[1]})")
            log(f"{head} {rate}, {share}, {smem:,} B of shared memory, {d}")
    same: Dict[Tuple, List[str]] = {}
    for name, kw in cases:
        if name not in same.setdefault(code_of(kw), []):
            same[code_of(kw)].append(name)
    for names in same.values():
        if len(names) > 1:
            log(f"same code: {' = '.join(names)}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_rays", type=int, default=8192)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--tiles", type=str, default=",".join(map(str, V.TILES)))
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the host: numeric check only, no times")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = make_inputs(args.n_rays, device)
    P = prob.pts.shape[0]
    where = "cpu: plain versions, no times" if args.cpu else card_line()
    print(f"fine-pass shape: {args.n_rays} rays x {P // args.n_rays} samples = {P} pts; "
          f"chain={args.chain}  [{where}]")
    tiles = [int(t) for t in args.tiles.split(",")]
    with torch.no_grad():
        sweep(prob, tiles, args.chain, timed=not args.cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
