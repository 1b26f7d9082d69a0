"""The field kernel's A/B variants: the kernel wrapper, its plain version and
the rules of what the kernel takes (port of
tools/exp_kernel_variants.py::variant_field).

The eval kernel's grouped modes (csrc/field_eval.cuh, instantiated in
csrc/field_variants.cu) replace the harness's Pallas kernel:

  variant_field  <- tools/exp_kernel_variants.py::variant_field (:269):
                    kernel 2's encode + MLP on points grouped by pose, with
                    one direction per point, under the harness's flags

base and dens_base launch the main path's kernel itself
(`fused_field` on a pose table: posegen_field_grouped), the other cases and
the probes its variants on the same 128-point tile, rings and slots; only
the harness's cases and probes are built (`BUILT`). Every variant takes the
eval kernels' shared-memory plan (`field.eval_smem_bytes`).

The flags that change the function:
  density_only        trunk + alpha head, rgb columns zero;
  encode_only=True    a probe: each point's sum of its encoding channels
                      (x_pts, and x_views unless density_only) in all four
                      columns;
  encode_only="gates" a probe: each point's sum over the joints of v * w;
  bf16enc             the gate and each octave's sin / cos rounded to bf16,
                      each gated channel a bf16 x bf16 product rounded to
                      bf16; the other channels rounded once; feature and
                      x_views rounded before the view layer;
  mxenc               the joint transforms as one float32 product (in the
                      kernel, TF32 in three passes on the tensor cores);
  halves (bf16enc)    2: each consumer warpgroup's 64 rows pass to the
                      products as soon as it has encoded them (the function
                      of bf16enc); 4 is refused (32-row parts, and wgmma's M
                      is 64 rows).
skipsplit, viewsplit and bf16act pick how the TPU lays out its operands; at
bf16 matmul operands they change nothing. `variant_plain` models each flag's
rounding, bf16act's too (x_pts, every ReLU output and the feature rounded to
bf16), so at float32 matmuls it is JAX's `variant_field` at MM_DTYPE =
float32; at bf16 it is what the kernel computes. Both sides read bf16
weights (`prepare_net`). The wrapper runs the plain version, at float32,
only for tensors on the CPU; for a CUDA tensor it launches or raises.

The channel order is the port's joint-major one (JAX's is component-major);
no output, the probes' sums included, depends on it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from posegen_tpu_torch.kernels.field import (
    EVAL_TILE,
    LAUNCHES,
    N_JOINTS,
    POSE_FLOATS,
    FieldNet,
    NetLayout,
    _check_operands,
    _eval_launch_operands,
    _layout_arg,
    _no_grad_operands,
    _ptr,
    bf16_round,
    encode_plain,
    mlp_plain,
)

TILES = (EVAL_TILE,)  # points per tile: the eval kernel's
WGMMA_ROWS = 64  # wgmma's M: a consumer warpgroup's rows of the tile

EncodeOnly = Union[bool, str]

# (density_only, encode_only, encode, halves) of the variants the kernel is
# built for (csrc/field_variants.cu): the harness's cases and probes
BUILT = frozenset({
    (False, False, "base", 1), (True, False, "base", 1),
    (False, False, "bf16enc", 1), (False, False, "bf16enc", 2),
    (False, False, "mxenc", 1), (True, False, "mxenc", 1),
    (False, True, "base", 1), (False, "gates", "base", 1),
})


def encode_of(bf16enc: bool = False, mxenc: bool = False) -> str:
    """The encode a case runs: mxenc takes precedence over bf16enc."""
    return "mxenc" if mxenc else ("bf16enc" if bf16enc else "base")


def variant_refusal(layout: NetLayout, tile: int, skips: Sequence[int] = (4,),
                    encode_only: EncodeOnly = False, bf16enc: bool = False,
                    halves: int = 1, mxenc: bool = False,
                    density_only: bool = False) -> Optional[str]:
    """Why the variant kernel does not take these arguments, or None."""
    skips = tuple(skips)
    if len(skips) > 1:
        return f"skips={skips}: the kernels take one skip connection"
    if skips != ((layout.skip,) if layout.skip >= 0 else ()):
        return f"skips={skips} but the packed net's skip is {layout.skip}"
    if tile not in TILES:
        return (f"tile={tile}: the kernel runs the eval kernel's tile of {EVAL_TILE} points, two "
                f"consumer warpgroups of {WGMMA_ROWS} rows")
    if encode_only not in (False, True, "gates"):
        return f"encode_only={encode_only!r}: False, True or 'gates'"
    if halves not in (1, 2, 4):
        return f"halves={halves}: 1, 2 or 4"
    if halves > 1 and (not bf16enc or mxenc):
        return "halves > 1 requires bf16enc (and not mxenc)"
    if tile // halves < WGMMA_ROWS:
        return (f"tile={tile} / halves={halves}: parts of {tile // halves} rows, and wgmma's M is "
                f"{WGMMA_ROWS} rows")
    enc = encode_of(bf16enc, mxenc)
    if (density_only, encode_only, enc, halves) not in BUILT:
        return (f"density_only={density_only}, encode_only={encode_only!r}, {enc}, "
                f"halves={halves}: not built (the kernel instantiates the harness's cases and "
                "probes)")
    return None


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _to_joints(p: torch.Tensor, pose: torch.Tensor, with_t: bool, mx: bool):
    """(P, 3) world points (with_t: R p + t) or directions (R d) -> (X, Y, Z),
    each (P, 24), in the joint frames: elementwise, or with mx as one
    float32 product of [p | 1] (directions [d | 0]) and the (72, 4) rows
    [R_j row a | t_j[a]], as the kernel's tensor-core transform."""
    R = pose[:9 * N_JOINTS].view(N_JOINTS, 9)
    t = pose[9 * N_JOINTS:12 * N_JOINTS].view(N_JOINTS, 3)
    if mx:
        rt = torch.cat([torch.cat([R[:, 3 * a:3 * a + 3], t[:, a:a + 1]], 1) for a in range(3)])
        hom = torch.cat([p, p.new_full((p.shape[0], 1), float(with_t))], 1)
        return (hom @ rt.T).split(N_JOINTS, 1)
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    return tuple(R[:, 3 * a] * x + R[:, 3 * a + 1] * y + R[:, 3 * a + 2] * z
                 + (t[:, a] if with_t else 0.0) for a in range(3))


def _encode(pts, dirs, pose, nf_kp: int, nf_view: int, with_view: bool, bf16: bool,
            mx: bool):
    """encode_plain's channels on per-point dirs, the frames from
    `_to_joints(mx)`, with bf16enc's rounding when bf16 (each gated channel
    rnd(rnd(s) * rnd(w)), every other channel rounded once)."""
    X, Y, Z = _to_joints(pts, pose, True, mx)
    cut = pose[12 * N_JOINTS:13 * N_JOINTS]
    tau = pose[13 * N_JOINTS]
    sw = pose[POSE_FLOATS:POSE_FLOATS + nf_kp + nf_view]
    rnd = bf16_round if bf16 else (lambda a: a)
    P = pts.shape[0]

    v = torch.sqrt(X * X + Y * Y + Z * Z)
    w = 1.0 - torch.sigmoid(tau * (v - cut))
    inv_v = 1.0 / torch.clamp(v, min=1e-12)

    def ladder(q, wq, weights):
        rows, s, c = [], torch.sin(q), torch.cos(q)
        for f, sf in enumerate(weights):
            wf = rnd(wq * sf)
            rows += [rnd(rnd(s) * wf), rnd(rnd(c) * wf)]
            if f + 1 < len(weights):
                s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        return rows

    e_pts = torch.cat(
        [rnd(v * w), *ladder(v, w, sw[:nf_kp]),
         rnd(torch.stack([X * inv_v, Y * inv_v, Z * inv_v], -1).reshape(P, -1))], -1)
    if not with_view:
        return e_pts, None
    DX, DY, DZ = _to_joints(dirs, pose, False, mx)
    dn_inv = torch.rsqrt(torch.clamp(DX * DX + DY * DY + DZ * DZ, min=1e-24))
    q = torch.stack([DX * dn_inv, DY * dn_inv, DZ * dn_inv], -1)  # (P, 24, 3)
    wq = w[..., None]
    e_view = torch.stack([rnd(q * wq), *ladder(q, wq, sw[nf_kp:])], 1).reshape(P, -1)
    return e_pts, e_view


def encode_bf16_plain(pts, dirs, pose, nf_kp: int, nf_view: int, with_view: bool = True):
    """bf16enc's encode (tools/exp_kernel_variants.py::encode_bf16): the
    channels of `encode_plain` (per-point dirs), bf16 values in float32."""
    return _encode(pts, dirs, pose, nf_kp, nf_view, with_view, bf16=True, mx=False)


def encode_mx_plain(pts, dirs, pose, nf_kp: int, nf_view: int, with_view: bool = True):
    """mxenc's encode (tools/exp_kernel_variants.py::encode_mx): the joint
    transforms as one float32 product, the rest as `encode_plain`."""
    return _encode(pts, dirs, pose, nf_kp, nf_view, with_view, bf16=False, mx=True)


def encode_sum_plain(e_pts, e_view, mm_dtype: torch.dtype) -> torch.Tensor:
    """The encode probe: each point's sum of its channels as the MLP reads
    them (rounded to mm_dtype) -> (P,)."""
    s = e_pts.to(mm_dtype).float().sum(1)
    return s if e_view is None else s + e_view.to(mm_dtype).float().sum(1)


def gates_plain(pts, pose) -> torch.Tensor:
    """The gate probe: each point's sum over the joints of v * w -> (P,)."""
    X, Y, Z = _to_joints(pts, pose, True, mx=False)
    v = torch.sqrt(X * X + Y * Y + Z * Z)
    w = 1.0 - torch.sigmoid(pose[13 * N_JOINTS] * (v - pose[12 * N_JOINTS:13 * N_JOINTS]))
    return (v * w).sum(1)


def variant_plain(pts: torch.Tensor, dirs: torch.Tensor, poses: torch.Tensor, net: FieldNet,
                  *, density_only: bool = False, encode_only: EncodeOnly = False,
                  skipsplit: bool = False, bf16act: bool = False, viewsplit: bool = False,
                  bf16enc: bool = False, halves: int = 1, mxenc: bool = False,
                  mm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the variant kernel -> (P, 4). poses (G, n_pose):
    group g owns points [g P / G, (g + 1) P / G). skipsplit, viewsplit and
    halves do not change the function; mxenc takes precedence over bf16enc
    for the encode, as in the JAX kernel."""
    del skipsplit, viewsplit, halves
    L = net.layout
    G = poses.shape[0]
    ppg = pts.shape[0] // G
    with_view = not density_only
    outs = []
    for g in range(G):
        p, d, pose = pts[g * ppg:(g + 1) * ppg], dirs[g * ppg:(g + 1) * ppg], poses[g]
        if encode_only == "gates":
            outs.append(gates_plain(p, pose)[:, None].expand(-1, 4))
            continue
        if mxenc:
            e_pts, e_view = encode_mx_plain(p, d, pose, L.nf_kp, L.nf_view, with_view)
        elif bf16enc:
            e_pts, e_view = encode_bf16_plain(p, d, pose, L.nf_kp, L.nf_view, with_view)
        else:
            e_pts, e_view = encode_plain(p, d, 1, pose, L.nf_kp, L.nf_view, with_view)
        if encode_only:
            outs.append(encode_sum_plain(e_pts, e_view, mm_dtype)[:, None].expand(-1, 4))
            continue
        outs.append(mlp_plain(net, e_pts, e_view, density_only, mm_dtype, bf16act=bf16act,
                              bf16view=bf16enc))
    return torch.cat(outs).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def variant_field(pts: torch.Tensor, dirs: torch.Tensor, poses: torch.Tensor, net: FieldNet,
                  *, tile: int = EVAL_TILE, skips: Sequence[int] = (4,), density_only: bool = False,
                  encode_only: EncodeOnly = False, skipsplit: bool = False,
                  bf16act: bool = False, viewsplit: bool = False, bf16enc: bool = False,
                  halves: int = 1, mxenc: bool = False) -> torch.Tensor:
    """The variant field -> (P, 4): raw [r, g, b, sigma] (rgb zero when
    density_only) or a probe's per-point sum in every column. pts and dirs
    (P, 3) f32, one direction per point; poses (G, n_pose) from `pack_poses`,
    the points contiguous per group; net from `prepare_net`; tile: points
    per tile (TILES); skips as the JAX harness names them (the packed net's
    one skip)."""
    reason = variant_refusal(net.layout, tile, skips, encode_only, bf16enc, halves, mxenc,
                             density_only)
    if reason is not None:
        raise ValueError(f"variant_field: {reason}")
    if poses.dim() != 2 or poses.shape[0] < 1:
        raise ValueError(f"poses {tuple(poses.shape)} must be (G, n_pose)")
    _check_operands(pts, dirs, 1, poses[0], (net,))
    if pts.shape[0] % poses.shape[0]:
        raise ValueError(f"{pts.shape[0]} points do not split into {poses.shape[0]} pose groups")
    if pts.is_cuda and (poses.device != pts.device or not poses.is_contiguous()):
        raise ValueError(f"poses: need a contiguous float32 tensor on {pts.device}")
    _no_grad_operands("variant_field", pts, dirs, poses, net.w, net.b)
    flags = dict(density_only=density_only, encode_only=encode_only, skipsplit=skipsplit,
                 bf16act=bf16act, viewsplit=viewsplit, bf16enc=bf16enc, halves=halves,
                 mxenc=mxenc)
    if not pts.is_cuda:
        return variant_plain(pts, dirs, poses, net, **flags)
    from posegen_tpu_torch.kernels import build

    lib = build.load()
    out = torch.empty((pts.shape[0], 4), dtype=torch.float32, device=pts.device)
    if pts.shape[0] == 0:
        return out
    layout, n_layout = _layout_arg(net.layout)
    enc = ("base", "bf16enc", "mxenc").index(encode_of(bf16enc, mxenc))
    probe = 2 if encode_only == "gates" else int(bool(encode_only))
    with torch.cuda.device(pts.device):
        scratch, n_scratch = _eval_launch_operands("variant_field", net.layout, pts.device)
        rc = lib.posegen_field_variant(
            _ptr(pts), _ptr(dirs), pts.shape[0], _ptr(poses), poses.shape[0], poses.shape[1],
            layout, n_layout, _ptr(net.w), _ptr(net.b), _ptr(out), tile, int(density_only),
            enc, probe, halves, _ptr(scratch), n_scratch,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    build.check(lib, rc, "field variant")
    LAUNCHES["variant"] += 1
    return out
