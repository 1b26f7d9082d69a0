"""The trainable fused field: a forward that stashes its encodings, a
backward for the weights and, on request, for the inputs, plain versions,
wrappers and the autograd Function (port of
posegen_tpu/kernels/field_grad.py).

Two CUDA kernels (csrc/field_grad.cu) replace the two Pallas kernels of the
train step:

  fused_field_stash <- posegen_tpu/kernels/field_grad.py::_field_fwd_stash_kernel
                       (the field kernel's full forward on grouped poses,
                       plus e_pts (P, pc) and e_view (P, vc) bf16 written out)
  field_backward    <- posegen_tpu/kernels/field_grad.py::_field_bwd_kernel:
                       every weight and bias gradient summed over all points,
                       the view bias gradient per pose group; with `inputs`
                       (its input_grads branch, pose refinement) also the
                       input gradients d_pts, d_dirs and d_poses, through the
                       encoding's backward (`_encode_backward`)

Operands. Points are contiguous per pose group and per ray: with G pose
rows (`field.pack_poses`) point p belongs to group p // (P / G). The net is
`field.pack_net_f32`'s float32 packing; the kernels round the weights to
bf16 as they load them, and the plain versions round them only when
`mm_dtype` is bf16. The view layer's bias comes per group, (G, 128) with
framecodes (`field.group_view_bias` folds each group's code into it) or
(1, 128) without: its gradient carries the framecode chain rule back
through autograd on the host, so the kernels never see a code column.

A wrapper runs its plain version, at float32, only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from posegen_tpu_torch.kernels.field import (
    LAUNCHES,
    N_JOINTS,
    VIEW_WIDTH,
    WIDTH,
    FieldNet,
    NetLayout,
    POSE_FLOATS,
    SMEM_LIMIT,
    _layout_arg,
    _mm,
    _ptr,
    _unpack,
    body_smem_bytes,
    encode_plain,
    mlp_plain,
)


class FieldInputs(NamedTuple):
    """The operands of the forward that the input gradients need: pts (P, 3),
    dirs (P / spr, 3), spr samples per ray, poses (G, n_pose)."""

    pts: torch.Tensor
    dirs: torch.Tensor
    spr: int
    poses: torch.Tensor


def _view_bias_rows(bview: torch.Tensor, n_pts: int) -> torch.Tensor:
    """(Gb, 128) per-group view bias -> (128,) or per point (P, 128)."""
    if bview.shape[0] == 1:
        return bview[0]
    return bview.repeat_interleave(n_pts // bview.shape[0], dim=0)


def _check_operands(pts, dirs, spr: int, poses, net: FieldNet, bview) -> None:
    L = net.layout
    if pts.dim() != 2 or pts.shape[1] != 3 or dirs.dim() != 2 or dirs.shape[1] != 3:
        raise ValueError(f"pts {tuple(pts.shape)} / dirs {tuple(dirs.shape)} must be (*, 3)")
    P = pts.shape[0]
    if spr < 1 or P != dirs.shape[0] * spr:
        raise ValueError(f"{P} points != {dirs.shape[0]} rays x {spr} samples")
    n_pose = POSE_FLOATS + L.nf_kp + L.nf_view
    if poses.dim() != 2 or poses.shape[1] != n_pose or poses.shape[0] < 1:
        raise ValueError(f"poses {tuple(poses.shape)} != (G, {n_pose})")
    G = poses.shape[0]
    if P % G or (P // G) % spr:
        raise ValueError(f"{P} points do not split into {G} pose groups of whole rays")
    if bview.dim() != 2 or bview.shape[1] != VIEW_WIDTH or bview.shape[0] not in (1, G):
        raise ValueError(f"view bias {tuple(bview.shape)} != (1 or {G}, {VIEW_WIDTH})")
    if net.w.shape != (L.n_w,) or net.b.shape != (L.n_b,):
        raise ValueError("packed net does not match its layout")
    if not pts.is_cuda:
        return
    for name, t in (("pts", pts), ("dirs", dirs), ("poses", poses), ("weights", net.w),
                    ("biases", net.b), ("view bias", bview)):
        if t.device != pts.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on {pts.device}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def field_stash_plain(pts, dirs, spr: int, poses, net: FieldNet, bview,
                      mm_dtype: torch.dtype = torch.float32):
    """Plain version of the stash kernel -> (raw (P, 4), e_pts (P, pc),
    e_view (P, vc)), the stashes in mm_dtype. The raw is `field_plain`'s on
    each group's pose and view bias."""
    L = net.layout
    P, G = pts.shape[0], poses.shape[0]
    ppg = P // G
    parts = [encode_plain(pts[g * ppg:(g + 1) * ppg],
                          dirs[g * ppg // spr:(g + 1) * ppg // spr], spr, poses[g],
                          L.nf_kp, L.nf_view) for g in range(G)]
    e_pts = torch.cat([p[0] for p in parts])
    e_view = torch.cat([p[1] for p in parts])
    raw = mlp_plain(net, e_pts, e_view, False, mm_dtype, bview=_view_bias_rows(bview, P))
    return raw, e_pts.to(mm_dtype), e_view.to(mm_dtype)


def _bwd_forward_backward(e_pts, e_view, g, net: FieldNet, bview, mm_dtype: torch.dtype):
    """The recompute and the backprop of `field_bwd_plain`, in float32: the
    trunk's layer outputs and pre-activations, feat, hv, and every layer's
    pre-activation cotangent (operands of each product rounded to mm_dtype)."""
    L = net.layout
    P = e_pts.shape[0]
    layers, (wa, _), (wf, bf), (wv, _), (wr, _) = _unpack(net)

    def mm(a, w):  # a (P, in) @ w (out, in)^T
        return _mm(a, w, mm_dtype)

    def tn(gg, w):  # (P, out) @ w (out, in) -> (P, in): an input cotangent
        return gg.to(mm_dtype).float() @ w.to(mm_dtype).float()

    e_pts, e_view = e_pts.float(), e_view.float()
    h, hs, pres = e_pts, [], []
    for i, (w, b) in enumerate(layers):
        if i > 0 and i - 1 == L.skip:
            z = mm(e_pts, w[:, :L.pc]) + mm(h, w[:, L.pc:]) + b
        else:
            z = mm(h, w) + b
        pres.append(z)
        h = torch.relu(z)
        hs.append(h)
    feat = mm(h, wf) + bf
    zv = (mm(feat, wv[:, :WIDTH]) + mm(e_view, wv[:, WIDTH:WIDTH + L.vc])
          + _view_bias_rows(bview, P))
    hv = torch.relu(zv)

    g = g.float()
    g_zv = torch.where(zv > 0, tn(g[:, :3], wr), 0.0)
    g_feat = tn(g_zv, wv[:, :WIDTH])
    g_h = tn(g_feat, wf) + tn(g[:, 3:4], wa)
    gz = [None] * L.depth
    for i in reversed(range(L.depth)):
        gz[i] = torch.where(pres[i] > 0, g_h, 0.0)
        if i > 0:
            w = layers[i][0]
            g_h = tn(gz[i], w[:, L.pc:] if i - 1 == L.skip else w)
    return hs, feat, hv, gz, g_feat, g_zv, g


def field_bwd_workspace_plain(e_pts, e_view, g, net: FieldNet, bview,
                              mm_dtype: torch.dtype = torch.float32):
    """Plain version of the backward kernel's pass (a): what it writes to
    its workspace, as the kernel lays it out, rounded to mm_dtype (P rows):
    hs (depth, P, 256) each trunk layer's output after its ReLU, feat
    (P, 256), hv (P, 128) the view layer's output after its ReLU, gz (depth,
    P, 256) each trunk layer's pre-activation cotangent, gfeat (P, 256) the
    feature layer's cotangent, gzv (P, 128) the view layer's pre-activation
    cotangent, ghead (P, 16) [g_alpha | g_r g_g g_b | 0 ...]; and, summed
    from the float32 cotangents as the kernel's f32 partials are, d_b (n_b,)
    (the view bias slot zero) and d_bview (Gb, 128) per view-bias group."""
    L = net.layout
    P = e_pts.shape[0]
    hs, feat, hv, gz, g_feat, g_zv, g = _bwd_forward_backward(e_pts, e_view, g, net, bview,
                                                              mm_dtype)
    d_b = g.new_zeros(L.n_b)
    for i in range(L.depth):
        d_b[L.b_layers[i]:L.b_layers[i] + WIDTH] = gz[i].sum(0)
    d_b[L.b_feat:L.b_feat + WIDTH] = g_feat.sum(0)
    d_b[L.b_alpha:L.b_alpha + 1] = g[:, 3:4].sum(0)
    d_b[L.b_rgb:L.b_rgb + 3] = g[:, :3].sum(0)
    ghead = g.new_zeros(P, 16)
    ghead[:, 0] = g[:, 3]
    ghead[:, 1:4] = g[:, :3]
    return {
        "hs": torch.stack(hs).to(mm_dtype), "feat": feat.to(mm_dtype), "hv": hv.to(mm_dtype),
        "gz": torch.stack(gz).to(mm_dtype), "gfeat": g_feat.to(mm_dtype),
        "gzv": g_zv.to(mm_dtype), "ghead": ghead.to(mm_dtype),
        "d_b": d_b, "d_bview": g_zv.reshape(bview.shape[0], -1, VIEW_WIDTH).sum(1),
    }


def wgrad_products(ws, e_pts, e_view, layout: NetLayout):
    """The backward kernel's pass (b) products, (name, G (P, out), H (P, in),
    weight offset, row stride of its matrix): each weight gradient is
    G^T H over the points, read from the workspace
    `ws` (`field_bwd_workspace_plain`'s dict, or the kernel's own regions)
    and the stashes."""
    L = layout
    hs, gz = ws["hs"], ws["gz"]
    out = []
    for i in range(L.depth):
        ldo = L.layer_in(i)
        if i == 0:
            out.append((f"layer{i}", gz[i], e_pts, L.w_layers[i], ldo))
        elif i - 1 == L.skip:
            out.append((f"layer{i}.e_pts", gz[i], e_pts, L.w_layers[i], ldo))
            out.append((f"layer{i}.h", gz[i], hs[i - 1], L.w_layers[i] + L.pc, ldo))
        else:
            out.append((f"layer{i}", gz[i], hs[i - 1], L.w_layers[i], ldo))
    ldv = WIDTH + L.vcp
    return out + [
        ("feature", ws["gfeat"], hs[L.depth - 1], L.w_feat, WIDTH),
        ("view.feat", ws["gzv"], ws["feat"], L.w_view, ldv),
        ("view.e_view", ws["gzv"], e_view, L.w_view + WIDTH, ldv),
        ("alpha", ws["ghead"][:, 0:1], hs[L.depth - 1], L.w_alpha, WIDTH),
        ("rgb", ws["ghead"][:, 1:4], ws["hv"], L.w_rgb, VIEW_WIDTH),
    ]


def field_wgrad_plain(ws, e_pts, e_view, layout: NetLayout) -> torch.Tensor:
    """Plain version of the backward kernel's pass (b): every weight
    gradient G^T H of `wgrad_products`, float32 products of the workspace's
    values, into (n_w,) in the packed layout (the view head's pad columns
    zero)."""
    d_w = e_pts.new_zeros(layout.n_w, dtype=torch.float32)
    for _, gg, x, off, ldo in wgrad_products(ws, e_pts, e_view, layout):
        prod = gg.float().T @ x.float()
        d_w.as_strided(prod.shape, (ldo, 1), off).copy_(prod)
    return d_w


def field_bwd_plain(e_pts, e_view, g, net: FieldNet, bview,
                    mm_dtype: torch.dtype = torch.float32, input_grads: bool = False):
    """Plain version of the backward kernel, step by step (not autograd):
    pass (a), `field_bwd_workspace_plain` (recompute the trunk and heads from
    the stashed encodings, backprop the (P, 4) output cotangent g through the
    rgb, view, feature and alpha heads and the trunk, the skip layer's two
    column segments), then pass (b), `field_wgrad_plain` (every weight
    gradient summed over the points). The operands of every product round to
    mm_dtype, as the JAX kernel's _mm_nt / _mm_tn do; bias sums run on the
    float32 cotangents.

    -> (d_w (n_w,), d_b (n_b,), d_bview (Gb, 128)) float32 in the packed
    layout; the view bias slot of d_b and the view head's pad columns stay
    zero (the view bias gradient is d_bview, per group). input_grads adds
    the encodings' cotangents (g_e_pts (P, pc), g_e_view (P, vc)): layer
    0's and the skip consumer's pre-activation cotangents through their
    e_pts columns, and the view layer's through its e_view columns."""
    L = net.layout
    ws = field_bwd_workspace_plain(e_pts, e_view, g, net, bview, mm_dtype)
    d_w = field_wgrad_plain(ws, e_pts.to(mm_dtype), e_view.to(mm_dtype), L)
    if not input_grads:
        return d_w, ws["d_b"], ws["d_bview"]
    layers, _, _, (wv, _), _ = _unpack(net)

    def tn(gg, w):
        return gg.to(mm_dtype).float() @ w.to(mm_dtype).float()

    g_e_pts = tn(ws["gz"][0], layers[0][0])
    if L.skip >= 0:
        g_e_pts = g_e_pts + tn(ws["gz"][L.skip + 1], layers[L.skip + 1][0][:, :L.pc])
    return d_w, ws["d_b"], ws["d_bview"], g_e_pts, tn(ws["gzv"], wv[:, WIDTH:WIDTH + L.vc])


def encode_bwd_plain(pts, dirs, spr: int, poses, g_e_pts, g_e_view, nf_kp: int,
                     nf_view: int):
    """Plain version of the input gradients' encode backward (the JAX
    kernel's `_encode_backward`, step by step, not autograd), in float32,
    in the port's joint-major channel order (see `encode_plain`): the
    encodings' cotangents g_e_pts (P, pc), g_e_view (P, vc) back through the
    octave ladders (the forward's double-angle values reused as sin and cos
    of each octave, each octave's cotangent scaled by its BARF weight), the
    reldir rows (zero slope of 1 / max(v, 1e-12) in its clamp), the gate
    w = 1 - sigmoid(tau (v - cut)), the normalised view direction and the
    joint frames.

    -> (d_pts (P, 3), d_dirs (P / spr, 3) summed over each ray's samples in
    order, d_poses (G, n_pose): per pose group the rot (24 x 9) and trn
    (24 x 3) slots summed over the group's points; the cut, tau and octave
    weight slots zero, as the JAX kernel gives no gradient to them)."""
    P, G = pts.shape[0], poses.shape[0]
    J = N_JOINTS
    pose = poses.float().repeat_interleave(P // G, dim=0)  # (P, n_pose)
    R = pose[:, :9 * J].view(P, J, 9)
    t = pose[:, 9 * J:12 * J].view(P, J, 3)
    cut, tau = pose[:, 12 * J:13 * J], pose[:, 13 * J:13 * J + 1]
    sw_kp = pose[:, POSE_FLOATS:POSE_FLOATS + nf_kp]
    sw_view = pose[:, POSE_FLOATS + nf_kp:POSE_FLOATS + nf_kp + nf_view]
    x = pts.float()
    d = dirs.float().repeat_interleave(spr, dim=0)
    g_ep, g_ev = g_e_pts.float(), g_e_view.float()

    def frame(u):  # (P, 3) -> three (P, 24): rows of R_j @ u
        return [(R[..., 3 * r:3 * r + 3] * u[:, None, :]).sum(-1) for r in range(3)]

    X, Y, Z = (a + t[..., r] for r, a in enumerate(frame(x)))
    v = torch.sqrt(X * X + Y * Y + Z * Z)
    sig = torch.sigmoid(tau * (v - cut))
    w = 1.0 - sig
    inv_v = 1.0 / torch.clamp(v, min=1e-12)

    # kp rows: [v w | per octave sin(2^f v) w sw_f, cos(2^f v) w sw_f]
    G0 = g_ep[:, :J]
    g_v, g_w = G0 * w, G0 * v
    s, c = torch.sin(v), torch.cos(v)
    for f in range(nf_kp):
        Gs = g_ep[:, J * (1 + 2 * f):J * (2 + 2 * f)] * sw_kp[:, f:f + 1]
        Gc = g_ep[:, J * (2 + 2 * f):J * (3 + 2 * f)] * sw_kp[:, f:f + 1]
        g_v = g_v + (Gs * c - Gc * s) * (2.0**f * w)
        g_w = g_w + Gs * s + Gc * c
        if f + 1 < nf_kp:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    # reldir rows (j, xyz): [X, Y, Z] / max(v, 1e-12), ungated
    Gd = g_ep[:, J * (1 + 2 * nf_kp):].view(P, J, 3)
    g_X, g_Y, g_Z = Gd[..., 0] * inv_v, Gd[..., 1] * inv_v, Gd[..., 2] * inv_v
    g_inv = Gd[..., 0] * X + Gd[..., 1] * Y + Gd[..., 2] * Z
    g_v = g_v - g_inv * inv_v * inv_v * (v > 1e-12)

    # view rows, each block (j, xyz): [dn w | per octave sin, cos (2^f dn) w sw_f]
    D = torch.stack(frame(d), -1)  # (P, 24, 3)
    dn_inv = torch.rsqrt(torch.clamp((D * D).sum(-1), min=1e-24))
    q = D * dn_inv[..., None]
    wq = w[..., None]
    H0 = g_ev[:, :3 * J].view(P, J, 3)
    g_dn = H0 * wq
    g_w = g_w + (H0 * q).sum(-1)
    sq, cq = torch.sin(q), torch.cos(q)
    for f in range(nf_view):
        Hs = g_ev[:, 3 * J * (1 + 2 * f):3 * J * (2 + 2 * f)].view(P, J, 3)
        Hc = g_ev[:, 3 * J * (2 + 2 * f):3 * J * (3 + 2 * f)].view(P, J, 3)
        Hs, Hc = Hs * sw_view[:, f, None, None], Hc * sw_view[:, f, None, None]
        g_dn = g_dn + (Hs * cq - Hc * sq) * (2.0**f * wq)
        g_w = g_w + (Hs * sq + Hc * cq).sum(-1)
        if f + 1 < nf_view:
            sq, cq = 2.0 * sq * cq, 1.0 - 2.0 * sq * sq

    g_v = g_v + g_w * (-tau * sig * (1.0 - sig))  # the gate
    g_loc = torch.stack([g_X + g_v * X * inv_v, g_Y + g_v * Y * inv_v,
                         g_Z + g_v * Z * inv_v], -1)  # (P, 24, 3): through v = |p_local|
    dot = (g_dn * D).sum(-1, keepdim=True)
    g_D = g_dn * dn_inv[..., None] - D * dn_inv[..., None] ** 3 * dot

    Rm = R.view(P, J, 3, 3)
    d_pts = (Rm * g_loc[..., None]).sum((1, 2))  # sum_j R_j^T g_loc_j
    d_dirs = (Rm * g_D[..., None]).sum((1, 2)).view(-1, spr, 3).sum(1)
    d_rot = g_loc[..., None] * x[:, None, None, :] + g_D[..., None] * d[:, None, None, :]
    d_poses = poses.new_zeros(poses.shape, dtype=torch.float32)
    d_poses[:, :9 * J] = d_rot.reshape(G, P // G, 9 * J).sum(1)
    d_poses[:, 9 * J:12 * J] = g_loc.reshape(G, P // G, 3 * J).sum(1)
    return d_pts, d_dirs, d_poses


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# The stash kernel's plan (csrc/field_grad.cu): field.cuh's WMMA body at 64
# points per block, with the view encodings.
STASH_TILE = 64


def stash_smem_bytes(layout: NetLayout) -> int:
    """The stash kernel's dynamic shared memory (csrc/field_grad.cu
    posegen_field_stash_smem: `field.body_smem_bytes` at tile 64 with the
    view encodings): 184,832 bytes at the flagship; it grows with multires
    and multires_views."""
    return body_smem_bytes(layout, STASH_TILE, True)


def field_stash_refusal(layout: NetLayout) -> Optional[str]:
    """Why the stash kernel does not take this layout, or None: its 64
    points' encodings and activations must fit one block's shared memory
    (240,128 bytes at multires 7 / multires_views 7 and 233,984 at 15 / 4 do
    not)."""
    need = stash_smem_bytes(layout)
    if need > SMEM_LIMIT:
        return (f"multires={layout.nf_kp}, multires_views={layout.nf_view}: the stash kernel "
                f"needs {need} bytes of shared memory ({STASH_TILE} points' encodings and "
                f"activations), more than the {SMEM_LIMIT} an H100 block can take")
    return None


def train_refusal(layout: NetLayout) -> Optional[str]:
    """Why the training kernels (the stash kernel and the backward) do not
    take this layout, or None."""
    return field_stash_refusal(layout) or field_bwd_refusal(layout)


# Kernel 4's plan on Hopper (csrc/field_grad.cu): pass (a) runs 128 points
# per block, its weights through a ring of 3 stages (2 past depth 8); pass
# (b) sums dW over a fixed split of the points.
A_TILE = 128  # points per block of pass (a)
MASK_LAYER_BYTES = 4096  # pass (a)'s ReLU mask bits of one layer
WGRAD_MAX_SPLITS = 16
WGRAD_CHUNK = 64  # points per staged step of pass (b)


def _bwd_plan_bytes(layout: NetLayout, w_stages: int) -> int:
    return (1024 + 4 * A_TILE * 128 + w_stages * 32768 + 2 * 16384
            + layout.depth * MASK_LAYER_BYTES + 2 * (w_stages + 2) * 8)


def bwd_w_stages(layout: NetLayout) -> int:
    """Pass (a)'s weight ring stages (csrc/field_grad.cu bwd_w_stages)."""
    return 3 if _bwd_plan_bytes(layout, 3) <= SMEM_LIMIT else 2


def bwd_smem_bytes(layout: NetLayout) -> int:
    """Pass (a)'s dynamic shared memory (csrc/field_grad.cu bwd_smem_bytes):
    1,024 alignment slack, the 128 x 256 bf16 tile (65,536), the weight ring
    (32,768 a stage), the encoding ring (2 x 16,384; in the backward also
    the column-sum scratch and the output cotangent), one 4,096-byte ReLU
    mask per trunk layer and the rings' mbarriers: 230,480 at depth 8."""
    return _bwd_plan_bytes(layout, bwd_w_stages(layout))


def field_bwd_refusal(layout: NetLayout) -> Optional[str]:
    """Why the backward kernel does not take this layout, or None: its pass
    (a) plan must fit one block's shared memory (every layout `net_layout`
    builds does; its row strides are whole 16-byte TMA strides too)."""
    need = bwd_smem_bytes(layout)
    if need > SMEM_LIMIT:
        return (f"netdepth={layout.depth}: the backward's pass (a) needs {need} bytes of shared "
                f"memory ({MASK_LAYER_BYTES} of ReLU mask bits per layer), more than the "
                f"{SMEM_LIMIT} an H100 block can take")
    return None


def wgrad_split_plan(n_pts: int) -> Tuple[int, int]:
    """Pass (b)'s split of the point axis (csrc/field_grad.cu splits_of,
    chunk_of) -> (splits, chunk): split s sums points [s chunk, min(n_pts,
    (s + 1) chunk)), chunk a whole number of 64-point steps; the reduce adds
    the splits' partial products in split order."""
    splits = max(1, min(WGRAD_MAX_SPLITS, n_pts // 2048))
    chunk = -(-(-(-n_pts // splits)) // WGRAD_CHUNK) * WGRAD_CHUNK
    return splits, chunk


def _bf16_weights(net: FieldNet) -> torch.Tensor:
    """The kernels' bf16 copy of the float32 packed weights."""
    return net.w.detach().to(torch.bfloat16).contiguous()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def fused_field_stash(pts: torch.Tensor, dirs: torch.Tensor, spr: int,
                      poses: torch.Tensor, net: FieldNet, bview: torch.Tensor):
    """Fused encode + MLP on grouped poses -> (raw (P, 4) f32, e_pts (P, pc),
    e_view (P, vc)), the stashes bf16 on CUDA (float32 on the CPU). pts
    (P, 3); dirs (P / spr, 3); poses (G, n_pose) from `pack_poses`; net
    from `pack_net_f32`; bview (1 or G, 128) from `group_view_bias`."""
    _check_operands(pts, dirs, spr, poses, net, bview)
    if not pts.is_cuda:
        return field_stash_plain(pts, dirs, spr, poses, net, bview)
    from posegen_tpu_torch.kernels import build

    L = net.layout
    reason = field_stash_refusal(L)
    if reason is not None:
        raise ValueError(f"field_stash: {reason}")
    P, G, Gb = pts.shape[0], poses.shape[0], bview.shape[0]
    dev = pts.device
    raw = torch.empty((P, 4), dtype=torch.float32, device=dev)
    e_pts = torch.empty((P, L.pc), dtype=torch.bfloat16, device=dev)
    e_view = torch.empty((P, L.vc), dtype=torch.bfloat16, device=dev)
    if P == 0:
        return raw, e_pts, e_view
    lib = build.load()
    w16 = _bf16_weights(net)
    layout, n_layout = _layout_arg(L)
    with torch.cuda.device(dev):
        rc = lib.posegen_field_stash(
            _ptr(pts), _ptr(dirs), P, spr, _ptr(poses), poses.shape[1], P // G, layout,
            n_layout, _ptr(w16), _ptr(net.b), _ptr(bview), Gb, P // Gb, _ptr(raw),
            _ptr(e_pts), _ptr(e_view), _stream(),
        )
    build.check(lib, rc, "field_stash")
    LAUNCHES["field_stash"] += 1
    return raw, e_pts, e_view


class BwdWorkspace(NamedTuple):
    """The backward kernel's workspace on the card: its bytes and the
    regions pass (a) writes, as views of P rows in the layout of
    `field_bwd_workspace_plain`, bf16 (hs, feat, hv, gz, gfeat, gzv,
    ghead)."""

    buf: torch.Tensor
    regions: Dict[str, torch.Tensor]


def bwd_workspace(n_pts: int, layout: NetLayout, n_vgroups: int, ppg: int,
                  device) -> BwdWorkspace:
    """A workspace for `field_backward` on n_pts points of a CUDA device,
    its view bias in n_vgroups groups; ppg > 0 (points per pose group) sizes
    it for the input gradients too."""
    from posegen_tpu_torch.kernels import build

    lib = build.load()
    off = (ctypes.c_longlong * 9)()
    n_ws = lib.posegen_field_bwd_workspace(n_pts, *_layout_arg(layout), n_vgroups,
                                           n_pts // max(n_vgroups, 1), ppg, off)
    if n_ws <= 0:
        raise ValueError(f"field_bwd: no workspace for {n_pts} points, {n_vgroups} view groups")
    buf = torch.empty(n_ws, dtype=torch.uint8, device=device)
    p_pad = off[0]

    def region(k, *shape):
        n = 2 * p_pad * (shape[0] if len(shape) == 2 else 1) * shape[-1]
        return buf[off[k]:off[k] + n].view(torch.bfloat16).view(*shape[:-1], p_pad, shape[-1])

    D, P = layout.depth, n_pts
    return BwdWorkspace(buf, {
        "hs": region(1, D, WIDTH)[:, :P], "feat": region(2, WIDTH)[:P],
        "hv": region(3, VIEW_WIDTH)[:P], "gz": region(4, D, WIDTH)[:, :P],
        "gfeat": region(5, WIDTH)[:P], "gzv": region(6, VIEW_WIDTH)[:P],
        "ghead": region(7, 16)[:P]})


def field_backward(g: torch.Tensor, e_pts: torch.Tensor, e_view: torch.Tensor,
                   net: FieldNet, bview: torch.Tensor, inputs: Optional[FieldInputs] = None,
                   workspace: Optional[BwdWorkspace] = None):
    """Backward of one net from the stash -> (d_w (n_w,), d_b (n_b,),
    d_bview (Gb, 128)) float32 (see `field_bwd_plain`). g is the (P, 4)
    output cotangent. With `inputs` (the forward's pts, dirs, spr and poses)
    it runs the input-gradient branch too and returns (d_w, d_b, d_bview,
    d_pts (P, 3), d_dirs (P / spr, 3), d_poses (G, n_pose)) (see
    `encode_bwd_plain`); the weight gradients are the same either way. On
    CUDA every gradient is bit-identical from launch to launch; a layout the
    kernel does not take raises (`field_bwd_refusal`). `workspace` (CUDA
    only, from `bwd_workspace`) is the kernel's scratch, in which pass (a)'s
    regions are left for the caller; a new one is made when None."""
    L = net.layout
    P = e_pts.shape[0]
    if (g.shape != (P, 4) or e_pts.shape != (P, L.pc) or e_view.shape != (P, L.vc)
            or bview.dim() != 2 or bview.shape[1] != VIEW_WIDTH
            or P % bview.shape[0]):
        raise ValueError(f"backward operands: g {tuple(g.shape)}, e_pts {tuple(e_pts.shape)}, "
                         f"e_view {tuple(e_view.shape)}, view bias {tuple(bview.shape)}")
    if inputs is not None:
        if inputs.pts.shape[0] != P:
            raise ValueError(f"inputs: {inputs.pts.shape[0]} points, stash {P}")
        _check_operands(inputs.pts, inputs.dirs, inputs.spr, inputs.poses, net, bview)
    if not g.is_cuda:
        if workspace is not None:
            raise ValueError("workspace: the kernel's, for CUDA tensors only")
        if inputs is None:
            return field_bwd_plain(e_pts, e_view, g, net, bview)
        *grads, g_ep, g_ev = field_bwd_plain(e_pts, e_view, g, net, bview, input_grads=True)
        return (*grads, *encode_bwd_plain(inputs.pts, inputs.dirs, inputs.spr, inputs.poses,
                                          g_ep, g_ev, L.nf_kp, L.nf_view))
    from posegen_tpu_torch.kernels import build

    dev = g.device
    for name, t, dt in (("g", g, torch.float32), ("e_pts", e_pts, torch.bfloat16),
                        ("e_view", e_view, torch.bfloat16), ("weights", net.w, torch.float32),
                        ("biases", net.b, torch.float32), ("view bias", bview, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}")
    reason = field_bwd_refusal(L)
    if reason is not None:
        raise ValueError(f"field_bwd: {reason}")
    Gb = bview.shape[0]
    d_w = torch.zeros(L.n_w, dtype=torch.float32, device=dev)
    d_b = torch.zeros(L.n_b, dtype=torch.float32, device=dev)
    d_bview = torch.zeros((Gb, VIEW_WIDTH), dtype=torch.float32, device=dev)
    ins = ()
    if inputs is not None:
        pts, dirs, spr, poses = inputs
        ins = (torch.empty((P, 3), dtype=torch.float32, device=dev),
               torch.empty((dirs.shape[0], 3), dtype=torch.float32, device=dev),
               torch.zeros(poses.shape, dtype=torch.float32, device=dev))
    if P == 0:
        return (d_w, d_b, d_bview, *ins)
    ppg = P // inputs.poses.shape[0] if inputs is not None else 0
    if workspace is None:
        workspace = bwd_workspace(P, L, Gb, ppg, dev)
    lib = build.load()
    layout, n_layout = _layout_arg(L)
    w16 = _bf16_weights(net)
    null = ctypes.c_void_p(None)
    if inputs is None:
        in_args = (null, null, 0, null, 0, 0, null, null, null)
    else:
        in_args = (_ptr(pts), _ptr(dirs), spr, _ptr(poses), poses.shape[1], ppg,
                   *(_ptr(t) for t in ins))
    buf = workspace.buf
    with torch.cuda.device(dev):
        rc = lib.posegen_field_bwd(
            P, layout, n_layout, _ptr(w16), _ptr(net.b), _ptr(bview), Gb, P // Gb, _ptr(g),
            _ptr(e_pts), _ptr(e_view), _ptr(buf), buf.numel(), _ptr(d_w), _ptr(d_b),
            _ptr(d_bview), *in_args, _stream(),
        )
    build.check(lib, rc, "field_bwd")
    LAUNCHES["field_bwd"] += 1
    if inputs is not None:
        LAUNCHES["field_bwd_inputs"] += 1
    return (d_w, d_b, d_bview, *ins)


class TrainableField(torch.autograd.Function):
    """raw (P, 4) of one net with gradients for its packed float32 weights,
    biases and per-group view bias, and, where autograd asks for them, for
    pts, dirs and the pose rows: the stash kernel forward, the backward
    kernel backward (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, pts, dirs, poses, w, b, bview, spr: int, layout: NetLayout):
        net = FieldNet(w, b, layout)
        raw, e_pts, e_view = fused_field_stash(pts, dirs, spr, poses, net, bview)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(w, b, bview, e_pts, e_view, pts, dirs, poses)
        else:
            ctx.save_for_backward(w, b, bview, e_pts, e_view)
        ctx.layout, ctx.spr = layout, spr
        return raw

    @staticmethod
    def backward(ctx, g):
        w, b, bview, e_pts, e_view, *ins = ctx.saved_tensors
        net = FieldNet(w, b, ctx.layout)
        if not ins:
            d_w, d_b, d_bview = field_backward(g.contiguous(), e_pts, e_view, net, bview)
            return None, None, None, d_w, d_b, d_bview, None, None
        pts, dirs, poses = ins
        d_w, d_b, d_bview, d_pts, d_dirs, d_poses = field_backward(
            g.contiguous(), e_pts, e_view, net, bview, FieldInputs(pts, dirs, ctx.spr, poses))
        need = ctx.needs_input_grad
        return (d_pts if need[0] else None, d_dirs if need[1] else None,
                d_poses if need[2] else None, d_w, d_b, d_bview, None, None)


def trainable_field(pts: torch.Tensor, dirs: torch.Tensor, spr: int, poses: torch.Tensor,
                    net: FieldNet, bview: torch.Tensor) -> torch.Tensor:
    """raw (P, 4) through `TrainableField` (see `fused_field_stash`)."""
    return TrainableField.apply(pts, dirs, poses, net.w, net.b, bview, spr, net.layout)
