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
from typing import NamedTuple, Optional

import torch

from posegen_tpu_torch.kernels.field import (
    LAUNCHES,
    N_JOINTS,
    VIEW_WIDTH,
    WIDTH,
    FieldNet,
    NetLayout,
    POSE_FLOATS,
    _layout_arg,
    _mm,
    _ptr,
    _unpack,
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


def field_bwd_plain(e_pts, e_view, g, net: FieldNet, bview,
                    mm_dtype: torch.dtype = torch.float32, input_grads: bool = False):
    """Plain version of the backward kernel, step by step (not autograd):
    recompute the trunk and heads from the stashed encodings, backprop the
    (P, 4) output cotangent g through the rgb, view, feature and alpha heads
    and the trunk (the skip layer's two column segments), and sum every
    weight and bias gradient over the points. The operands of every product
    round to mm_dtype, as the JAX kernel's _mm_nt / _mm_tn do; bias sums run
    on the float32 cotangents.

    -> (d_w (n_w,), d_b (n_b,), d_bview (Gb, 128)) float32 in the packed
    layout; the view bias slot of d_b and the view head's pad columns stay
    zero (the view bias gradient is d_bview, per group). input_grads adds
    the encodings' cotangents (g_e_pts (P, pc), g_e_view (P, vc)): layer
    0's and the skip consumer's pre-activation cotangents through their
    e_pts columns, and the view layer's through its e_view columns."""
    L = net.layout
    P = e_pts.shape[0]
    layers, (wa, _), (wf, bf), (wv, _), (wr, _) = _unpack(net)

    def mm(a, w):  # a (P, in) @ w (out, in)^T
        return _mm(a, w, mm_dtype)

    def nt(gg, x):  # (P, out)^T @ (P, in) -> (out, in): a weight gradient
        return gg.to(mm_dtype).float().T @ x.to(mm_dtype).float()

    def tn(gg, w):  # (P, out) @ w (out, in) -> (P, in): an input cotangent
        return gg.to(mm_dtype).float() @ w.to(mm_dtype).float()

    # forward recompute, keeping each layer's input and pre-activation
    e_pts, e_view = e_pts.float(), e_view.float()
    h, inputs, pres = e_pts, [], []
    for i, (w, b) in enumerate(layers):
        inputs.append(h)
        if i > 0 and i - 1 == L.skip:
            z = mm(e_pts, w[:, :L.pc]) + mm(h, w[:, L.pc:]) + b
        else:
            z = mm(h, w) + b
        pres.append(z)
        h = torch.relu(z)
    feat = mm(h, wf) + bf
    zv = (mm(feat, wv[:, :WIDTH]) + mm(e_view, wv[:, WIDTH:WIDTH + L.vc])
          + _view_bias_rows(bview, P))
    hv = torch.relu(zv)

    d_w = e_pts.new_zeros(L.n_w)
    d_b = e_pts.new_zeros(L.n_b)

    def put(off, grad):
        d_w[off:off + grad.numel()] = grad.reshape(-1)

    g = g.float()
    g_rgb, g_alpha = g[:, :3], g[:, 3:4]
    put(L.w_rgb, nt(g_rgb, hv))
    d_b[L.b_rgb:L.b_rgb + 3] = g_rgb.sum(0)
    g_zv = torch.where(zv > 0, tn(g_rgb, wr), 0.0)
    d_wv = e_pts.new_zeros(VIEW_WIDTH, WIDTH + L.vcp)
    d_wv[:, :WIDTH] = nt(g_zv, feat)
    d_wv[:, WIDTH:WIDTH + L.vc] = nt(g_zv, e_view)
    put(L.w_view, d_wv)
    d_bview = g_zv.reshape(bview.shape[0], -1, VIEW_WIDTH).sum(1)
    g_feat = tn(g_zv, wv[:, :WIDTH])
    put(L.w_feat, nt(g_feat, h))
    d_b[L.b_feat:L.b_feat + WIDTH] = g_feat.sum(0)
    put(L.w_alpha, nt(g_alpha, h))
    d_b[L.b_alpha:L.b_alpha + 1] = g_alpha.sum(0)
    g_h = tn(g_feat, wf) + tn(g_alpha, wa)

    g_e_pts = None
    for i in reversed(range(L.depth)):
        w = layers[i][0]
        g_z = torch.where(pres[i] > 0, g_h, 0.0)
        d_b[L.b_layers[i]:L.b_layers[i] + WIDTH] = g_z.sum(0)
        if i > 0 and i - 1 == L.skip:
            put(L.w_layers[i], torch.cat([nt(g_z, e_pts), nt(g_z, inputs[i])], 1))
            g_h = tn(g_z, w[:, L.pc:])
            if input_grads:
                g_e_pts = tn(g_z, w[:, :L.pc])
        else:
            put(L.w_layers[i], nt(g_z, inputs[i]))
            if i > 0:
                g_h = tn(g_z, w)
            elif input_grads:
                g0 = tn(g_z, w)
                g_e_pts = g0 if g_e_pts is None else g0 + g_e_pts
    if not input_grads:
        return d_w, d_b, d_bview
    return d_w, d_b, d_bview, g_e_pts, tn(g_zv, wv[:, WIDTH:WIDTH + L.vc])


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


def field_backward(g: torch.Tensor, e_pts: torch.Tensor, e_view: torch.Tensor,
                   net: FieldNet, bview: torch.Tensor, inputs: Optional[FieldInputs] = None):
    """Backward of one net from the stash -> (d_w (n_w,), d_b (n_b,),
    d_bview (Gb, 128)) float32 (see `field_bwd_plain`). g is the (P, 4)
    output cotangent. With `inputs` (the forward's pts, dirs, spr and poses)
    it runs the input-gradient branch too and returns (d_w, d_b, d_bview,
    d_pts (P, 3), d_dirs (P / spr, 3), d_poses (G, n_pose)) (see
    `encode_bwd_plain`); the weight gradients are the same either way. On
    CUDA every gradient is bit-identical from launch to launch."""
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
    Gb = bview.shape[0]
    d_w = torch.zeros(L.n_w, dtype=torch.float32, device=dev)
    d_b = torch.zeros(L.n_b, dtype=torch.float32, device=dev)
    d_bview = torch.zeros((Gb, VIEW_WIDTH), dtype=torch.float32, device=dev)
    ins = None
    if inputs is not None:
        pts, dirs, spr, poses = inputs
        ins = (torch.empty((P, 3), dtype=torch.float32, device=dev),
               torch.empty((dirs.shape[0], 3), dtype=torch.float32, device=dev),
               torch.zeros(poses.shape, dtype=torch.float32, device=dev))
    if P == 0:
        return (d_w, d_b, d_bview) if ins is None else (d_w, d_b, d_bview, *ins)
    lib = build.load()
    layout, n_layout = _layout_arg(L)
    ppg = P // inputs.poses.shape[0] if inputs is not None else 0
    n_ws = lib.posegen_field_bwd_workspace(P, layout, n_layout, Gb, P // Gb, ppg)
    if n_ws <= 0:
        raise ValueError(f"field_bwd: no workspace for {P} points, {Gb} view groups")
    ws = torch.empty(n_ws, dtype=torch.uint8, device=dev)
    w16 = _bf16_weights(net)
    null = ctypes.c_void_p(None)
    if inputs is None:
        in_args = (null, null, 0, null, 0, 0, null, null, null)
    else:
        in_args = (_ptr(pts), _ptr(dirs), spr, _ptr(poses), poses.shape[1], ppg,
                   *(_ptr(t) for t in ins))
    with torch.cuda.device(dev):
        rc = lib.posegen_field_bwd(
            P, layout, n_layout, _ptr(w16), _ptr(net.b), _ptr(bview), Gb, P // Gb, _ptr(g),
            _ptr(e_pts), _ptr(e_view), _ptr(ws), n_ws, _ptr(d_w), _ptr(d_b), _ptr(d_bview),
            *in_args, _stream(),
        )
    build.check(lib, rc, "field_bwd")
    LAUNCHES["field_bwd"] += 1
    if ins is None:
        return d_w, d_b, d_bview
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
