"""Fused skeleton-encode + NeRF MLP field evaluation: gate, operands, plain
versions, kernel wrappers and host glue
(port of posegen_tpu/kernels/field.py).

Two CUDA kernels (csrc/field.cu) replace the two Pallas kernels of the
render path:

  fused_field  <- posegen_tpu/kernels/field.py::_field_kernel (full raw, or
                  density_only: the alpha head alone, rgb rows zero), in its
                  three operand modes: one pose; grouped poses (a
                  `pack_poses` table of G rows and a view bias per group,
                  the rays contiguous per group: the JAX kernel under
                  `grouped_specs`); and the per-ray view ladder (one pose,
                  full raw: the `ray_s` branch of `encode_channels`)
  fused_dual   <- posegen_tpu/kernels/field.py::_dual_kernel (one encode,
                  coarse density + fine full raw)

Each point's encodings are built in the kernel, once per launch: a
persistent grid of at most one block per SM encodes each 128-point tile into
the block's slot of an L2-resident scratch (`eval_slot_bytes`; the wrapper
allocates one slot per SM), from which TMA streams them to the tensor cores.
Per point only (3,) of position, the ray's (3,) direction and the (4,) raw
output cross device memory. Channels are joint-major, the order of
`render.raycast.encode_inputs`, so the JAX weights load without a row
permutation.

The trainable pair (kernels/field_grad.py; its forward is the eval kernel's
stash mode, its backward csrc/field_grad.cu) shares this module's gate,
operands and plain versions; `fused_run_net(trainable=True)` routes to it.

Operands. `prepare_net` packs one net for the eval kernels: every matrix
transposed to (out, in) and flattened into one bf16 buffer, every bias into
one f32 buffer, at the offsets of a `NetLayout` (`pack_net_f32` is the same
packing in float32 under autograd, for training; `pack_poses` stacks one
pose row per pose group). Two per-call quantities
are folded into these operands on the host: the pose group's framecode (its
view-head product becomes part of the view bias) and the BARF octave
weights (appended to the pose operand of `pack_pose`; the encode scales
each sin/cos octave by its weight, as the JAX kernel does). The view head's
input rows are zero-padded to a multiple of 16 for the tensor-core tiles.

Beside each wrapper, a plain PyTorch version (`field_plain`, `dual_plain`)
computes the same function from the same operands; `mm_dtype` rounds each
matmul's activation operand (bf16 reproduces the kernel's tensor-core
inputs; float32 keeps the activations exact, as the JAX package's
interpret-mode tests do with MM_DTYPE = float32). A wrapper runs its plain
version, at float32, only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from posegen_tpu_torch.models.nerf import framecode_lookup

N_JOINTS = 24
WIDTH = 256  # trunk width the kernels are built for
VIEW_WIDTH = WIDTH // 2
POSE_FLOATS = N_JOINTS * 9 + N_JOINTS * 3 + N_JOINTS + 1  # rot | trn | cut | tau
MAX_OCTAVES = 64  # nf_kp + nf_view, csrc/field.cuh kMaxOctaves

# launches per kernel since the last reset_launches(); "field" counts the
# full and the density-only instantiation of the field kernel on one pose
# together, "field_grouped" the same on grouped poses and "field_ray_ladder"
# the per-ray view ladder's (a launch counts under one key);
# "field_stash" and "field_bwd" are the training pair (kernels/field_grad.py),
# "field_bwd_inputs" counts the backward launches that also ran its
# input-gradient branch, and "variant" the A/B harness's variant kernel
# (kernels/variants.py)
LAUNCHES: Dict[str, int] = {"field": 0, "field_grouped": 0, "field_ray_ladder": 0, "dual": 0,
                            "field_stash": 0, "field_bwd": 0, "field_bwd_inputs": 0,
                            "variant": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kp_ch(nf_kp: int) -> int:
    return N_JOINTS * (1 + 2 * nf_kp)  # 360 at multires 7


def pts_ch(nf_kp: int) -> int:
    return kp_ch(nf_kp) + 3 * N_JOINTS  # 432 at multires 7


def view_ch(nf_view: int) -> int:
    return 3 * N_JOINTS * (1 + 2 * nf_view)  # 648 at multires_views 4; 72 at 0


def field_flops(layout: "NetLayout", density_only: bool) -> int:
    """Multiply-add work of one field evaluation per point (x2 FLOP), as the
    JAX kernels' cost estimates count it (posegen_tpu/kernels/field.py:679):
    1,723,648 for the flagship net, 1,360,384 density-only."""
    L = layout
    macs = sum(L.layer_in(i) * WIDTH for i in range(L.depth)) + WIDTH  # trunk + alpha
    if not density_only:
        macs += WIDTH * WIDTH + (WIDTH + L.vc) * VIEW_WIDTH + VIEW_WIDTH * 3
    return 2 * macs


# ---------------------------------------------------------------------------
# The gate: the config / pose subset the kernels handle
# (posegen_tpu/kernels/field.py:75-189)
# ---------------------------------------------------------------------------


def fused_config_disqualification(cfg) -> Optional[str]:
    """First config flag that disqualifies the fused kernels, or None.

    Beyond the JAX gate's flags (posegen_tpu/kernels/field.py:75-112): a net
    that `net_layout` refuses (a depth outside 1..MAX_DEPTH, or the skip
    after the last layer at depth 5) and a layout that the eval kernels'
    plan refuses (`field_eval_refusal`). The JAX kernels take those nets; the
    port's callers run the plain pipeline for them instead, a difference of
    route, not of result. The trainer also consults the training kernels'
    plans (`field_grad.train_refusal`)."""
    checks = (
        (cfg.kp_dist_type == "reldist",
         f"kp_dist_type={cfg.kp_dist_type!r} (kernel needs 'reldist')"),
        (getattr(cfg, "i_embed", 0) == 0,
         f"i_embed={getattr(cfg, 'i_embed', 0)} (kernel needs 0)"),
        (cfg.view_type == "relray",
         f"view_type={cfg.view_type!r} (kernel needs 'relray')"),
        (cfg.bone_type == "reldir",
         f"bone_type={cfg.bone_type!r} (kernel needs 'reldir')"),
        (cfg.multires_bones == 0,
         f"multires_bones={cfg.multires_bones} (kernel needs 0)"),
        (cfg.use_cutoff, "use_cutoff=False"),
        (cfg.cutoff_viewdir, "cutoff_viewdir=False"),
        (cfg.cutoff_inputs, "cutoff_inputs=False"),
        (not cfg.cutoff_bones, "cutoff_bones=True"),
        (cfg.use_viewdirs, "use_viewdirs=False"),
        (cfg.n_joints == N_JOINTS,
         f"n_joints={cfg.n_joints} (kernel needs {N_JOINTS})"),
        (not cfg.cut_to_dist, "cut_to_dist=True"),
        (not cfg.cutoff_shift, "cutoff_shift=True"),
        (not cfg.normalize_cutoff, "normalize_cutoff=True"),
        (cfg.netwidth == WIDTH, f"netwidth={cfg.netwidth} (kernel needs {WIDTH})"),
        ((cfg.netwidth_fine or cfg.netwidth) == cfg.netwidth,
         f"netwidth_fine={cfg.netwidth_fine} != netwidth"),
        ((cfg.netdepth_fine or cfg.netdepth) == cfg.netdepth,
         f"netdepth_fine={cfg.netdepth_fine} != netdepth"),
    )
    for ok, reason in checks:
        if not ok:
            return reason
    try:
        layout = net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    except ValueError as e:
        return str(e)
    return field_eval_refusal(layout)


def fused_net_disqualification(cfg, net_params: Dict) -> Optional[str]:
    """First reason this config and net cannot run the inference kernels, on
    any number of pose groups (`render_rays(use_fused=True)`'s gate)."""
    reason = fused_config_disqualification(cfg)
    if reason is not None:
        return reason
    if len(net_params.get("views_linears", [0])) != 1:
        return (
            f"{len(net_params['views_linears'])} view layers "
            "(kernel needs exactly 1)"
        )
    return None


def fused_disqualification(cfg, ctx, net_params: Dict) -> Optional[str]:
    """First reason this config/pose cannot run the inference kernels on the
    automatic route, which takes a single pose as the JAX gate does.
    Framecode models qualify with or without ctx.cam_idxs (a missing index
    means the mean code)."""
    reason = fused_net_disqualification(cfg, net_params)
    if reason is not None:
        return reason
    if ctx.kps.shape[0] != 1:
        return (
            f"{ctx.kps.shape[0]} pose groups in ctx "
            "(inference kernel needs a single pose)"
        )
    return None


def supports_fused(cfg, ctx, net_params: Dict) -> bool:
    """The config/pose subset the inference kernels handle (single pose)."""
    return fused_disqualification(cfg, ctx, net_params) is None


_WARNED_FALLBACKS: set = set()


def warn_fused_fallback(where: str, reason: str, extra: str = "") -> None:
    """One warning per (site, reason) per process when a render surface
    drops from the fused kernels to the plain PyTorch pipeline."""
    key = (where, reason)
    if key in _WARNED_FALLBACKS:
        return
    _WARNED_FALLBACKS.add(key)
    warnings.warn(
        f"posegen_tpu_torch[{where}]: fused field kernel disabled — {reason}; "
        f"using the plain PyTorch pipeline (encodings materialized in "
        f"device memory).{extra}",
        stacklevel=3,
    )


# The JAX eval kernel refuses a grouped batch whose points per group none of
# its tiles (2048 ... 128, each a multiple of 128) divides
# (posegen_tpu/kernels/field.py:932-942). The CUDA kernels take any group
# size; fused_run_net keeps the refusal, so that both packages take the same
# batches.
GROUP_TILE = 128


def ray_tile(S: int) -> Optional[int]:
    """The JAX ray-ladder tile (posegen_tpu/kernels/field.py:169-177): the
    largest point tile <= 2048 of whole rays of S samples, at most 128 of
    them, a multiple of 128; None when S admits none (odd S > 16, say).
    fused_run_net runs the ladder where this is not None, as JAX does; the
    CUDA ladder itself takes any S."""
    base = S * 128 // math.gcd(S, 128)  # lcm(S, 128)
    if base > min(2048, 128 * S):
        return None
    return min((2048 // base) * base, 128 * S)


def supports_dual_eval(cfg, ctx, net_params: Dict) -> bool:
    """Whether the dual-net coarse pass applies: fused eval support, a
    two-pass render (N_importance > 0 with a separate fine net), and a
    single pose group."""
    return (
        supports_fused(cfg, ctx, net_params)
        and cfg.N_importance > 0
        and not cfg.single_net
        and ctx.skts.shape[0] == 1
    )


# ---------------------------------------------------------------------------
# Kernel operands
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetLayout:
    """Dimensions of one packed net and the offsets of its matrices (in
    elements of the weight buffer) and biases (in floats of the bias
    buffer). Matrices are (out, in) row-major; every weight offset is a
    multiple of 16 elements (32 bytes, the tensor-core load alignment)."""

    depth: int
    skip: int  # layer whose output is concatenated with x_pts; -1: none
    nf_kp: int
    nf_view: int
    pc: int  # x_pts channels
    vc: int  # x_views channels
    vcp: int  # vc padded to a multiple of 16
    w_alpha: int
    b_alpha: int
    w_feat: int
    b_feat: int
    w_view: int
    b_view: int
    w_rgb: int
    b_rgb: int
    w_layers: Tuple[int, ...]
    b_layers: Tuple[int, ...]
    n_w: int
    n_b: int

    def layer_in(self, i: int) -> int:
        """Input width of trunk layer i."""
        return _layer_in(i, self.pc, self.skip)

    def as_ints(self) -> Tuple[int, ...]:
        """The integer record csrc/field.cu reads (see its `Layout`)."""
        head = (self.depth, self.skip, self.nf_kp, self.nf_view, self.pc,
                self.vc, self.vcp, self.w_alpha, self.b_alpha, self.w_feat,
                self.b_feat, self.w_view, self.b_view, self.w_rgb, self.b_rgb)
        return head + tuple(v for wb in zip(self.w_layers, self.b_layers) for v in wb)


MAX_DEPTH = 16  # csrc/field.cuh kMaxDepth


def _layer_in(i: int, pc: int, skip: int) -> int:
    """Trunk layer i reads x_pts (i = 0), [x_pts | h] (i = skip + 1) or h."""
    if i == 0:
        return pc
    return pc + WIDTH if i - 1 == skip else WIDTH


def net_layout(depth: int, nf_kp: int, nf_view: int) -> NetLayout:
    """Layout of a depth-layer, 256-wide net with the skip into layer 5
    (NeRFConfig.skips = (4,), present when depth > 5)."""
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"netdepth={depth}: the kernels take 1..{MAX_DEPTH} layers")
    skip = 4 if depth > 4 else -1
    if skip == depth - 1:
        raise ValueError(
            f"netdepth={depth}: a skip after the last layer has no consuming "
            "layer (the heads take the trunk width)"
        )
    pc, vc = pts_ch(nf_kp), view_ch(nf_view)
    vcp = -(-vc // 16) * 16
    w_off = b_off = 0
    w_layers, b_layers = [], []
    for i in range(depth):
        w_layers.append(w_off)
        b_layers.append(b_off)
        w_off += WIDTH * _layer_in(i, pc, skip)
        b_off += WIDTH
    w_alpha, b_alpha = w_off, b_off
    w_off += WIDTH
    b_off += 1
    w_feat, b_feat = w_off, b_off
    w_off += WIDTH * WIDTH
    b_off += WIDTH
    w_view, b_view = w_off, b_off
    w_off += VIEW_WIDTH * (WIDTH + vcp)
    b_off += VIEW_WIDTH
    w_rgb, b_rgb = w_off, b_off
    w_off += 3 * VIEW_WIDTH
    b_off += 3
    return NetLayout(
        depth=depth, skip=skip, nf_kp=nf_kp, nf_view=nf_view, pc=pc, vc=vc,
        vcp=vcp, w_alpha=w_alpha, b_alpha=b_alpha, w_feat=w_feat,
        b_feat=b_feat, w_view=w_view, b_view=b_view, w_rgb=w_rgb,
        b_rgb=b_rgb, w_layers=tuple(w_layers), b_layers=tuple(b_layers),
        n_w=w_off, n_b=b_off,
    )


# ---------------------------------------------------------------------------
# The kernels' plans on Hopper (csrc/field.cu, csrc/field.cuh)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can take
EVAL_TILE = 128  # points per tile of the eval kernels
_POSE_BYTES = 1536  # csrc/field.cuh kPoseBytes: the pose operand, 128-aligned


def eval_smem_bytes(layout: NetLayout) -> int:
    """The eval kernels' dynamic shared memory (csrc/field.cu
    eval_smem_bytes): 1,024 alignment slack, the 128 x 256 bf16 activation
    tile (65,536), the weight ring (3 x 32,768), the encoding ring (2 x
    16,384), the pose operand (1,536), the heads' weights (2,048) and 11
    mbarriers: 201,304 bytes at every layout, since no region depends on
    the depth or the encodings' widths."""
    return 1024 + 65_536 + 3 * 32_768 + 2 * 16_384 + _POSE_BYTES + 2048 + 11 * 8


def eval_slot_bytes(layout: NetLayout) -> int:
    """Bytes of one block's slot of the eval kernels' scratch: 128 rows of
    e_pts (pc) and of e_view (vc) bf16 (276,480 at the flagship)."""
    return 2 * EVAL_TILE * (layout.pc + layout.vc)


def field_eval_refusal(layout: NetLayout) -> Optional[str]:
    """Why the eval kernels do not take this layout, or None: its octave
    weights must fit the pose operand. Their shared-memory plan
    (`eval_smem_bytes`) fits one block at every layout."""
    if layout.nf_kp + layout.nf_view > MAX_OCTAVES:
        return (f"multires + multires_views = {layout.nf_kp + layout.nf_view}: the kernels' "
                f"pose operand holds {MAX_OCTAVES} octave weights")
    return None


def eval_tile_walk(n_pts: int, n_slots: int) -> List[List[range]]:
    """The eval kernels' persistent walk (csrc/field.cu eval_grid): a grid of
    min(tiles, n_slots) blocks, block b taking tiles b, b + grid, ... of
    EVAL_TILE points -> each block's point ranges, in its order."""
    n_tiles = -(-n_pts // EVAL_TILE)
    grid = min(n_tiles, n_slots)
    return [[range(t * EVAL_TILE, min(n_pts, (t + 1) * EVAL_TILE))
             for t in range(b, n_tiles, grid)] for b in range(grid)]


def body_smem_bytes(layout: NetLayout, tile: int, with_view: bool) -> int:
    """Dynamic shared memory of one block of the WMMA body (csrc/field.cuh
    smem_bytes; the variant kernel): the pose row, tile rows of
    x_pts, x_views (with_view) and the activations, all bf16 and padded by
    8, and 8 warps' f32 scratch: 184,832 bytes at the flagship and tile 64."""
    L = layout
    row = (L.pc + 8) + (L.vcp + 8 if with_view else 0) + (WIDTH + 8)
    return _POSE_BYTES + 2 * tile * row + 4 * 8 * 256


class FieldNet(NamedTuple):
    """One net packed for the kernels (see `prepare_net`)."""

    w: torch.Tensor  # (layout.n_w,) bf16
    b: torch.Tensor  # (layout.n_b,) f32
    layout: NetLayout


def barf_octave_weights(alpha: torch.Tensor, nf: int) -> torch.Tensor:
    """BARF window weight per sin/cos octave (reference get_schedule_w,
    core/cutoff_embedder.py:192-198; posegen_tpu/kernels/field.py:821-836)."""
    k = torch.arange(nf, dtype=torch.float32, device=alpha.device)
    return 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(alpha - k, 0.0, 1.0)))


def pack_net_f32(net: Dict, layout: NetLayout) -> FieldNet:
    """Pack a NeRF params dict (JAX layout, w (in, out)) at the offsets of
    `layout`: every matrix transposed to (out, in) in one float32 buffer,
    every bias in another, differentiable back to the leaves. The training
    kernels take it as it is (a bf16 cast here would round the gradients
    too; the kernels round the weights to bf16 as they load them). The view
    bias slot holds the plain view bias; framecodes enter through
    `group_view_bias` (training) or `prepare_net` (eval)."""
    L = layout
    mats, biases = [], []
    if len(net["pts_linears"]) != L.depth:
        raise ValueError(f"net has {len(net['pts_linears'])} layers, layout {L.depth}")
    for i, lay in enumerate(net["pts_linears"]):
        if lay["w"].shape != (L.layer_in(i), WIDTH):
            raise ValueError(f"layer {i} weight {tuple(lay['w'].shape)} != "
                             f"{(L.layer_in(i), WIDTH)}")
        mats.append(lay["w"].T)
        biases.append(lay["b"])
    for name in ("alpha_linear", "feature_linear"):
        mats.append(net[name]["w"].T)
        biases.append(net[name]["b"])
    (view,) = net["views_linears"]
    wv = view["w"]
    pad = wv.new_zeros(L.vcp - L.vc, VIEW_WIDTH)
    mats.append(torch.cat([wv[:WIDTH + L.vc], pad]).T)
    biases.append(view["b"])
    mats.append(net["rgb_linear"]["w"].T)
    biases.append(net["rgb_linear"]["b"])
    w = torch.cat([m.reshape(-1) for m in mats]).float()
    b = torch.cat([x.reshape(-1) for x in biases]).float()
    if w.numel() != L.n_w or b.numel() != L.n_b:
        raise ValueError("packed net does not match its layout")
    return FieldNet(w, b, L)


def prepare_net(net: Dict, layout: NetLayout,
                code: Optional[torch.Tensor] = None) -> FieldNet:
    """Pack a NeRF params dict (JAX layout, w (in, out)) for the eval
    kernels: `pack_net_f32`'s layout with the weights in bf16 (the JAX
    kernels' `prepare_params` rounds them alike).

    code: this pose group's framecode (code_ch,); its product with the
      (bf16-rounded) framecode rows of the view head is folded into the view
      bias (`eval_view_bias`). Required when the view head has framecode
      rows.
    """
    L = layout
    w, b, _ = pack_net_f32(net, L)
    n_code = net["views_linears"][0]["w"].shape[0] - WIDTH - L.vc
    if n_code:
        if code is None or code.numel() != n_code:
            raise ValueError(f"view head has {n_code} framecode rows; pass the code")
        b = b.clone()
        b[L.b_view:L.b_view + VIEW_WIDTH] = eval_view_bias(net, L, code.reshape(1, n_code))[0]
    return FieldNet(w.to(torch.bfloat16).contiguous(), b.contiguous(), L)


def prepare_net_grouped(net: Dict, layout: NetLayout,
                        codes: Optional[torch.Tensor] = None):
    """`prepare_net` for G pose groups -> (the packed net, its view-bias slot
    the plain bias; `eval_view_bias`'s (1 or G, 128) rows for `fused_field`)."""
    w, b, _ = pack_net_f32(net, layout)
    return (FieldNet(w.to(torch.bfloat16).contiguous(), b.contiguous(), layout),
            eval_view_bias(net, layout, codes))


def eval_view_bias(net: Dict, layout: NetLayout,
                   codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eval kernels' view bias per pose group: (1, 128) the plain bias,
    or with framecodes (G, code_ch) -> (G, 128), row g the plain bias + code_g
    @ the bf16-rounded framecode rows. Each row is its own (1, code_ch)
    product, the one `prepare_net` folds for a single code, so group g's row
    is that net's view bias bit for bit (a batched product may round
    otherwise; `group_view_bias` is the training path's float32 packing)."""
    wv = net["views_linears"][0]["w"]
    bv = net["views_linears"][0]["b"].float()
    n_code = wv.shape[0] - WIDTH - layout.vc
    if n_code == 0:
        return bv.reshape(1, VIEW_WIDTH).contiguous()
    if codes is None or codes.dim() != 2 or codes.shape[1] != n_code:
        raise ValueError(f"view head has {n_code} framecode rows; pass (G, {n_code}) codes")
    w_code = wv[WIDTH + layout.vc:].to(torch.bfloat16).float()
    return torch.stack([bv + (codes[g:g + 1].float() @ w_code)[0]
                        for g in range(codes.shape[0])]).contiguous()


def group_view_bias(net: Dict, layout: NetLayout,
                    codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The view layer's bias per pose group, under autograd: (1, 128) the
    plain bias, or with framecodes (G, code_ch) -> (G, 128) bias + code_g @
    W_code in float32 (the JAX kernel's per-group code column, folded)."""
    wv, bv = net["views_linears"][0]["w"], net["views_linears"][0]["b"]
    n_code = wv.shape[0] - WIDTH - layout.vc
    if n_code == 0:
        return bv.float().reshape(1, VIEW_WIDTH)
    if codes is None or codes.shape[-1] != n_code:
        raise ValueError(f"view head has {n_code} framecode rows; pass (G, {n_code}) codes")
    return bv.float() + codes.float() @ wv[WIDTH + layout.vc:].float()


def pack_pose(skts: torch.Tensor, embed_state: Dict, nf_kp: int, nf_view: int,
              sched: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """(24, 4, 4) world-to-joint transforms + the kp embed state + the BARF
    octave weights (kp (nf_kp,), view (nf_view,); None = unscheduled, all 1)
    -> (POSE_FLOATS + nf_kp + nf_view,) f32:
    [rot (24, 9) | trn (24, 3) | cutoff (24) | tau | kp octaves | view octaves]."""
    return pack_poses(skts[None], embed_state, nf_kp, nf_view, sched)[0]


def pack_poses(skts: torch.Tensor, embed_state: Dict, nf_kp: int, nf_view: int,
               sched: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """(G, 24, 4, 4) per-group transforms -> (G, n_pose) f32: one
    `pack_pose` row per pose group."""
    G = skts.shape[0]
    if nf_kp + nf_view > MAX_OCTAVES:
        raise ValueError(f"multires + multires_views > {MAX_OCTAVES}")
    if sched is None:
        sched = (skts.new_ones(nf_kp), skts.new_ones(nf_view))
    shared = torch.cat([
        embed_state["cutoff_dist"].reshape(-1).to(skts.dtype),
        embed_state["tau"].reshape(1).to(skts.dtype),
        sched[0].reshape(nf_kp).to(skts.dtype),
        sched[1].reshape(nf_view).to(skts.dtype),
    ])
    return torch.cat([
        skts[:, :, :3, :3].reshape(G, -1),
        skts[:, :, :3, 3].reshape(G, -1),
        shared.expand(G, -1),
    ], 1).float().contiguous()


def _unpack(net: FieldNet):
    """Views of the packed matrices: (layers [(W, b)], (Wa, ba), (Wf, bf),
    (Wv, bv), (Wr, br)), each W (out, in)."""
    L, w, b = net.layout, net.w, net.b

    def mat(off, n_out, n_in):
        return w[off:off + n_out * n_in].view(n_out, n_in)

    layers = [
        (mat(L.w_layers[i], WIDTH, L.layer_in(i)), b[L.b_layers[i]:L.b_layers[i] + WIDTH])
        for i in range(L.depth)
    ]
    return (
        layers,
        (mat(L.w_alpha, 1, WIDTH), b[L.b_alpha:L.b_alpha + 1]),
        (mat(L.w_feat, WIDTH, WIDTH), b[L.b_feat:L.b_feat + WIDTH]),
        (mat(L.w_view, VIEW_WIDTH, WIDTH + L.vcp), b[L.b_view:L.b_view + VIEW_WIDTH]),
        (mat(L.w_rgb, 3, VIEW_WIDTH), b[L.b_rgb:L.b_rgb + 3]),
    )


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in PyTorch
# ---------------------------------------------------------------------------


def view_ladder_plain(dirs: torch.Tensor, pose: torch.Tensor,
                      nf_view: int) -> List[torch.Tensor]:
    """(R, 3) ray dirs -> the rays' ungated view ladder: 1 + 2 nf_view blocks
    (R, 24, 3), [dn | per octave sin, cos], dn the direction in each joint
    frame, normalised; octaves by one sin/cos pair and the double-angle
    recurrence, as the kernels do."""
    R = pose[:216].view(N_JOINTS, 9)
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    DX = R[:, 0] * dx + R[:, 1] * dy + R[:, 2] * dz
    DY = R[:, 3] * dx + R[:, 4] * dy + R[:, 5] * dz
    DZ = R[:, 6] * dx + R[:, 7] * dy + R[:, 8] * dz
    dn_inv = torch.rsqrt(torch.clamp(DX * DX + DY * DY + DZ * DZ, min=1e-24))
    q = torch.stack([DX * dn_inv, DY * dn_inv, DZ * dn_inv], -1)  # (R, 24, 3)
    blocks = [q]
    s, c = torch.sin(q), torch.cos(q)
    for f in range(nf_view):
        blocks += [s, c]
        if f + 1 < nf_view:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return blocks


def encode_plain(pts: torch.Tensor, dirs: torch.Tensor, spr: int,
                 pose: torch.Tensor, nf_kp: int, nf_view: int,
                 with_view: bool = True, ray_ladder: bool = False):
    """(P, 3) points, (P / spr, 3) ray dirs -> (e_pts (P, pc), e_view (P, vc)
    or None), joint-major: e_pts = [v*w | per octave sin*w, cos*w | reldir],
    each kp block 24 wide and reldir (j, xyz); e_view = [dn*w | per octave
    sin*w, cos*w], each block (j, xyz). Octaves use one sin/cos pair and the
    double-angle recurrence, as the kernels do. The view ladder is built per
    point, or with ray_ladder once per ray and repeated to the ray's points
    (the same values: each is a function of the ray alone)."""
    R = pose[:216].view(N_JOINTS, 9)
    t = pose[216:288].view(N_JOINTS, 3)
    cut = pose[288:312]
    tau = pose[312]
    sw_kp = pose[POSE_FLOATS:POSE_FLOATS + nf_kp]
    sw_view = pose[POSE_FLOATS + nf_kp:POSE_FLOATS + nf_kp + nf_view]
    P = pts.shape[0]

    x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
    X = R[:, 0] * x + R[:, 1] * y + R[:, 2] * z + t[:, 0]  # (P, 24)
    Y = R[:, 3] * x + R[:, 4] * y + R[:, 5] * z + t[:, 1]
    Z = R[:, 6] * x + R[:, 7] * y + R[:, 8] * z + t[:, 2]
    v = torch.sqrt(X * X + Y * Y + Z * Z)
    w = 1.0 - torch.sigmoid(tau * (v - cut))
    inv_v = 1.0 / torch.clamp(v, min=1e-12)

    rows = [v * w]
    s, c = torch.sin(v), torch.cos(v)
    for f in range(nf_kp):
        wf = w * sw_kp[f]
        rows += [s * wf, c * wf]
        if f + 1 < nf_kp:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    rows.append(torch.stack([X * inv_v, Y * inv_v, Z * inv_v], -1).reshape(P, -1))
    e_pts = torch.cat(rows, -1)
    if not with_view:
        return e_pts, None

    if ray_ladder:
        blocks = [b.repeat_interleave(spr, dim=0) for b in view_ladder_plain(dirs, pose, nf_view)]
    else:
        blocks = view_ladder_plain(dirs.repeat_interleave(spr, dim=0), pose, nf_view)
    wq = w[..., None]
    vrows = [blocks[0] * wq]
    for f in range(nf_view):
        wf = wq * sw_view[f]
        vrows += [blocks[1 + 2 * f] * wf, blocks[2 + 2 * f] * wf]
    e_view = torch.stack(vrows, 1).reshape(P, -1)
    return e_pts, e_view


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bfloat16, kept in float32."""
    return a.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, w: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """a (P, K) @ w (N, K)^T, both operands rounded to mm_dtype (bf16 weights
    are exact either way; the training path's float32 weights round as the
    kernels round them), the products summed in float32 (a product of two
    bf16 values is exact in float32)."""
    return a.to(mm_dtype).float() @ w.to(mm_dtype).float().T


def mlp_plain(net: FieldNet, e_pts: torch.Tensor, e_view: Optional[torch.Tensor],
              density_only: bool, mm_dtype: torch.dtype,
              bview: Optional[torch.Tensor] = None, bf16act: bool = False,
              bf16view: bool = False) -> torch.Tensor:
    """Trunk + heads on prebuilt encodings -> (P, 4) raw [r, g, b, sigma]
    (rgb zero when density_only). bview: a view bias (128,) or per point
    (P, 128) in place of the packed one. bf16act rounds x_pts and every
    ReLU output to bf16, and with it or bf16view the feature and x_views
    are rounded before the view layer (the A/B harness's bf16act and
    bf16enc, kernels/variants.py); no-ops at bf16 mm_dtype."""
    L = net.layout
    layers, (wa, ba), (wf, bf), (wv, bv), (wr, br) = _unpack(net)
    if bview is not None:
        bv = bview
    act = bf16_round if bf16act else (lambda a: a)
    x0 = h = act(e_pts)
    for i, (w, b) in enumerate(layers):
        if i > 0 and i - 1 == L.skip:
            acc = _mm(x0, w[:, :L.pc], mm_dtype) + _mm(h, w[:, L.pc:], mm_dtype)
        else:
            acc = _mm(h, w, mm_dtype)
        h = act(torch.relu(acc + b))
    alpha = _mm(h, wa, mm_dtype) + ba
    if density_only:
        return torch.cat([alpha.new_zeros(alpha.shape[0], 3), alpha], -1)
    feat = _mm(h, wf, mm_dtype) + bf
    if bf16act or bf16view:
        feat, e_view = bf16_round(feat), bf16_round(e_view)
    hv = act(torch.relu(
        _mm(feat, wv[:, :WIDTH], mm_dtype)
        + _mm(e_view, wv[:, WIDTH:WIDTH + L.vc], mm_dtype) + bv
    ))
    rgb = _mm(hv, wr, mm_dtype) + br
    return torch.cat([rgb, alpha], -1)


def encode_groups_plain(pts, dirs, spr: int, poses, nf_kp: int, nf_view: int,
                        with_view: bool = True):
    """`encode_plain` on a (G, n_pose) table of pose groups: group g's points
    g P / G .. (whole rays of spr) on its pose row."""
    P, G = pts.shape[0], poses.shape[0]
    ppg = P // G
    parts = [encode_plain(pts[g * ppg:(g + 1) * ppg], dirs[g * ppg // spr:(g + 1) * ppg // spr],
                          spr, poses[g], nf_kp, nf_view, with_view=with_view)
             for g in range(G)]
    e_view = torch.cat([p[1] for p in parts]) if with_view else None
    return torch.cat([p[0] for p in parts]), e_view


def view_bias_rows(bview: torch.Tensor, n_pts: int) -> torch.Tensor:
    """(Gb, 128) per-group view bias -> (128,) or per point (P, 128)."""
    if bview.shape[0] == 1:
        return bview[0]
    return bview.repeat_interleave(n_pts // bview.shape[0], dim=0)


def field_plain(pts, dirs, spr: int, pose, net: FieldNet,
                density_only: bool = False,
                mm_dtype: torch.dtype = torch.float32,
                bview: Optional[torch.Tensor] = None,
                ray_ladder: bool = False) -> torch.Tensor:
    """Plain version of the field kernel -> (P, 4) raw, in `fused_field`'s
    modes: pose one row, or a (G, n_pose) table whose group g takes points
    g P / G .. of whole rays, with its bview rows (1 or G, 128); ray_ladder
    builds the view ladder per ray."""
    L = net.layout
    if pose.dim() == 1:
        e_pts, e_view = encode_plain(pts, dirs, spr, pose, L.nf_kp, L.nf_view,
                                     with_view=not density_only, ray_ladder=ray_ladder)
    else:
        e_pts, e_view = encode_groups_plain(pts, dirs, spr, pose, L.nf_kp, L.nf_view,
                                            with_view=not density_only)
    rows = None if bview is None else view_bias_rows(bview, pts.shape[0])
    return mlp_plain(net, e_pts, e_view, density_only, mm_dtype, bview=rows)


def dual_plain(pts, dirs, spr: int, pose, net_c: FieldNet, net_f: FieldNet,
               mm_dtype: torch.dtype = torch.float32):
    """Plain version of the dual kernel -> (raw_c (P, 4) [rgb zero], raw_f)."""
    L = net_f.layout
    e_pts, e_view = encode_plain(pts, dirs, spr, pose, L.nf_kp, L.nf_view)
    return (mlp_plain(net_c, e_pts, None, True, mm_dtype),
            mlp_plain(net_f, e_pts, e_view, False, mm_dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(pts, dirs, spr, pose, nets, bview=None):
    if pts.dim() != 2 or pts.shape[1] != 3 or dirs.dim() != 2 or dirs.shape[1] != 3:
        raise ValueError(f"pts {tuple(pts.shape)} / dirs {tuple(dirs.shape)} must be (*, 3)")
    P = pts.shape[0]
    if spr < 1 or P != dirs.shape[0] * spr:
        raise ValueError(f"{P} points != {dirs.shape[0]} rays x {spr} samples")
    for net in nets:
        if net.layout != nets[0].layout:
            raise ValueError("the nets of one launch must share a layout")
    n_pose = POSE_FLOATS + nets[0].layout.nf_kp + nets[0].layout.nf_view
    if pose.dim() == 2 and len(nets) == 1:  # a table of pose groups
        G = pose.shape[0]
        if pose.shape[1] != n_pose or G < 1:
            raise ValueError(f"poses {tuple(pose.shape)} != (G, {n_pose})")
        if P % G or (P // G) % spr:
            raise ValueError(f"{P} points do not split into {G} pose groups of whole rays")
        shape = None if bview is None else tuple(bview.shape)
        if shape not in ((1, VIEW_WIDTH), (G, VIEW_WIDTH)):
            raise ValueError(f"view bias {shape} != (1 or {G}, {VIEW_WIDTH})")
    elif pose.shape != (n_pose,):
        raise ValueError(f"pose {tuple(pose.shape)} != ({n_pose},)")
    elif bview is not None:
        raise ValueError("a view bias per group needs a table of pose groups")
    if not pts.is_cuda:
        return
    dev = pts.device
    extra = () if bview is None else (("view bias", bview, torch.float32),)
    for name, t, dt in (("pts", pts, torch.float32), ("dirs", dirs, torch.float32),
                        ("pose", pose, torch.float32)) + extra:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}")
    for net in nets:
        if (net.w.device != dev or net.w.dtype != torch.bfloat16
                or not net.w.is_contiguous()):
            raise ValueError(f"packed weights: need contiguous bf16 on {dev}")
        if (net.b.device != dev or net.b.dtype != torch.float32
                or not net.b.is_contiguous()):
            raise ValueError(f"packed biases: need contiguous float32 on {dev}")


def _no_grad_operands(where: str, *tensors) -> None:
    """The eval kernels fill fresh outputs outside autograd: refuse operands
    that would need a gradient rather than drop it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{where}: an operand requires grad, and this eval kernel has no "
            "backward; train through fused_run_net(..., trainable=True) "
            "(kernels/field_grad.py), or run under torch.no_grad()"
        )


def _layout_arg(layout: NetLayout):
    ints = layout.as_ints()
    return (ctypes.c_int * len(ints))(*ints), len(ints)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _eval_launch_operands(where: str, layout: NetLayout, device):
    """Refuse a layout the eval kernels do not take; else their scratch: one
    slot per SM of the card (the most blocks the persistent grid runs),
    sized by the layout and the card, never by the points."""
    reason = field_eval_refusal(layout)
    if reason is not None:
        raise ValueError(f"{where}: {reason}")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    scratch = torch.empty(n_sm * eval_slot_bytes(layout), dtype=torch.uint8, device=device)
    return scratch, ctypes.c_longlong(scratch.numel())


def fused_field(pts: torch.Tensor, dirs: torch.Tensor, spr: int,
                pose: torch.Tensor, net: FieldNet,
                density_only: bool = False, bview: Optional[torch.Tensor] = None,
                ray_ladder: bool = False) -> torch.Tensor:
    """Fused encode + MLP field -> (P, 4) raw [r, g, b, sigma] (rgb zero when
    density_only). pts (P, 3) f32; dirs (P / spr, 3) f32, one per ray of spr
    consecutive points; net from `prepare_net`.

    pose: one pose from `pack_pose`, or a (G, n_pose) table from
      `pack_poses` (grouped poses: group g takes points g P / G .., whole
      rays; the kernel's grouped mode, counted as "field_grouped").
    bview: with a table, its view bias (1 or G, 128) from `eval_view_bias`
      (`prepare_net_grouped`; the packed view bias is not read).
    ray_ladder: one pose, full raw: the view ladder is built once per ray
      ("field_ray_ladder"); the raw is the same, bit for bit."""
    _check_operands(pts, dirs, spr, pose, (net,), bview)
    grouped = pose.dim() == 2
    if ray_ladder and (grouped or density_only):
        raise ValueError("the ray ladder runs the full net on one pose")
    _no_grad_operands("fused_field", pts, dirs, pose, net.w, net.b,
                      *(() if bview is None else (bview,)))
    if not pts.is_cuda:
        return field_plain(pts, dirs, spr, pose, net, density_only, bview=bview,
                           ray_ladder=ray_ladder)
    from posegen_tpu_torch.kernels import build

    lib = build.load()
    L = net.layout
    P = pts.shape[0]
    out = torch.empty((P, 4), dtype=torch.float32, device=pts.device)
    if P == 0:
        return out
    layout, n_layout = _layout_arg(L)
    with torch.cuda.device(pts.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        scratch, n_scratch = _eval_launch_operands("fused_field", L, pts.device)
        if grouped:
            key = "field_grouped"
            G, Gb = pose.shape[0], bview.shape[0]
            rc = lib.posegen_field_grouped(
                _ptr(pts), _ptr(dirs), P, spr, _ptr(pose), pose.shape[1], P // G, layout,
                n_layout, _ptr(net.w), _ptr(net.b), _ptr(bview), VIEW_WIDTH if Gb > 1 else 0,
                P // Gb, _ptr(out), int(density_only), _ptr(scratch), n_scratch, stream,
            )
        elif ray_ladder:
            key = "field_ray_ladder"
            vlad = torch.empty((P // spr, L.vc), dtype=torch.float32, device=pts.device)
            rc = lib.posegen_field_ray_ladder(
                _ptr(pts), _ptr(dirs), P, spr, _ptr(pose), layout, n_layout, _ptr(net.w),
                _ptr(net.b), _ptr(out), _ptr(vlad), ctypes.c_longlong(vlad.numel() * 4),
                _ptr(scratch), n_scratch, stream,
            )
        else:
            key = "field"
            rc = lib.posegen_field(
                _ptr(pts), _ptr(dirs), P, spr, _ptr(pose), layout, n_layout, _ptr(net.w),
                _ptr(net.b), _ptr(out), int(density_only), _ptr(scratch), n_scratch, stream,
            )
    build.check(lib, rc, key)
    LAUNCHES[key] += 1
    return out


def fused_dual(pts: torch.Tensor, dirs: torch.Tensor, spr: int,
               pose: torch.Tensor, net_c: FieldNet, net_f: FieldNet):
    """One encode, two nets -> (raw_c (P, 4) [rgb zero], raw_f (P, 4)):
    coarse density and fine full raw on the same points."""
    _check_operands(pts, dirs, spr, pose, (net_c, net_f))
    _no_grad_operands("fused_dual", pts, dirs, pose, net_c.w, net_c.b, net_f.w, net_f.b)
    if not pts.is_cuda:
        return dual_plain(pts, dirs, spr, pose, net_c, net_f)
    from posegen_tpu_torch.kernels import build

    lib = build.load()
    out_c = torch.empty((pts.shape[0], 4), dtype=torch.float32, device=pts.device)
    out_f = torch.empty_like(out_c)
    if pts.shape[0] == 0:
        return out_c, out_f
    layout, n_layout = _layout_arg(net_f.layout)
    with torch.cuda.device(pts.device):
        scratch, n_scratch = _eval_launch_operands("fused_dual", net_f.layout, pts.device)
        rc = lib.posegen_dual(
            _ptr(pts), _ptr(dirs), pts.shape[0], spr, _ptr(pose), layout,
            n_layout, _ptr(net_c.w), _ptr(net_c.b), _ptr(net_f.w),
            _ptr(net_f.b), _ptr(out_c), _ptr(out_f), _ptr(scratch), n_scratch,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    build.check(lib, rc, "dual")
    LAUNCHES["dual"] += 1
    return out_c, out_f


# ---------------------------------------------------------------------------
# Host glue (posegen_tpu/kernels/field.py:863-1062, eval + dual branches)
# ---------------------------------------------------------------------------


def _barf_sched(cfg, embed_state: Dict, view_embed_state: Optional[Dict]):
    """(kp, view) octave weights when the config anneals frequencies, else
    None; the view ladder uses the view embedder's alpha."""
    if not cfg.embed_kp_cfg.freq_schedule:
        return None
    a_view = (view_embed_state or embed_state)["alpha"]
    return (barf_octave_weights(embed_state["alpha"], cfg.multires),
            barf_octave_weights(a_view, cfg.multires_views))


def _group_codes(net_params: Dict, ctx, G: int, N: int, code_ch: int,
                 eval_mean_code: bool) -> Optional[torch.Tensor]:
    """(G, code_ch) framecode rows, one per pose group (reference Optcodes):
    cam idxs are constant within a group's rays, so a per-ray index table
    gives its first row per group; without indices, the mean code. None when
    the model has no framecodes."""
    if code_ch <= 0:
        return None
    idxs = ctx.cam_idxs
    if idxs is None:
        idxs = torch.zeros((G, 1), dtype=torch.long,
                           device=net_params["framecodes"].device)
        eval_mean_code = True
    if idxs.shape[0] == N and G != N:
        idxs = idxs.reshape(G, N // G, -1)[:, 0]
    return framecode_lookup(
        net_params["framecodes"], idxs[:G], eval_mean=eval_mean_code
    ).reshape(G, code_ch)


def fused_run_net(
    cfg,
    net_params: Dict,
    embed_state: Dict,
    pts: torch.Tensor,  # (N, S, 3)
    rays_d: torch.Tensor,  # (N, 3)
    ctx,
    eval_mean_code: bool = False,
    density_only: bool = False,
    view_embed_state: Optional[Dict] = None,  # for the view ladder's BARF alpha
    ray_ladder: Optional[bool] = None,  # the per-ray view ladder; None = off
    dual_params: Optional[Dict] = None,  # fine net: dual-net coarse pass
    trainable: bool = False,
    input_grads: bool = False,
):
    """Drop-in replacement for raycast._run_net on the supported subset:
    -> raw (N, S, 4), or with dual_params (the fine net; requires
    density_only and one pose group) -> (raw_coarse [rgb zero], raw_fine).

    ctx carries G pose rows with the rays contiguous per group (G divides
    N). The eval kernels take G > 1 in their grouped mode, where, as in the
    JAX kernel, the points per group must be a multiple of 128
    (`GROUP_TILE`).

    ray_ladder: the eval kernel's per-ray view ladder (the same raw, bit for
    bit). It stays off unless asked for, and also for density_only, G > 1,
    S < 2, trainable or an S whose `ray_tile` is None: JAX's rules.

    trainable: the training path (kernels/field_grad.py): the raw has
    gradients for the net's weights, biases and framecodes; with input_grads
    (pose refinement) also for pts, rays_d and ctx.skts, else those get
    none, as in the JAX kernel. On the host its wrappers run their plain
    versions at float32; the eval wrappers run theirs with bf16 weights and
    float32 activations."""
    N, S = pts.shape[:2]
    G = ctx.skts.shape[0]
    if input_grads and not trainable:
        raise ValueError("input_grads needs the trainable path")
    if N % G:
        raise ValueError(f"rays ({N}) not divisible into {G} pose groups")
    if dual_params is not None and (not density_only or trainable or G != 1):
        raise ValueError("dual_params needs the density-only, "
                         "single-group eval pass")
    layout = net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    code_ch = cfg.framecode_ch if cfg.opt_framecode else 0
    sched = _barf_sched(cfg, embed_state, view_embed_state)
    pts_f = pts.reshape(N * S, 3).float().contiguous()
    dirs = rays_d.float().contiguous()
    if trainable:
        from posegen_tpu_torch.kernels.field_grad import trainable_field

        if density_only:
            raise ValueError("the trainable path evaluates the full net in one pass")
        poses = pack_poses(ctx.skts, embed_state, cfg.multires, cfg.multires_views, sched)
        if not input_grads:
            pts_f, dirs, poses = pts_f.detach(), dirs.detach(), poses.detach()
        codes = _group_codes(net_params, ctx, G, N, code_ch, eval_mean_code)
        raw = trainable_field(pts_f, dirs, S, poses, pack_net_f32(net_params, layout),
                              group_view_bias(net_params, layout, codes))
        return raw.view(N, S, 4)
    ray_ladder = (bool(ray_ladder) and not density_only and G == 1 and S >= 2
                  and ray_tile(S) is not None)
    ppg = N * S // G
    if G > 1 and ppg % GROUP_TILE:
        raise ValueError(f"points per group ({ppg}) not a multiple of any tile")
    if G > 1:
        poses = pack_poses(ctx.skts, embed_state, cfg.multires, cfg.multires_views, sched)
        net, bview = prepare_net_grouped(
            net_params, layout, _group_codes(net_params, ctx, G, N, code_ch, eval_mean_code))
        raw = fused_field(pts_f, dirs, S, poses, net, density_only, bview=bview)
        return raw.view(N, S, 4)
    pose = pack_pose(ctx.skts[0], embed_state, cfg.multires, cfg.multires_views, sched)

    def prep(net):
        code = _group_codes(net, ctx, 1, N, code_ch, eval_mean_code)
        return prepare_net(net, layout, None if code is None else code[0])

    if dual_params is not None:
        raw_c, raw_f = fused_dual(pts_f, dirs, S, pose, prep(net_params),
                                  prep(dual_params))
        return raw_c.view(N, S, 4), raw_f.view(N, S, 4)
    raw = fused_field(pts_f, dirs, S, pose, prep(net_params), density_only,
                      ray_ladder=ray_ladder)
    return raw.view(N, S, 4)
