"""The training kernels' shared-memory plans on the CPU: the backward's
input-gradient pass (c) (posegen_tpu_torch/kernels/csrc/field_grad.cu
input_smem_bytes: its two kernels, the wgmma products on pass (a)'s rings
and the chain rule, whose plan is the same at every layout), which no
longer refuses a layout, so a pose step takes the kernels wherever the
weights-only step does, and the stash kernel's plan, the eval kernels' own
since the stash runs as their stash mode (csrc/field.cu).

The kernels run only on the card; there chip_smoke.py holds each plan here
against the library's export (posegen_field_bwd_input_smem,
posegen_field_stash_smem) and phase 7 runs pass (c) at the layouts its
WMMA plan refused (multires 9 / 4, 7 / 7, 15 / 4)."""

import dataclasses

import pytest
import torch

from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train import trainer as tt

EVAL_SMEM = 201_304  # the eval kernels' plan at every layout
INPUT_SMEM = 197_712  # pass (c)'s plan at every layout: input_sm90_kernel's

# (multires, multires_views) -> pass (c)'s bytes under its WMMA plan, which
# fit an H100 block (232,448 bytes) only at the flagship and 8 / 4
PASS_C = {(7, 4): 223_744, (8, 4): 228_864, (9, 4): 241_152, (4, 5): 260_608,
          (7, 7): 334_336}


@pytest.mark.parametrize("mr,mv", list(PASS_C))
def test_input_plan_and_refusal(mr, mv):
    """Pass (c)'s plan at depth 8 is INPUT_SMEM at every one of these
    layouts, inside a block whatever its WMMA plan needed (PASS_C); nothing
    refuses them: train_refusal is None (the stash kernel and pass (a) take
    them too) and field_grad has no input-gradient refusal left."""
    L = tfield.net_layout(8, mr, mv)
    assert tgrad.input_smem_bytes() == INPUT_SMEM <= tfield.SMEM_LIMIT
    assert (PASS_C[(mr, mv)] <= tfield.SMEM_LIMIT) == ((mr, mv) in ((7, 4), (8, 4)))
    assert tgrad.train_refusal(L) is None
    assert not hasattr(tgrad, "field_input_refusal")


def test_input_plan_formula():
    """The C++ formula: the larger of input_sm90_kernel's plan (1,024 bytes
    of alignment slack, a 3-stage ring of 64 x 256 bf16 weight slabs, a
    2-stage ring of 128 x 64 bf16 cotangent slabs, 2 x 4 staging buffers of
    64 x 32 f32 and the rings' 10 mbarriers) and input_chain_kernel's (64 x
    24 x 6 f32 of chain-rule state and 64 x 6 f32 of pts and dirs)."""
    products = 1024 + 3 * 256 * 64 * 2 + 2 * 128 * 64 * 2 + 2 * 4 * 64 * 32 * 4 + 10 * 8
    chain = 4 * (64 * 24 * 6 + 64 * 6)
    assert (products, chain) == (197_712, 38_400)
    assert tgrad.input_smem_bytes() == max(products, chain) == INPUT_SMEM


def test_no_layout_passes_the_gate_and_fails_to_launch():
    """Depth 8, multires 1-16, multires_views 0-10: every one of the 176
    layouts fits every plan of the input-gradient training kernels (pass
    (c)'s, the stash kernel's and pass (a)'s), and train_refusal passes
    each; under pass (c)'s WMMA plan only 40 of them fitted."""
    fits = 0
    for mr in range(1, 17):
        for mv in range(11):
            L = tfield.net_layout(8, mr, mv)
            plans = (tgrad.input_smem_bytes(), tgrad.stash_smem_bytes(L),
                     tgrad.bwd_smem_bytes(L))
            ok = max(plans) <= tfield.SMEM_LIMIT
            assert (tgrad.train_refusal(L) is None) == ok, (mr, mv)
            fits += ok
    assert fits == 176


@pytest.mark.parametrize("mr,mv", [(9, 4), (4, 5), (7, 7), (15, 4)])
def test_pose_step_routes_plain_where_pass_c_refuses(mr, mv):
    """_fused_train_mode with fused_train on, at the layouts where pass (c)'s
    WMMA plan refused and sent the pose step to the plain pipeline: the
    weights-only step takes the kernels ("train") and the pose step too,
    input gradients included ("full"), on a CUDA-flagged batch as on the
    CPU's."""
    params = {"coarse": {"views_linears": [0]}}
    batch = {"rays_o": torch.zeros(8, 3), "skts": torch.zeros(2, 24, 4, 4),
             "kp_idx": torch.zeros(2, dtype=torch.long)}
    on = tt.TrainConfig(fused_train=True)
    cfg = tr.RaycastConfig(multires=mr, multires_views=mv)
    assert tt._fused_train_mode(cfg, on, params, batch) == "train"
    assert tt._fused_train_mode(cfg, dataclasses.replace(on, opt_pose=True), params,
                                batch) == "full"


@pytest.mark.parametrize("ppg", [0, 80])
@pytest.mark.parametrize("mr,mv,n_pts,groups", [(7, 4, 3072, 4), (9, 4, 1680, 3),
                                               (15, 4, 200, 1)])
def test_bwd_workspace_places_the_input_regions(mr, mv, n_pts, groups, ppg):
    """bwd_workspace's layout against csrc/field_grad.cu carve's formula:
    15 regions in order (pass (a)'s bf16 regions, gzv in f32, the bias,
    split-product and view-bias partials; with input gradients d_dirs per
    point, the pose partials, then g_e_pts (p_pad x pc) and g_e_view (p_pad
    x vc) in f32), each 256-byte aligned, p_pad whole 128-point tiles.
    Without input gradients (ppg 0) the last four are absent and the
    workspace is no larger than before them; with them, the two f32
    regions are views of the buffer with P rows."""
    L = tfield.net_layout(8, mr, mv)
    P = -(-n_pts // 128) * 128
    align = lambda n: -(-n // 256) * 256  # noqa: E731
    splits = max(1, min(16, n_pts // 2048))
    # pass (b)'s 128 x 256 tiles: 8 products 256 x 256 (7 trunk layers' h
    # columns, the feature layer), 2 of 256 x pc (layer 0, the skip consumer's
    # e_pts columns), the view layer's 128 x 256 and 128 x vc, the heads' 1 each
    tiles = 2 * 8 + 2 * 2 * -(-L.pc // 256) + 1 + -(-L.vc // 256) + 2
    sizes = [2 * 8 * P * 256, 2 * P * 256, 2 * P * 128, 2 * 8 * P * 256, 2 * P * 256,
             2 * P * 128, 2 * P * 16, 4 * P * 128, 4 * (P // 64) * (8 * 256 + 260),
             4 * tiles * splits * 128 * 256, 4 * groups * -(-(n_pts // groups) // 256) * 128]
    if ppg:
        slots = min(64, 63 // ppg + 2)
        sizes += [4 * P * 3, 4 * -(-n_pts // 64) * slots * 288, 4 * P * L.pc, 4 * P * L.vc]
    offsets = [sum(align(n) for n in sizes[:k]) for k in range(len(sizes))]
    n_ws, p_pad, off = tgrad.bwd_workspace_plan(n_pts, L, groups, ppg)
    assert (n_ws, p_pad) == (sum(map(align, sizes)), P)
    assert list(off) == list(tgrad.WS_REGIONS[:len(sizes)])
    assert list(off.values()) == offsets
    ws = tgrad.bwd_workspace(n_pts, L, groups, ppg, "cpu")
    assert ws.buf.numel() == n_ws and ws.buf.dtype == torch.uint8
    assert ("g_e_pts" in ws.regions) == ("g_e_view" in ws.regions) == bool(ppg)
    if not ppg:
        return
    base = ws.buf.data_ptr()
    for name, width in (("g_e_pts", L.pc), ("g_e_view", L.vc)):
        r = ws.regions[name]
        assert r.dtype == torch.float32 and tuple(r.shape) == (n_pts, width)
        assert r.stride() == (width, 1) and r.data_ptr() - base == off[name]
        assert off[name] + 4 * P * width <= n_ws
    assert n_ws - tgrad.bwd_workspace_plan(n_pts, L, groups, 0)[0] == sum(map(align, sizes[11:]))


@pytest.mark.parametrize("mr,mv", [(7, 4), (7, 7), (15, 4), (4, 2), (7, 0), (31, 31)])
def test_stash_plan_is_the_eval_plan(mr, mv):
    """The stash kernel stages no pose rows: its plan is the eval kernels'
    201,304 bytes at every layout, and it refuses nothing they take (7 / 7
    and 15 / 4, refused by its WMMA plan, included)."""
    L = tfield.net_layout(8, mr, mv)
    assert tgrad.stash_smem_bytes(L) == tfield.eval_smem_bytes(L) == EVAL_SMEM
    assert tgrad.field_stash_refusal(L) is None


def test_stash_refuses_past_64_octaves():
    """Past the pose operand's 64 octave weights the stash refuses as the
    eval kernels do, with their reason."""
    L = tfield.net_layout(8, 40, 30)
    reason = tgrad.field_stash_refusal(L)
    assert reason == tfield.field_eval_refusal(L) and "70" in reason
    assert tgrad.train_refusal(L) == reason
