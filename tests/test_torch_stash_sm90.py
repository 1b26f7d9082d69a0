"""The training kernels' shared-memory plans on the CPU: the backward's
input-gradient pass (c) (posegen_tpu_torch/kernels/csrc/field_grad.cu
input_smem_bytes) and its refusal, which the trainer consults before a pose
step takes the kernels, and the stash kernel's plan, the eval kernels' own
since the stash runs as their stash mode (csrc/field.cu).

The kernels run only on the card; there chip_smoke.py holds each plan here
against the library's export (posegen_field_bwd_input_smem,
posegen_field_stash_smem) and a refused layout's field_backward(inputs=...)
against its named ValueError. The JAX kernels take every layout, so each
refusal is a difference of route, not of result (tests/test_torch_train.py
holds a refused pose step against the JAX step)."""

import dataclasses

import pytest
import torch

from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train import trainer as tt

EVAL_SMEM = 201_304  # the eval kernels' plan at every layout

# (multires, multires_views) -> pass (c)'s bytes: the flagship and 8 / 4 fit
# an H100 block (232,448 bytes), the rest do not
PASS_C = {(7, 4): 223_744, (8, 4): 228_864, (9, 4): 241_152, (4, 5): 260_608,
          (7, 7): 334_336}


@pytest.mark.parametrize("mr,mv", list(PASS_C))
def test_input_plan_and_refusal(mr, mv):
    """Pass (c)'s plan at depth 8, its refusal (naming the multires values
    and the bytes) past the block, and train_refusal: the same as without
    input gradients where pass (c) fits, pass (c)'s reason where it does
    not (the stash kernel and pass (a) take every one of these)."""
    L = tfield.net_layout(8, mr, mv)
    need = PASS_C[(mr, mv)]
    assert tgrad.input_smem_bytes(L) == need
    reason = tgrad.field_input_refusal(L)
    assert tgrad.train_refusal(L) is None
    if need <= tfield.SMEM_LIMIT:
        assert reason is None and tgrad.train_refusal(L, input_grads=True) is None
    else:
        assert f"multires={mr}, multires_views={mv}" in reason and f"needs {need} bytes" in reason
        assert tgrad.train_refusal(L, input_grads=True) == reason


def test_input_plan_formula():
    """The C++ formula: the larger of [gz0 | gz5 (64 x 264 bf16 each) |
    g_e_pts (64 x pc f32)] and [gzv (64 x 136 bf16) | g_e_view (64 x vcp
    f32)], then 64 x 24 x 6 f32 of chain-rule state and 64 x 6 f32 of pts
    and dirs."""
    for mr, mv in ((7, 4), (4, 2), (7, 0), (15, 4), (1, 10)):
        L = tfield.net_layout(8, mr, mv)
        kp = 2 * 2 * 64 * 264 + 4 * 64 * L.pc
        view = 2 * 64 * 136 + 4 * 64 * L.vcp
        assert tgrad.input_smem_bytes(L) == max(kp, view) + 4 * (64 * 24 * 6 + 64 * 6)


def test_no_layout_passes_the_gate_and_fails_to_launch():
    """Depth 8, multires 1-16, multires_views 0-10: the input-gradient
    training plans pass a layout exactly when every one of its kernels'
    plans fits a block: pass (c)'s, the stash kernel's and pass (a)'s. Of
    these 176 layouts 40 fit pass (c)."""
    fits = 0
    for mr in range(1, 17):
        for mv in range(11):
            L = tfield.net_layout(8, mr, mv)
            plans = (tgrad.input_smem_bytes(L), tgrad.stash_smem_bytes(L),
                     tgrad.bwd_smem_bytes(L))
            ok = max(plans) <= tfield.SMEM_LIMIT
            assert (tgrad.train_refusal(L, input_grads=True) is None) == ok, (mr, mv)
            assert tgrad.train_refusal(L) is None  # the weights-only kernels take all
            fits += ok
    assert fits == 40


@pytest.mark.parametrize("mr,mv", [(9, 4), (4, 5), (7, 7), (15, 4)])
def test_pose_step_routes_plain_where_pass_c_refuses(mr, mv):
    """_fused_train_mode with fused_train on at a layout pass (c) refuses:
    the weights-only step takes the kernels ("train"), the pose step the
    plain pipeline (False)."""
    params = {"coarse": {"views_linears": [0]}}
    batch = {"rays_o": torch.zeros(8, 3), "skts": torch.zeros(2, 24, 4, 4),
             "kp_idx": torch.zeros(2, dtype=torch.long)}
    on = tt.TrainConfig(fused_train=True)
    cfg = tr.RaycastConfig(multires=mr, multires_views=mv)
    assert tt._fused_train_mode(cfg, on, params, batch) == "train"
    assert tt._fused_train_mode(cfg, dataclasses.replace(on, opt_pose=True), params,
                                batch) is False


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
