"""The eval kernels' Hopper design (posegen_tpu_torch/kernels/csrc/field.cu)
on the CPU: the gate's depth and shared-memory refusals held against the JAX
package's render and trainer routes, the kernels' plans pinned to the C++
formulas, and the persistent grid's walk over the tiles.

The kernels run only on the card; there chip_smoke.py holds each plan here
against the library's export (posegen_field_eval_smem, ..._slot_bytes,
..._eval_grid, posegen_field_stash_smem, posegen_field_variant_smem)."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_problem as j_make_problem
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.kernels import variants as tvar
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train import trainer as tt
from posegen_tpu_torch.utils.convert import params_from_numpy

N_RAYS = 4
TINY = dict(N_samples=8, N_importance=4)
EVAL = dict(perturb=0.0, raw_noise_std=0.0)
FLAGSHIP_SMEM = 201_304  # the eval kernels' plan at every layout
# the layouts whose stash plan outgrows an H100 block: (multires, multires_views) -> bytes
STASH_TOO_BIG = {(7, 7): 240_128, (15, 4): 233_984}


@functools.lru_cache(maxsize=None)
def _problem(depth: int):
    kw = dict(TINY, netdepth=depth)
    cfg, params, ctx, ro, rd = j_make_problem(jr.RaycastConfig(**kw), n_rays=N_RAYS, seed=2)
    port = (
        tr.RaycastConfig(**kw),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        tr.PoseCtx(*[None if a is None else torch.as_tensor(np.array(a)) for a in ctx]),
        torch.as_tensor(np.array(ro)), torch.as_tensor(np.array(rd)),
    )
    return (cfg, params, ctx, ro, rd), port


@pytest.mark.parametrize("depth,depth_fine", [(17, None), (17, 17), (0, None), (5, None)])
def test_gate_refuses_nets_the_kernels_do_not_take(depth, depth_fine):
    """A depth outside 1..MAX_DEPTH (netdepth or netdepth_fine) and the skip
    after the last layer: the port's gate names the depth; the JAX gate,
    whose kernels take them, passes them."""
    kw = dict(netdepth=depth, netdepth_fine=depth_fine)
    reason = tfield.fused_config_disqualification(tr.RaycastConfig(**kw))
    assert reason is not None and f"netdepth={depth}" in reason
    assert jfield.fused_config_disqualification(jr.RaycastConfig(**kw)) is None
    (_, _, _, _, _), (tcfg, tp, tctx, _, _) = _problem(8)
    assert tfield.fused_disqualification(dataclasses.replace(tcfg, **kw), tctx,
                                         tp["coarse"]) == reason


@pytest.mark.parametrize("depth", [17, 20])
def test_render_falls_back_once_and_matches_jax(depth):
    """render_rays(use_fused=True) on a net the kernels do not take: one
    named warning per process, then the plain pipeline, which holds to JAX's
    render of the same net through its fused kernels (interpret mode, f32
    activations) and through XLA."""
    (jcfg, jp, jctx, jro, jrd), (tcfg, tp, tctx, tro, trd) = _problem(depth)
    tfield._WARNED_FALLBACKS.discard(("render_rays", tfield.fused_config_disqualification(tcfg)))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with torch.no_grad():
            outs = [tr.render_rays(tcfg, tp, tro, trd, tctx, use_fused=True, **EVAL)
                    for _ in range(2)]
    named = [w for w in rec if "posegen_tpu_torch[render_rays]" in str(w.message)]
    assert len(named) == 1 and f"netdepth={depth}" in str(named[0].message)
    got = {k: v.numpy() for k, v in outs[0].items()}
    assert 0.0 < got["acc_map"].mean()
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32
    try:
        ref_fused = jr.render_rays(jcfg, jp, jro, jrd, jctx, use_fused=True, **EVAL)
    finally:
        jfield.MM_DTYPE = orig
    ref_xla = jr.render_rays(jcfg, jp, jro, jrd, jctx, use_fused=False, **EVAL)
    for k in ("rgb_map", "disp_map", "acc_map"):
        np.testing.assert_allclose(got[k], np.asarray(ref_xla[k]), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(ref_fused[k]), atol=1e-3, rtol=0,
                                   err_msg=k)
        np.testing.assert_array_equal(outs[1][k].numpy(), got[k])


def test_train_mode_is_plain_where_the_kernels_refuse():
    """_fused_train_mode: False at depth 17 and at the two layouts whose
    stash plan outgrows a block, with fused_train on; the kernels' route at
    the flagship."""
    params = {"coarse": {"views_linears": [0]}}
    batch = {"rays_o": torch.zeros(8, 3), "skts": torch.zeros(2, 24, 4, 4),
             "kp_idx": torch.zeros(2, dtype=torch.long)}
    on = tt.TrainConfig(fused_train=True)
    assert tt._fused_train_mode(tr.RaycastConfig(), on, params, batch) == "train"
    assert tt._fused_train_mode(tr.RaycastConfig(), dataclasses.replace(on, opt_pose=True),
                                params, batch) == "full"
    refused = [tr.RaycastConfig(netdepth=17), tr.RaycastConfig(netdepth=17, netdepth_fine=17)]
    refused += [tr.RaycastConfig(multires=m, multires_views=v) for m, v in STASH_TOO_BIG]
    for cfg in refused:
        assert tt._fused_train_mode(cfg, on, params, batch) is False
        assert tt._fused_train_mode(cfg, dataclasses.replace(on, opt_pose=True), params,
                                    batch) is False


def test_stash_plan_and_refusal():
    """The stash kernel's plan (field.cuh smem_bytes at 64 points with the
    view): 184,832 bytes at the flagship; the two layouts past the block's
    232,448 refused with their sizes; the eval kernels take both."""
    L = tfield.net_layout(8, 7, 4)
    assert tgrad.stash_smem_bytes(L) == 184_832 and tgrad.field_stash_refusal(L) is None
    assert tgrad.train_refusal(L) is None
    for (m, v), need in STASH_TOO_BIG.items():
        Lb = tfield.net_layout(8, m, v)
        assert tgrad.stash_smem_bytes(Lb) == need
        reason = tgrad.field_stash_refusal(Lb)
        assert f"needs {need} bytes" in reason and f"multires={m}" in reason
        assert tgrad.train_refusal(Lb) == reason
        assert tfield.field_eval_refusal(Lb) is None
        assert tfield.fused_config_disqualification(
            tr.RaycastConfig(multires=m, multires_views=v)) is None
    assert tgrad.stash_smem_bytes(tfield.net_layout(8, 4, 2)) == 129_536
    # the formula: pose | 64 rows of (pc + 8) + (vcp + 8) + (256 + 8) bf16 | scratch
    assert tgrad.stash_smem_bytes(L) == 1536 + 2 * 64 * (440 + 664 + 264) + 8192


def test_eval_plan_fits_every_depth_and_layout():
    """The eval kernels' plan is 201,304 bytes at every depth 1..16 and every
    multires: it refuses nothing the depth gate lets through; only octave
    weights past the pose operand's 64 are refused."""
    for depth in range(1, tfield.MAX_DEPTH + 1):
        if depth == 5:  # the skip after the last layer: no such layout
            continue
        for m, v in ((7, 4), (4, 2), (7, 0), (7, 7), (15, 4), (31, 31)):
            L = tfield.net_layout(depth, m, v)
            assert tfield.eval_smem_bytes(L) == FLAGSHIP_SMEM <= tfield.SMEM_LIMIT
            assert tfield.field_eval_refusal(L) is None
    assert FLAGSHIP_SMEM == 1024 + 65_536 + 3 * 32_768 + 2 * 16_384 + 1536 + 2048 + 11 * 8
    reason = tfield.field_eval_refusal(tfield.net_layout(8, 40, 30))
    assert "70" in reason and "64 octave weights" in reason
    assert "70" in tfield.fused_config_disqualification(
        tr.RaycastConfig(multires=40, multires_views=30))


def test_eval_slot_bytes():
    """One slot: 128 rows of e_pts and e_view bf16 in the stash layout."""
    L = tfield.net_layout(8, 7, 4)
    assert tfield.eval_slot_bytes(L) == 2 * 128 * (432 + 648) == 276_480
    assert 132 * tfield.eval_slot_bytes(L) == 36_495_360  # the scratch on an H100 SXM
    assert tfield.eval_slot_bytes(tfield.net_layout(8, 4, 2)) == 2 * 128 * (288 + 360)


@pytest.mark.parametrize("n_pts,n_slots", [(1, 132), (127, 132), (128, 132), (129, 132),
                                           (16016, 132), (131_056, 132), (300, 2)])
def test_eval_tile_walk_covers_every_point_once(n_pts, n_slots):
    """The persistent grid: min(tiles, slots) blocks, block b walking tiles
    b, b + grid, ...: every point in exactly one tile, every tile whole but
    the last."""
    walk = tfield.eval_tile_walk(n_pts, n_slots)
    n_tiles = -(-n_pts // 128)
    assert len(walk) == min(n_tiles, n_slots)
    seen = np.zeros(n_pts, dtype=int)
    for b, tiles in enumerate(walk):
        starts = [r.start for r in tiles]
        assert starts == [128 * t for t in range(b, n_tiles, len(walk))]
        for r in tiles:
            assert len(r) == 128 or r.stop == n_pts
            seen[r.start:r.stop] += 1
    assert (seen == 1).all()


def test_variant_plan_and_refusal():
    """The variant kernel's plan is the WMMA body's; tile 128 with the view
    is refused with its size, as the harness skips it."""
    L = tfield.net_layout(8, 7, 4)
    for tile in tvar.TILES:
        for dens in (False, True):
            assert tvar.variant_smem_bytes(L, tile, dens) == tfield.body_smem_bytes(
                L, tile, not dens)
    assert "359,936 bytes" in tvar.variant_smem_refusal(L, 128)
    assert tvar.variant_smem_refusal(L, 128, density_only=True) is None
    assert tvar.variant_smem_refusal(L, 64) is None
