"""posegen_tpu_torch kernels/field.py against posegen_tpu/kernels/field.py.

The plain kernel versions (what the wrappers run on the CPU) are held
against the JAX Pallas kernels run in interpret mode with float32 matmul
activations (MM_DTYPE = float32, as tests/test_fused_kernel.py does); both
sides use bf16-rounded weights, so the raws agree to float32 rounding. Also:
the gate against the JAX gate, the one-time named fallback warning, and the
wrapper contract on the CPU. The CUDA kernels themselves run in
chip_smoke.py on the card.
"""

import dataclasses
import functools
import glob
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_problem as j_make_problem
from posegen_tpu_torch.kernels import build
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_TOL = 1e-4  # max|diff| of raw, float32 rounding + the f32 transcendental ulps

CASES = {
    "flagship": {},
    "no_view_pe": dict(multires_views=0),
    "mean_code": dict(opt_framecode=True, n_framecodes=4),
    "freq_schedule": dict(freq_schedule=True),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX problem (8 rays x 16 samples) and its port twin."""
    kw = CASES[name]
    cfg, params, ctx, ro, rd = j_make_problem(jr.RaycastConfig(**kw), n_rays=8)
    if name == "freq_schedule":  # mid-anneal: fractional windows on both ladders
        params = dict(params)
        params["embed_kp"] = {**params["embed_kp"], "alpha": jnp.asarray(2.3)}
        params["embed_view"] = {**params["embed_view"], "alpha": jnp.asarray(1.7)}
    if name == "mean_code":
        ctx = ctx._replace(cam_idxs=None)
    z = np.sort(np.random.default_rng(3).uniform(0.5, 3.0, (8, 16)), -1)
    pts = (np.asarray(ro)[:, None] + np.asarray(rd)[:, None] * z[..., None]).astype(np.float32)
    port = (
        tr.RaycastConfig(**kw),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        tr.PoseCtx(*[None if a is None else torch.as_tensor(np.array(a)) for a in ctx]),
    )
    return (cfg, params, ctx), port, pts, np.array(rd)


def _jax_raw(name, mode):
    (cfg, params, ctx), _, pts, rd = _case(name)
    kw = dict(interpret=True, view_embed_state=params.get("embed_view"))
    if mode == "density_only":
        kw["density_only"] = True
    if mode == "dual":
        kw.update(density_only=True, dual_params=params["fine"])
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32
    try:
        out = jfield.fused_run_net(cfg, params["fine" if mode != "dual" else "coarse"],
                                   params["embed_kp"], jnp.asarray(pts), jnp.asarray(rd),
                                   ctx, **kw)
    finally:
        jfield.MM_DTYPE = orig
    return [np.asarray(o) for o in (out if mode == "dual" else (out,))]


@pytest.mark.parametrize("mode", ["full", "density_only", "dual"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_jax_kernels(name, mode):
    ref = _jax_raw(name, mode)
    _, (cfg, params, ctx), pts, rd = _case(name)
    with torch.no_grad():
        out = tfield.fused_run_net(
            cfg, params["fine" if mode != "dual" else "coarse"], params["embed_kp"],
            torch.as_tensor(pts), torch.as_tensor(rd), ctx,
            density_only=mode != "full", view_embed_state=params.get("embed_view"),
            dual_params=params["fine"] if mode == "dual" else None,
        )
    got = [o.numpy() for o in (out if mode == "dual" else (out,))]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(r).max() > 0.01  # a field with signal
        np.testing.assert_allclose(g, r, atol=RAW_TOL, rtol=0)
    if mode != "full":
        assert np.abs(got[0][..., :3]).max() == 0.0  # density-only rgb rows


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the wrappers return their plain version at float32 and
    count no launch."""
    _, (cfg, params, ctx), pts, rd = _case("flagship")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    pose = tfield.pack_pose(ctx.skts[0], params["embed_kp"], cfg.multires, cfg.multires_views)
    nc, nf = (tfield.prepare_net(params[k], L) for k in ("coarse", "fine"))
    p = torch.as_tensor(pts).reshape(-1, 3)
    d = torch.as_tensor(rd)
    tfield.reset_launches()
    with torch.no_grad():
        for density_only in (False, True):
            np.testing.assert_array_equal(
                tfield.fused_field(p, d, 16, pose, nf, density_only).numpy(),
                tfield.field_plain(p, d, 16, pose, nf, density_only).numpy())
        for a, b in zip(tfield.fused_dual(p, d, 16, pose, nc, nf),
                        tfield.dual_plain(p, d, 16, pose, nc, nf)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        # the dual's fine raw is the field kernel's, its coarse sigma the
        # density-only field's
        c, f = tfield.fused_dual(p, d, 16, pose, nc, nf)
        np.testing.assert_array_equal(f.numpy(), tfield.fused_field(p, d, 16, pose, nf).numpy())
        np.testing.assert_array_equal(
            c.numpy(), tfield.fused_field(p, d, 16, pose, nc, True).numpy())
    assert set(tfield.LAUNCHES.values()) == {0}
    assert nf.w.dtype == torch.bfloat16 and nf.b.dtype == torch.float32

    with pytest.raises(ValueError, match="rays"):
        tfield.fused_field(p, d[:4], 16, pose, nf)
    with pytest.raises(ValueError, match="pose"):
        tfield.fused_field(p, d, 16, pose[:-1], nf)
    with pytest.raises(ValueError, match="layout"):
        tfield.fused_dual(p, d, 16, pose, nc, tfield.FieldNet(
            nf.w, nf.b, dataclasses.replace(nf.layout, skip=-1)))


def test_net_layout():
    L = tfield.net_layout(8, 7, 4)
    assert (L.pc, L.vc, L.vcp) == (432, 648, 656)
    offsets = [L.w_alpha, L.w_feat, L.w_view, L.w_rgb, *L.w_layers]
    assert all(o % 16 == 0 for o in offsets)
    assert len(L.as_ints()) == 15 + 2 * 8
    assert tfield.net_layout(8, 7, 0).vcp == 80
    assert tfield.net_layout(4, 7, 4).skip == -1
    with pytest.raises(ValueError, match="skip after the last layer"):
        tfield.net_layout(5, 7, 4)
    # the packed size is the JAX net's parameter count (+ the view pad rows)
    _, (cfg, params, _), _, _ = _case("flagship")
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, params["fine"])))
    assert L.n_w + L.n_b == n_params + (L.vcp - L.vc) * tfield.VIEW_WIDTH


def _repo_configs():
    from posegen_tpu.cli.config import (
        args_to_raycast_config, nerf_config_parser, parse_with_config,
    )

    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.txt")))
    assert len(paths) >= 8
    cfgs = [args_to_raycast_config(parse_with_config(nerf_config_parser(), ["--config", p]),
                                   n_framecodes=4) for p in paths]
    base = jr.RaycastConfig()
    flips = dict(
        kp_dist_type="relpos", i_embed=-1, view_type="world", bone_type="axisang",
        multires_bones=2, use_cutoff=False, cutoff_viewdir=False, cutoff_inputs=False,
        cutoff_bones=True, use_viewdirs=False, n_joints=17, cut_to_dist=True,
        cutoff_shift=True, normalize_cutoff=True, netwidth=128, netwidth_fine=128,
        netdepth_fine=6, freq_schedule=True, single_net=True, multires_views=0,
    )
    cfgs += [dataclasses.replace(base, **{k: v}) for k, v in flips.items()]
    return cfgs


def test_gate_matches_jax_gate():
    """Every repo config (the set test_supports_fused_every_reference_config
    builds) and every single-flag variant of the flagship: same verdict and
    reason as the JAX gate."""
    n_ok = 0
    for jcfg in _repo_configs():
        tcfg = tr.RaycastConfig(**dataclasses.asdict(jcfg))
        reason = jfield.fused_config_disqualification(jcfg)
        assert tfield.fused_config_disqualification(tcfg) == reason
        n_ok += reason is None
    assert n_ok >= 8


def test_pose_and_dual_gates_match():
    (jcfg, jp, jctx), (tcfg, tp, tctx), _, _ = _case("flagship")
    assert tfield.fused_disqualification(tcfg, tctx, tp["coarse"]) is None
    multi_j = jctx._replace(kps=jnp.tile(jctx.kps, (3, 1, 1)),
                            skts=jnp.tile(jctx.skts, (3, 1, 1, 1)))
    multi_t = tctx._replace(kps=tctx.kps.repeat(3, 1, 1), skts=tctx.skts.repeat(3, 1, 1, 1))
    assert (tfield.fused_disqualification(tcfg, multi_t, tp["coarse"])
            == jfield.fused_disqualification(jcfg, multi_j, jp["coarse"]))
    two_views = {**tp["coarse"], "views_linears": tp["coarse"]["views_linears"] * 2}
    two_views_j = {**jp["coarse"], "views_linears": jp["coarse"]["views_linears"] * 2}
    assert (tfield.fused_disqualification(tcfg, tctx, two_views)
            == jfield.fused_disqualification(jcfg, jctx, two_views_j))
    for kw in ({}, dict(single_net=True), dict(N_importance=0)):
        jc, tc = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
        for jx, tx in ((jctx, tctx), (multi_j, multi_t)):
            assert (tfield.supports_dual_eval(tc, tx, tp["coarse"])
                    == jfield.supports_dual_eval(jc, jx, jp["coarse"]))


def test_fallback_warning_is_named_and_once():
    reason = tfield.fused_config_disqualification(tr.RaycastConfig(kp_dist_type="relpos"))
    assert "kp_dist_type" in reason
    where = "test-site-%d" % np.random.default_rng().integers(1 << 30)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tfield.warn_fused_fallback(where, reason)
        tfield.warn_fused_fallback(where, reason)
        tfield.warn_fused_fallback(where, "another reason")
    assert len(rec) == 2
    assert "kp_dist_type" in str(rec[0].message)
    assert "posegen_tpu_torch[" in str(rec[0].message)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The library is named by a hash of the sources; without nvcc the build
    raises a clear error (and creates nothing)."""
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libposegen_kernels_")
    assert path == build.library_path()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()
