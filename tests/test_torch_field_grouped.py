"""posegen_tpu_torch kernels/field.py's grouped-pose eval and per-ray view
ladder against posegen_tpu/kernels/field.py.

The JAX kernel runs in interpret mode with float32 matmul activations
(MM_DTYPE = float32, as tests/test_fused_kernel.py does); the port's wrappers
run their plain versions on the CPU. Grouped eval: G pose rows, 16 rays x 8
samples a group (128 points: JAX's smallest grouped tile), full and
density-only, framecodes per group or the mean code, BARF windows mid-anneal;
`render_rays(use_fused=True)` on a grouped batch; the ray ladder at JAX's own
shapes and tolerances (tests/test_fused_kernel.py:415-455); the refusals
both packages share; and render_rays' route on a grouped batch. The CUDA
kernels run in chip_smoke.py (phase 17) on the card.
"""

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
from posegen_tpu.utils.fixtures import make_pose_ctx, make_problem, make_rays
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import params_from_numpy

RAW_TOL = 1e-4  # as tests/test_torch_field.py
RENDER_TOL = 1e-4  # as tests/test_torch_render.py's fused render
RPG, S = 16, 8  # rays per group, samples per ray: 128 points a group

# name -> (RaycastConfig flags, pose groups, framecode index per group or None)
CASES = {
    "g2": ({}, 2, None),
    "g3": ({}, 3, None),
    "framecode_g3": (dict(opt_framecode=True, n_framecodes=4), 3, (0, 2, 3)),
    "mean_code_g2": (dict(opt_framecode=True, n_framecodes=4), 2, None),
    "freq_schedule_g2": (dict(freq_schedule=True), 2, None),
}


def _with_alphas(params):
    """BARF windows mid-anneal: fractional weights on both ladders."""
    params = dict(params)
    params["embed_kp"] = {**params["embed_kp"], "alpha": jnp.asarray(2.3)}
    params["embed_view"] = {**params["embed_view"], "alpha": jnp.asarray(1.7)}
    return params


def _port_ctx(ctx):
    return tr.PoseCtx(*[None if a is None else torch.as_tensor(np.array(a)) for a in ctx])


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX (cfg, params, grouped ctx), its port twin, the points (N, S, 3)
    and ray directions: G groups of RPG rays, contiguous, cylinders and
    framecode indices per ray."""
    kw, G, codes = CASES[name]
    N = G * RPG
    cfg = jr.RaycastConfig(**kw)
    params = jr.init_raycaster(jax.random.PRNGKey(0), cfg)
    if kw.get("freq_schedule"):
        params = _with_alphas(params)
    ctx = make_pose_ctx(seed=0, n_poses=G)
    cam = None if codes is None else np.repeat(np.array(codes, np.int32)[:, None], RPG, 0)
    ctx = ctx._replace(cyls=jnp.repeat(ctx.cyls, RPG, 0),
                       cam_idxs=None if cam is None else jnp.asarray(cam))
    ro, rd = (np.array(a) for a in make_rays(N, seed=1))
    z = np.sort(np.random.default_rng(3).uniform(0.5, 3.0, (N, S)), -1)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    port = (tr.RaycastConfig(**kw),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
            _port_ctx(ctx))
    return (cfg, params, ctx), port, pts, rd


def _jax_f32(fn, *args, **kw):
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32
    try:
        return fn(*args, **kw)
    finally:
        jfield.MM_DTYPE = orig


@functools.lru_cache(maxsize=None)
def _jax_raw(name, density_only):
    (cfg, params, ctx), _, pts, rd = _case(name)
    out = _jax_f32(jfield.fused_run_net, cfg, params["fine"], params["embed_kp"],
                   jnp.asarray(pts), jnp.asarray(rd), ctx, interpret=True,
                   density_only=density_only, view_embed_state=params.get("embed_view"),
                   eval_mean_code=ctx.cam_idxs is None)
    return np.asarray(out)


def _port_raw(name, density_only, **kw):
    _, (cfg, params, ctx), pts, rd = _case(name)
    with torch.no_grad():
        return tfield.fused_run_net(
            cfg, params["fine"], params["embed_kp"], torch.as_tensor(pts), torch.as_tensor(rd),
            ctx, density_only=density_only, view_embed_state=params.get("embed_view"),
            eval_mean_code=ctx.cam_idxs is None, **kw).numpy()


@pytest.mark.parametrize("density_only", [False, True], ids=["full", "density_only"])
@pytest.mark.parametrize("name", list(CASES))
def test_grouped_eval_matches_jax(name, density_only):
    ref = _jax_raw(name, density_only)
    tfield.reset_launches()
    got = _port_raw(name, density_only)
    assert set(tfield.LAUNCHES.values()) == {0}  # the CPU runs the plain version
    assert got.shape == ref.shape == (CASES[name][1] * RPG, S, 4)
    assert np.abs(ref[..., 3]).max() > 0.01  # a field with signal
    np.testing.assert_allclose(got, ref, atol=RAW_TOL, rtol=0)
    if density_only:
        assert np.abs(got[..., :3]).max() == 0.0
    else:
        # each group reads its own pose (and code): no two groups' raws alike
        g = got.reshape(CASES[name][1], -1)
        assert not np.allclose(g[0], g[1], atol=1e-3)


def test_grouped_plain_is_single_pose_plains():
    """The grouped plain version on G groups is the single-pose plain version
    on each group with its pose and its code folded by `prepare_net`, bit
    for bit (on the card chip_smoke holds the kernels to the same)."""
    _, (cfg, params, ctx), pts, rd = _case("framecode_g3")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    poses = tfield.pack_poses(ctx.skts, params["embed_kp"], cfg.multires, cfg.multires_views)
    codes = tfield._group_codes(params["fine"], ctx, 3, 3 * RPG, cfg.framecode_ch, False)
    net, bview = tfield.prepare_net_grouped(params["fine"], L, codes)
    assert bview.shape == (3, tfield.VIEW_WIDTH)
    p, d = torch.as_tensor(pts).reshape(-1, 3), torch.as_tensor(rd)
    n = RPG * S
    with torch.no_grad():
        for density_only in (False, True):
            got = tfield.fused_field(p, d, S, poses, net, density_only, bview=bview)
            for g in range(3):
                one = tfield.fused_field(p[g * n:(g + 1) * n], d[g * RPG:(g + 1) * RPG], S,
                                         poses[g], tfield.prepare_net(params["fine"], L, codes[g]),
                                         density_only)
                assert torch.equal(got[g * n:(g + 1) * n], one)
        # without framecodes: one view-bias row, the packed one
        _, (_, params2, _), _, _ = _case("g3")
        net2, bview2 = tfield.prepare_net_grouped(params2["fine"], L)
        assert torch.equal(bview2, net2.b[L.b_view:L.b_view + tfield.VIEW_WIDTH][None])
        with pytest.raises(ValueError, match="view bias"):
            tfield.fused_field(p, d, S, poses, net2)
        with pytest.raises(ValueError, match="view bias"):
            tfield.fused_field(p, d, S, poses, net2, bview=bview.repeat(2, 1))
        with pytest.raises(ValueError, match="table of pose groups"):
            tfield.fused_field(p, d, S, poses[0], net2, bview=bview2)


@functools.lru_cache(maxsize=None)
def _render_case():
    """Two groups of 8 rays at full width (64 + 16 samples, two 8x256 nets:
    512 and 640 points a group), seed 2 (both nets render, as in
    tests/test_torch_render.py)."""
    G, rpg = 2, 8
    cfg, params, _, ro, rd = make_problem(jr.RaycastConfig(), n_rays=G * rpg, seed=2)
    ctx = make_pose_ctx(seed=2, n_poses=G)
    ctx = ctx._replace(cyls=jnp.repeat(ctx.cyls, rpg, 0))
    port = (tr.RaycastConfig(),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
            _port_ctx(ctx), torch.as_tensor(np.array(ro)), torch.as_tensor(np.array(rd)))
    return (cfg, params, ctx, ro, rd), port


def test_grouped_render_matches_jax():
    """render_rays(use_fused=True, coarse_rgb=False) on a grouped batch: the
    grouped density-only pass, then the grouped full pass on all 80 samples
    (no dual pass for G > 1, in both packages)."""
    (jcfg, jp, jctx, jro, jrd), (tcfg, tp, tctx, tro, trd) = _render_case()
    kw = dict(perturb=0.0, raw_noise_std=0.0, coarse_rgb=False)
    ref = _jax_f32(jr.render_rays, jcfg, jp, jro, jrd, jctx, use_fused=True, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an explicit True takes the grouped batch
        with torch.no_grad():
            got = tr.render_rays(tcfg, tp, tro, trd, tctx, use_fused=True, **kw)
    assert 0.05 < float(got["acc_map"].mean()) < 0.99
    for k in ("rgb_map", "disp_map", "acc_map", "acc0", "disp0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=RENDER_TOL, rtol=0,
                                   err_msg=k)
    # the plain pipeline on the per-ray expansion of the groups' pose rows
    rep = lambda a: a.repeat_interleave(8, 0)  # noqa: E731
    per_ray = tctx._replace(kps=rep(tctx.kps), skts=rep(tctx.skts), bones=rep(tctx.bones))
    with torch.no_grad():
        plain = tr.render_rays(tcfg, tp, tro, trd, per_ray, use_fused=False, **kw)
    np.testing.assert_allclose(got["rgb_map"].numpy(), plain["rgb_map"].numpy(), atol=1e-3)


@pytest.mark.parametrize("flags,tol", [({}, 1e-6), (dict(freq_schedule=True, init_freq=0.0), 1e-5)],
                         ids=["flagship", "freq_schedule"])
def test_ray_ladder_matches_jax(flags, tol):
    """fused_run_net(ray_ladder=True) against JAX's at JAX's shapes and
    tolerances (16 rays x 8 samples, N_importance 4); equal to the port's
    per-point mode; off where JAX turns it off."""
    cfg, params, ctx, ro, rd = make_problem(jr.RaycastConfig(N_samples=8, N_importance=4,
                                                             **flags), n_rays=16)
    if flags:
        params = _with_alphas(params)
    z = jnp.sort(jax.random.uniform(jax.random.PRNGKey(5), (16, 8), minval=0.5, maxval=2.0),
                 axis=-1)
    pts = ro[:, None] + rd[:, None] * z[..., None]
    ref = _jax_f32(jfield.fused_run_net, cfg, params["coarse"], params["embed_kp"], pts, rd, ctx,
                   interpret=True, view_embed_state=params.get("embed_view"), ray_ladder=True)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tcfg = tr.RaycastConfig(N_samples=8, N_importance=4, **flags)
    args = (tcfg, tp["coarse"], tp["embed_kp"], torch.as_tensor(np.array(pts)),
            torch.as_tensor(np.array(rd)), _port_ctx(ctx))
    with torch.no_grad():
        got = tfield.fused_run_net(*args, view_embed_state=tp.get("embed_view"), ray_ladder=True)
        per_point = tfield.fused_run_net(*args, view_embed_state=tp.get("embed_view"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    assert torch.equal(got, per_point)

    # the plain versions: the per-ray ladder is the per-point one, repeated
    L = tfield.net_layout(tcfg.netdepth, tcfg.multires, tcfg.multires_views)
    pose = tfield.pack_pose(args[5].skts[0], tp["embed_kp"], L.nf_kp, L.nf_view)
    p, d = args[3].reshape(-1, 3), args[4]
    for a, b in zip(tfield.encode_plain(p, d, 8, pose, L.nf_kp, L.nf_view, ray_ladder=True),
                    tfield.encode_plain(p, d, 8, pose, L.nf_kp, L.nf_view)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ray ladder"):
        tfield.fused_field(p, d, 8, pose, tfield.prepare_net(tp["coarse"], L), True,
                           ray_ladder=True)


def test_ray_ladder_rules_follow_jax():
    """The ladder runs where JAX runs it: S >= 2 with a ray tile, full raw,
    one pose group; ray_tile as JAX's."""
    for s in range(1, 200):
        assert tfield.ray_tile(s) == jfield.ray_tile(s), s
    calls = []
    orig = tfield.fused_field

    def spy(*a, **kw):
        calls.append((a[3].dim(), kw.get("ray_ladder", False)))
        return orig(*a, **kw)

    _, (cfg, params, ctx), pts, rd = _case("g2")
    one = ctx._replace(kps=ctx.kps[:1], skts=ctx.skts[:1], bones=ctx.bones[:1],
                       cyls=ctx.cyls[:1])
    p = torch.as_tensor(pts)
    d = torch.as_tensor(rd)
    try:
        tfield.fused_field = spy
        with torch.no_grad():
            run = functools.partial(tfield.fused_run_net, cfg, params["fine"],
                                    params["embed_kp"], ray_ladder=True)
            run(p, d, one)  # S = 8: on
            run(p, d, one, density_only=True)  # off: no view pass
            run(p, d, ctx)  # off: two pose groups
            run(p[:, :1], d, one)  # off: S = 1
            run(torch.cat([p, p, p[:, :1]], 1), d, one)  # off: ray_tile(17) is None
            run(p, d, one, ray_ladder=None)  # off by default
    finally:
        tfield.fused_field = orig
    assert calls == [(1, True), (1, False), (2, False), (1, False), (1, False), (1, False)]


def test_refusals_match_jax():
    """N % G, the dual pass on G > 1 and points per group that no JAX tile
    divides: the same ValueError in both packages, in JAX's order."""
    (jcfg, jp, jctx), (tcfg, tp, tctx), pts, rd = _case("g2")
    jrun = functools.partial(jfield.fused_run_net, jcfg, jp["fine"], jp["embed_kp"],
                             interpret=True)
    trun = functools.partial(tfield.fused_run_net, tcfg, tp["fine"], tp["embed_kp"])
    for sl, kw, match in (
            ((slice(0, 31), slice(None)), {}, r"rays \(31\) not divisible into 2 pose groups"),
            ((slice(None), slice(None)), dict(density_only=True, dual_params="fine"),
             "single-group eval pass"),
            ((slice(None), slice(0, 6)), {}, r"points per group \(96\) not a multiple"),
            ((slice(0, 31), slice(None)), dict(density_only=True, dual_params="fine"),
             "not divisible"),
    ):
        p, d = pts[sl], rd[sl[0]]
        for run, params, cast in ((jrun, jp, jnp.asarray), (trun, tp, torch.as_tensor)):
            call_kw = dict(kw)
            if "dual_params" in kw:
                call_kw["dual_params"] = params["fine"]
            ctx = jctx if run is jrun else tctx
            with pytest.raises(ValueError, match=match):
                with torch.no_grad():
                    run(cast(np.array(p)), cast(np.array(d)), ctx, **call_kw)


def test_route_on_a_grouped_batch(monkeypatch):
    """An explicit use_fused=True takes a grouped batch without a warning;
    the automatic route on the card warns once, by name, and takes the plain
    pipeline, as JAX's automatic route does; on the CPU it takes the plain
    pipeline without a word. The config checks still refuse an explicit
    True."""
    monkeypatch.setattr(tfield, "_WARNED_FALLBACKS", set())
    _, (cfg, params, ctx), _, _ = _case("g2")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tr.fused_route(cfg, ctx, params["coarse"], True, on_card=True)
        assert tr.fused_route(cfg, ctx, params["coarse"], True, on_card=False)
        assert not rec
        assert not tr.fused_route(cfg, ctx, params["coarse"], None, on_card=False)
        assert not rec
        for _ in range(2):
            assert not tr.fused_route(cfg, ctx, params["coarse"], None, on_card=True)
        assert len(rec) == 1 and "2 pose groups" in str(rec[0].message)
        assert "render_rays" in str(rec[0].message)
        bad = dataclasses.replace(cfg, kp_dist_type="relpos")
        assert not tr.fused_route(bad, ctx, params["coarse"], True, on_card=True)
        assert len(rec) == 2 and "kp_dist_type" in str(rec[1].message)
    one = ctx._replace(kps=ctx.kps[:1], skts=ctx.skts[:1], bones=ctx.bones[:1])
    assert tr.fused_route(cfg, one, params["coarse"], None, on_card=True)
