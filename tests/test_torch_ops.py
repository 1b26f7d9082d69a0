"""posegen_tpu_torch ops, models and encode slice against posegen_tpu:
sampling (with pre-drawn noise), the cutoff embedder, encode_inputs and the
compositor, on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.models import nerf as jnerf
from posegen_tpu.ops import embedding as jemb
from posegen_tpu.ops import sampling as jsamp
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_problem as j_make_problem
from posegen_tpu_torch.models import nerf as tnerf
from posegen_tpu_torch.ops import embedding as temb
from posegen_tpu_torch.ops import sampling as tsamp
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import params_from_numpy

T = torch.as_tensor


def _np(x):
    return np.array(x)  # a writable copy: torch.as_tensor warns on read-only arrays


def _rays(n, seed):
    """Rays on a ring around the origin; the last quarter point away from
    the body so that they miss its bounding cylinder."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([2 * np.cos(theta), rng.uniform(-0.5, 0.5, n), 2 * np.sin(theta)], -1)
    d = -o + rng.uniform(-0.3, 0.3, (n, 3))
    d[3 * n // 4:] *= -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_near_far_in_cylinder_with_misses():
    o, d = _rays(32, 0)
    cyl = np.tile(np.array([[0.05, -0.02, 0.45, 0.9, -1.1]], np.float32), (32, 1))
    jn, jf = jsamp.get_near_far_in_cylinder(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cyl))
    tn, tf = tsamp.get_near_far_in_cylinder(T(o), T(d), T(cyl))
    miss = np.asarray(jn)[24:, 0]
    assert np.allclose(miss, miss[0])  # misses took the mean of the hits
    np.testing.assert_allclose(tn.numpy(), _np(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tf.numpy(), _np(jf), atol=1e-5, rtol=0)

    # every ray misses: the originals stay
    far_cyl = cyl.copy()
    far_cyl[:, :2] = 50.0
    jn, jf = jsamp.get_near_far_in_cylinder(jnp.asarray(o), jnp.asarray(d), jnp.asarray(far_cyl))
    tn, tf = tsamp.get_near_far_in_cylinder(T(o), T(d), T(far_cyl))
    np.testing.assert_allclose(tn.numpy(), _np(jn), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), _np(jf), atol=1e-6)


@pytest.mark.parametrize("perturb,lindisp", [(0.0, False), (1.0, False), (1.0, True)])
def test_sample_from_lineseg(perturb, lindisp):
    rng = np.random.default_rng(1)
    near = rng.uniform(0.5, 1.0, (16, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, (16, 1)).astype(np.float32)
    noise = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    ref = jsamp.sample_from_lineseg(jnp.asarray(near), jnp.asarray(far), 24, perturb=perturb,
                                    lindisp=lindisp, det_noise=jnp.asarray(noise))
    got = tsamp.sample_from_lineseg(T(near), T(far), 24, perturb=perturb, lindisp=lindisp,
                                    det_noise=T(noise))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)


def _pdf_inputs(seed=2):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.5, 3.0, (16, 31)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (16, 30)).astype(np.float32)
    weights[:4] = 0.0  # flat pdf -> cdf steps of 1/30
    weights[4:8, 10:20] = 0.0  # a flat stretch of the cdf (steps below 1e-5)
    return bins, weights


@pytest.mark.parametrize("mode", ["det", "noise", "past_end"])
def test_sample_pdf(mode):
    bins, weights = _pdf_inputs()
    noise = None
    if mode == "noise":
        noise = np.random.default_rng(5).uniform(0, 1, (16, 20)).astype(np.float32)
    elif mode == "past_end":  # u at and beyond the last cdf entry
        noise = np.linspace(0.9, 1.2, 20, dtype=np.float32)[None].repeat(16, 0)
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 20, det=True,
                           det_noise=None if noise is None else jnp.asarray(noise))
    got = tsamp.sample_pdf(T(bins), T(weights), 20, det=True,
                           det_noise=None if noise is None else T(noise))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("is_only", [False, True])
def test_isample_from_lineseg(is_only):
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(0.5, 3.0, (16, 32)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (16, 32)).astype(np.float32) ** 3
    noise = rng.uniform(0, 1, (16, 12)).astype(np.float32)
    jz, js, ji = jsamp.isample_from_lineseg(jnp.asarray(z), jnp.asarray(w), 12, is_only=is_only,
                                            det_noise=jnp.asarray(noise))
    tz, ts, ti = tsamp.isample_from_lineseg(T(z), T(w), 12, is_only=is_only, det_noise=T(noise))
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tz.numpy(), _np(jz), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


def _embed_cases():
    base = dict(num_freqs=7, input_dims=24, cutoff=True, cutoff_dim=24, cutoff_inputs=True)
    return {
        "kp": (temb.EmbedConfig(**base), 24),
        "kp_barf": (temb.EmbedConfig(**base, freq_schedule=True), 24),
        "view": (temb.EmbedConfig(num_freqs=4, input_dims=72, cutoff=True, cutoff_dim=24,
                                  dist_inputs=True, cutoff_inputs=True), 72),
        "bone_plain": (temb.EmbedConfig(num_freqs=0, input_dims=72), 72),
        "no_cutoff_pe": (temb.EmbedConfig(num_freqs=3, input_dims=24), 24),
        "shift_cut": (temb.EmbedConfig(**{**base, "cutoff_inputs": False}, cut_to_dist=True,
                                       shift_inputs=True), 24),
    }


@pytest.mark.parametrize("case", list(_embed_cases()))
def test_embed_matches(case):
    tcfg, dims = _embed_cases()[case]
    jcfg = jemb.EmbedConfig(**dataclasses.asdict(tcfg))
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (4, 8, dims)).astype(np.float32)
    dists = rng.uniform(0, 1, (4, 8, 24)).astype(np.float32)
    state = {"tau": np.float32(20.0), "alpha": np.float32(2.4),
             "cutoff_dist": rng.uniform(0.2, 0.6, 24).astype(np.float32)}
    if not tcfg.cutoff:
        state = None
    jstate = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    tstate = None if state is None else params_from_numpy(state, "cpu")
    ref, rw = jemb.embed(jcfg, jnp.asarray(x), dists=jnp.asarray(dists), state=jstate)
    got, tw = temb.embed(tcfg, T(x), dists=T(dists), state=tstate)
    assert got.shape == ref.shape == (4, 8, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)
    assert (rw is None) == (tw is None)


def test_embed_schedules_match():
    cfg = temb.EmbedConfig(num_freqs=7, input_dims=24, cutoff=True, freq_schedule=True,
                           init_alpha=0.5)
    jcfg = jemb.EmbedConfig(**dataclasses.asdict(cfg))
    for step in (0, 1234, 400_000):
        np.testing.assert_allclose(float(temb.update_tau(cfg, step, 250, 10.0)),
                                   float(jemb.update_tau(jcfg, step, 250, 10.0)), rtol=1e-6)
        np.testing.assert_allclose(float(temb.update_alpha(cfg, step, 5, 6.0)),
                                   float(jemb.update_alpha(jcfg, step, 5, 6.0)), rtol=1e-6)


def _problem(cfg_kw, n_rays=8, n_samples=16, seed=0):
    jcfg = jr.RaycastConfig(**cfg_kw)
    _, params, ctx, ro, rd = j_make_problem(jcfg, n_rays=n_rays, seed=seed)
    z = np.sort(np.random.default_rng(9).uniform(0.5, 3.0, (n_rays, n_samples)), -1)
    pts = (np.asarray(ro)[:, None] + np.asarray(rd)[:, None] * z[..., None]).astype(np.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tctx = tr.PoseCtx(*[None if a is None else T(np.array(a)) for a in ctx])
    return jcfg, tr.RaycastConfig(**cfg_kw), params, tparams, ctx, tctx, pts, np.array(rd)


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(multires_views=0), dict(kp_dist_type="relpos"),
    dict(view_type="rayangle", bone_type="axisang"),
])
def test_encode_inputs_matches(cfg_kw):
    jcfg, tcfg, jp, tp, jctx, tctx, pts, rd = _problem(cfg_kw)
    jx, jv, jw = jr.encode_inputs(jcfg, jp, jnp.asarray(pts), jnp.asarray(rd), jctx)
    tx, tv, tw = tr.encode_inputs(tcfg, tp, T(pts), T(rd), tctx)
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cfg_kw", [{}, dict(opt_framecode=True, n_framecodes=4)])
def test_nerf_apply_matches(cfg_kw):
    jcfg, tcfg, jp, tp, jctx, tctx, pts, rd = _problem(cfg_kw)
    jx, jv, _ = jr.encode_inputs(jcfg, jp, jnp.asarray(pts), jnp.asarray(rd), jctx)
    fi = None
    if tcfg.opt_framecode:
        fi = np.zeros(pts.shape[:2] + (1,), np.int32)
        fi[:, :, 0] = np.arange(pts.shape[0])[:, None] % 4
    for mean in (False, True):
        ref = jnerf.nerf_apply(jcfg.nerf_cfg, jp["fine"], jx, jv,
                               None if fi is None else jnp.asarray(fi), mean)
        got = tnerf.nerf_apply(tcfg.nerf_cfg, tp["fine"], T(_np(jx)), T(_np(jv)),
                               None if fi is None else T(fi), mean)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_raw2outputs_matches():
    rng = np.random.default_rng(11)
    raw = rng.standard_normal((8, 20, 4)).astype(np.float32)
    raw[:2, :, 3] = -1.0  # empty rays: acc 0, disp 0
    z = np.sort(rng.uniform(0.5, 3.0, (8, 20)), -1).astype(np.float32)
    rd = rng.standard_normal((8, 3)).astype(np.float32)
    noise = rng.standard_normal((8, 20)).astype(np.float32) * 0.1
    for act_t, act_j, nz in ((torch.relu, jax.nn.relu, None),
                             (lambda x: torch.nn.functional.softplus(x - 1.0),
                              lambda x: jax.nn.softplus(x - 1.0), noise)):
        ref = jnerf.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                                noise=None if nz is None else jnp.asarray(nz), act_fn=act_j)
        got = tnerf.raw2outputs(T(raw), T(z), T(rd), noise=None if nz is None else T(nz),
                                act_fn=act_t)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_init_raycaster_layout_matches():
    """The port's own init gives the JAX tree's keys, shapes and embed states."""
    cfg = tr.RaycastConfig(opt_framecode=True, n_framecodes=3)
    jp = jr.init_raycaster(jax.random.PRNGKey(0), jr.RaycastConfig(opt_framecode=True,
                                                                   n_framecodes=3))
    tp = tr.init_raycaster(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), jp)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    for name in ("embed_kp", "embed_view"):
        for k in ("tau", "alpha", "cutoff_dist"):
            np.testing.assert_allclose(tp[name][k].numpy(), _np(jp[name][k]))
    up_j = jr.update_embed_states(jp, jr.RaycastConfig(), 5000)
    up_t = tr.update_embed_states(tp, tr.RaycastConfig(), 5000)
    np.testing.assert_allclose(float(up_t["embed_kp"]["tau"]), float(up_j["embed_kp"]["tau"]),
                               rtol=1e-6)
