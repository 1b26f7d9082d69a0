"""posegen_tpu_torch's GAN machinery, SPIN fine-tuning and feedback loop
against posegen_tpu's on the CPU.

The weights are drawn once and carried across by `utils/convert.py`; the
JAX noises and dropout masks are drawn with the JAX package's own key
splits and passed to the port (the trainer's `_draw_noises` is patched to
JAX's draws). JAX's NeRFRenderer is held on its one-device route
(`_render_fn = None`, as on one chip): the tests' 8 virtual CPU devices
would shard it.

The feedback frames are rendered at 96 x 96 with a window whose every ray
meets the pose cylinder (a precondition the test checks), so no ray takes
its chunk's mean near / far and JAX's padded chunk equals the port's
ragged one (PR 11's frame rule, tests/test_torch_image.py).

Tolerances, float32 on both sides: losses, stats and forward values to
1e-5 relative; Adam's moments, and the SPIN steps' gradients through a
ResNet-50, to 1e-4 relative L2 per leaf; the params' change over the Adam
steps to 1e-3 relative L2 per leaf (an element whose gradient is near 0 has
an ill-conditioned step: each is only bounded by the 2 x steps x lr Adam
can move it); f16 feedback frames to 1e-3 (one f16 ulp near 1), their PNGs
to 1 of 255; SPIN's joints and the probe to 1e-4. The generator's pre-BN
biases have an exactly-zero gradient (PRE_BN_BIAS) and are held by bounds.
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gen as tgen
from posegen_tpu.gen import discriminators as jd
from posegen_tpu.gen import gan as jgan
from posegen_tpu.gen import generators as jg
from posegen_tpu.gen import loop as jloop
from posegen_tpu.gen import spin_train as jst
from posegen_tpu.render import raycast as jr
from posegen_tpu.skeleton.rotations import axisang_to_rot as j_axisang_to_rot
from posegen_tpu_torch.gen import gan as tgan
from posegen_tpu_torch.gen import loop as tloop
from posegen_tpu_torch.gen import spin_train as tst
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import (
    discriminator_from_numpy, generator_from_numpy, hmr_from_numpy, params_from_numpy,
)

TOL = 1e-5
MOMENT_RTOL = 1e-4
UPDATE_RTOL = 1e-3
SPIN_GRAD_RTOL = 1e-4
FRAME_TOL = 1e-3
JOINT_TOL = 1e-4
TINY_GEN = jg.GenConfig(width=32, num_stages=1)
TINY_NERF = dict(N_samples=8, N_importance=0, netdepth=2, netwidth=32)
HW, FOCAL, CHUNK = 96, 400.0, 4096
WINDOW = (40, 56)  # the feedback crop: 16 x 16 rays, all on the pose cylinder
B = 8

assert_trees, t2n, np_tree = tgen.assert_trees, tgen.t2n, tgen.np_tree
# the biases of the generator's linears that feed a batch norm in train mode:
# BN subtracts the batch mean, so their gradient is exactly 0 and each
# package computes float32 rounding noise (|g| ~ 1e-9) that Adam turns into
# steps of up to lr, in either direction
PRE_BN_BIAS = ("['w_in']['b']", "['w1']['b']", "['w2']['b']")
NOISE_MU = 1e-8  # |Adam's mu| bound on those leaves (10x the noise's gradient)


def _pairs(tree, want):
    """[(keystr, port leaf, JAX leaf, pre-BN bias?)] of two trees."""
    g = jax.tree_util.tree_flatten_with_path(t2n(tree))[0]
    w = jax.tree_util.tree_flatten_with_path(np_tree(want))[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    return [(jax.tree_util.keystr(p), a, b, jax.tree_util.keystr(p).endswith(PRE_BN_BIAS))
            for (p, a), (_, b) in zip(g, w)]


def _assert_updates(params, want, init, n_steps, lr):
    """Params after n_steps Adam steps against JAX's: each leaf's change
    from `init` to UPDATE_RTOL relative L2 of JAX's change (an element whose
    gradient is near 0 has an ill-conditioned Adam step), every element
    within the 2 n_steps lr that Adam can move it; the pre-BN biases
    (PRE_BN_BIAS) only by that bound."""
    start = [np.asarray(a) for a in jax.tree_util.tree_leaves(init)]
    for (name, a, b, noisy), a0 in zip(_pairs(params, want), start, strict=True):
        assert np.abs(a - b).max() <= 2 * n_steps * lr, name
        assert noisy or _rel_l2(a - a0, b - a0) <= UPDATE_RTOL, name


def _assert_generator(params, want, init, mu, want_mu, nu, want_nu, state, want_state,
                      n_steps, lr):
    """A generator's params, Adam moments and BN state after n_steps
    against JAX's. The pre-BN biases' first moments sit at the noise level
    on both sides; every BN running mean includes its linear's bias, so it
    is held to TOL + momentum * n_steps * lr (a BN's output, and so every
    other leaf, does not depend on that bias)."""
    _assert_updates(params, want, init, n_steps, lr)
    for name, a, b, noisy in _pairs(mu, want_mu):
        if noisy:
            assert max(np.abs(a).max(), np.abs(b).max()) <= NOISE_MU, name
        else:
            assert _rel_l2(a, b) <= MOMENT_RTOL, name
    for name, a, b, noisy in _pairs(nu, want_nu):
        assert noisy or _rel_l2(a, b) <= MOMENT_RTOL, name
    for name, a, b, _ in _pairs(state, want_state):
        atol = TOL + (0.1 * n_steps * lr if name.endswith("['mean']") else 0.0)
        np.testing.assert_allclose(a, b, rtol=TOL, atol=atol, err_msg=name)


def _assert_moments(st, want):
    """Adam's count and moments against optax's: relative L2 per leaf."""
    assert st.count == int(want.count)
    for m, wm in ((st.mu, want.mu), (st.nu, want.nu)):
        for name, a, b, _ in _pairs(m, wm):
            assert _rel_l2(a, b) <= MOMENT_RTOL, name


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _noises_t(key, batch, cfg=TINY_GEN):
    return {k: _t(v) for k, v in tgen.jax_noises(key, batch, cfg).items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b)) / max(np.linalg.norm(np.ravel(b)),
                                                                   1e-30))


# ---------------------------------------------------------------------------
# losses, projection, the pool, the schedule
# ---------------------------------------------------------------------------

def test_losses_projection_and_screen_coordinates():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    for target in (0.0, 1.0):
        np.testing.assert_allclose(float(tgan.lsgan_loss(_t(logits), target)),
                                   float(jgan.lsgan_loss(jnp.asarray(logits), target)), rtol=TOL)
        assert float(tgan.discriminator_accuracy(_t(logits), target)) == float(
            jgan.discriminator_accuracy(jnp.asarray(logits), target))
    kps = (rng.standard_normal((4, 24, 3)) * 0.3).astype(np.float32)
    kps[0, 3] = [0.1, 0.2, -4.0]  # z == 0 in the camera: JAX's where(z == 0, 1, z)
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = 4.0
    exts = np.stack([ext] * 4)
    exts[1, 0, 3] = 0.5
    for e in (ext, exts):
        xy, cam = tgan.project_to_2d(_t(kps), _t(e), 96.0, 128.0, (120.0, 110.0))
        jxy, jcam = jgan.project_to_2d(jnp.asarray(kps), jnp.asarray(e), 96.0, 128.0,
                                       (120.0, 110.0))
        np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cam.numpy(), np.asarray(jcam), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tgan.normalize_screen_coordinates(xy, 128.0, 96.0).numpy(),
        np.asarray(jgan.normalize_screen_coordinates(jxy, 128.0, 96.0)), rtol=TOL, atol=TOL)


def test_fake_pool_gives_jax_s_sequence():
    rng = np.random.default_rng(1)
    tp, jp = tgan.FakePool(max_elements=10, seed=3), jgan.FakePool(max_elements=10, seed=3)
    for _ in range(5):
        batch = rng.standard_normal((6, 24, 3)).astype(np.float32)
        np.testing.assert_array_equal(tp(batch), jp(batch))
    np.testing.assert_array_equal(np.stack(tp.items), np.stack(jp.items))
    assert tp.rng.bit_generator.state == jp.rng.bit_generator.state


@pytest.mark.parametrize("step", [0, 999, 1000, 25_000, 49_999, 50_000, 70_000])
def test_lambda_lr(step):
    np.testing.assert_allclose(tgan.lambda_lr(1e-4, 50, 1000)(step),
                               float(jgan.lambda_lr(1e-4, 50, 1000)(step)), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the G and D steps: 3 steps, the schedule decaying after 2 (steps_per_epoch
# 2 of 3 epochs), with the default clip and with one that always clips
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-3, n_epochs=3, steps_per_epoch=2)
N_STEPS, K = 3, 3


def _gan_inputs():
    rng = np.random.default_rng(2)
    return ((rng.standard_normal((B, 24, 3)) * 0.2).astype(np.float32),
            (rng.standard_normal((B, 24, 3)) * 0.3).astype(np.float32),
            (rng.standard_normal((K, 14, 3)) * 0.3).astype(np.float32),
            np.array([1, 4, 6], np.int32))


@functools.lru_cache(maxsize=None)
def _jax_gan_weights():
    p, s = jg.init_pose_generator(jax.random.PRNGKey(0), TINY_GEN)
    return np_tree(p), np_tree(s), np_tree(jd.init_pos3d_discriminator(jax.random.PRNGKey(1)))


@functools.lru_cache(maxsize=None)
def _jax_g_steps(clip, active):
    p, s, d = _jax_gan_weights()
    real, _, spin_pred, sel = _gan_inputs()
    opt, step = jgan.make_generator_step(lambda b: jloop.fk_joints(b, 0.4), TINY_GEN,
                                         grad_clip=clip, **STEP_KW)
    os_ = opt.init(p)
    stats, states = [], []
    for i in range(N_STEPS):
        p, s, os_, out, st = step(p, s, os_, d, jax.random.PRNGKey(10 + i), jnp.asarray(real),
                                  jnp.asarray(spin_pred), jnp.asarray(sel), jnp.asarray(active))
        stats.append(np_tree(st))
        states.append(np_tree(s))
    return stats, np_tree(p), np_tree(s), np_tree(os_[1][0]), np_tree(out), states[0]


def _moments_norm(st):
    """Global norm of Adam's first moment over 1 - b1: after one update, the
    clipped gradient's global norm."""
    return float(torch.sqrt(sum((m ** 2).sum() for m in tgan.param_leaves(st.mu)))) / 0.1


@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("active", [0.0, 1.0])
def test_generator_step(clip, active):
    want_stats, wp, ws, wopt, wout, w_state1 = _jax_g_steps(clip, active)
    p0, s0, d0 = _jax_gan_weights()
    real, _, spin_pred, sel = _gan_inputs()
    p, s = generator_from_numpy(p0, s0, "cpu")
    d = discriminator_from_numpy(d0, "cpu")
    opt, step = tgan.make_generator_step(lambda b: tloop.fk_joints(b, 0.4), TINY_GEN,
                                         grad_clip=clip, **STEP_KW)
    st = opt.init(p)
    for i in range(N_STEPS):
        p, s, st, out, stats = step(p, s, st, d, _noises_t(jax.random.PRNGKey(10 + i), B),
                                    _t(real), _t(spin_pred), _t(sel, torch.long), active)
        for k, v in want_stats[i].items():
            np.testing.assert_allclose(float(stats[k]), v, rtol=TOL, atol=TOL, err_msg=f"{i} {k}")
        if i == 0:
            assert_trees(s, w_state1)  # before any bias moved: exact BN state
            if clip < 1.0:
                np.testing.assert_allclose(_moments_norm(st), clip, rtol=1e-4)  # clipped
    assert (float(want_stats[0]["spin_loss"]) != 0.0) == bool(active)
    assert st.count == int(wopt.count) == N_STEPS
    _assert_generator(p, wp, p0, st.mu, wopt.mu, st.nu, wopt.nu, s, ws, N_STEPS, STEP_KW["lr"])
    assert_trees(out, wout)


@functools.lru_cache(maxsize=None)
def _jax_d_steps(clip):
    _, _, d = _jax_gan_weights()
    real, fake, _, _ = _gan_inputs()
    opt, step = jgan.make_discriminator_step(grad_clip=clip, **STEP_KW)
    os_ = opt.init(d)
    stats = []
    for i in range(N_STEPS):
        d, os_, st = step(d, os_, jnp.asarray(real), jnp.asarray(fake + 0.1 * i))
        stats.append(np_tree(st))
    return stats, np_tree(d), np_tree(os_[1][0])


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_discriminator_step(clip):
    want_stats, wd, wopt = _jax_d_steps(clip)
    real, fake, _, _ = _gan_inputs()
    d = discriminator_from_numpy(_jax_gan_weights()[2], "cpu")
    opt, step = tgan.make_discriminator_step(grad_clip=clip, **STEP_KW)
    st = opt.init(d)
    for i in range(N_STEPS):
        d, st, stats = step(d, st, _t(real), _t(fake + 0.1 * i))
        for k, v in want_stats[i].items():
            np.testing.assert_allclose(float(stats[k]), v, rtol=TOL, atol=TOL, err_msg=f"{i} {k}")
        if i == 0 and clip < 1.0:
            np.testing.assert_allclose(_moments_norm(st), clip, rtol=1e-4)
    _assert_updates(d, wd, _jax_gan_weights()[2], N_STEPS, STEP_KW["lr"])
    _assert_moments(st, wopt)


# ---------------------------------------------------------------------------
# SPIN fine-tuning
# ---------------------------------------------------------------------------

def _spin_case(rng, n, corrupt):
    aa = (rng.standard_normal((n, 24, 3)) * 0.2).astype(np.float32)
    gt = np.asarray(jloop.fk_joints(jnp.asarray(aa), 0.4))
    gt = gt + corrupt[:, None, None] * rng.standard_normal(gt.shape).astype(np.float32)
    return aa, gt.astype(np.float32)


@pytest.mark.parametrize("case", ["mixed", "none_kept", "no_hinge"])
def test_spin_pose_loss(case):
    """The hinge keeps the first three samples (exact GT) and drops the rest;
    none kept: the loss is 0; no hinge: the plain mean. Loss, per-sample
    errors and d loss / d rotmat against JAX."""
    rng = np.random.default_rng(3)
    # kept samples are near, not at, their GT: at pred == gt the eps-safe
    # norm's gradient, 1 / (2 sqrt(1e-12)), amplifies rounding by 5e5
    corrupt = {"mixed": np.array([0.01, 0.01, 0.01, 1, 1, 1.0]), "none_kept": np.ones(6),
               "no_hinge": np.array([0.01, 0.02, 0.1, 1, 1, 1.0])}[case]
    aa, gt = _spin_case(rng, 6, corrupt.astype(np.float32))
    hinge = None if case == "no_hinge" else 0.02
    rot = np.asarray(j_axisang_to_rot(jnp.asarray(aa)))
    (jloss, jps), jgrad = jax.jit(jax.value_and_grad(
        lambda r: jst.spin_pose_loss(r, jnp.asarray(gt), 0.4, hinge), has_aux=True))(
        jnp.asarray(rot))
    r = _t(rot).requires_grad_(True)
    loss, ps = tst.spin_pose_loss(r, _t(gt), 0.4, hinge)
    (grad,) = torch.autograd.grad(loss, r)
    np.testing.assert_allclose(ps.detach().numpy(), np.asarray(jps), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)
    if case == "none_kept":
        assert float(loss) == 0.0 and bool((ps > 0.02).all())
    if case == "mixed":
        assert int((ps < 0.02).sum()) == 3 and float(loss) > 0.0


SPIN_RES_TEST = 32  # the steps' images: the ResNet's last stage is 1 x 1


def _mock_smpl(lib):
    """A stand-in body model, linear in the rotations and betas, written
    for both frameworks: vertices (B, 20, 3)."""
    rng = np.random.default_rng(4)
    A = (rng.standard_normal((216, 60)) * 0.05).astype(np.float32)
    Bm = (rng.standard_normal((10, 60)) * 0.05).astype(np.float32)
    cat = jnp.concatenate if lib == "jax" else torch.cat
    A, Bm = (jnp.asarray(A), jnp.asarray(Bm)) if lib == "jax" else (_t(A), _t(Bm))

    def smpl(betas, body_pose, global_orient, pose2rot):
        assert pose2rot is False
        rots = cat([global_orient, body_pose], 1).reshape(betas.shape[0], 216)
        return {"vertices": (rots @ A + betas @ Bm).reshape(-1, 20, 3)}

    return smpl


@functools.lru_cache(maxsize=None)
def _jax_finetune(kind):
    p, s = tgen.hmr_weights()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, SPIN_RES_TEST, SPIN_RES_TEST, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    if kind == "spin":
        _, gt = _spin_case(rng, 2, np.zeros(2, np.float32))
        opt, step = jst.make_spin_finetune_step(lr=1e-4, hinge=None)
    else:
        gt = (rng.standard_normal((2, 14, 3)) * 0.3).astype(np.float32)
        j_reg = rng.uniform(0, 1, (17, 20)).astype(np.float32)
        j_reg /= j_reg.sum(1, keepdims=True)
        opt, step = jst.make_ski_finetune_step(_mock_smpl("jax"), j_reg, lr=1e-4)
    os_ = opt.init(p)
    p1, os1, stats = step(p, s, os_, jnp.asarray(x), jnp.asarray(gt), key)
    adam = os1.inner_states["train"].inner_state[0]
    return x, gt, (j_reg if kind == "ski" else None), np_tree(p1), np_tree(adam), np_tree(stats)


@pytest.mark.parametrize("kind", ["spin", "ski"])
def test_finetune_step(kind):
    """One BN-frozen fine-tune step with JAX's dropout masks: loss,
    per-sample errors, the gradients (Adam's mu / 0.1), the params; the
    mean-param buffers and the BN running stats untouched
    (bn_frozen_adam)."""
    x, gt, j_reg, wp, wadam, wstats = _jax_finetune(kind)
    p0, s0 = tgen.hmr_weights()
    p, s = hmr_from_numpy(p0, s0, "cpu")
    s_before = t2n(s)
    if kind == "spin":
        opt, step = tst.make_spin_finetune_step(lr=1e-4, hinge=None)
    else:
        opt, step = tst.make_ski_finetune_step(_mock_smpl("torch"), j_reg, lr=1e-4)
    st = opt.init(p)
    assert set(st.mu) == set(p) - set(tst.MEAN_PARAM_BUFFERS)
    masks = [tuple(_t(m) for m in pair) for pair in tgen.jax_masks(jax.random.PRNGKey(9), 2)]
    p, st, stats = step(p, s, st, _t(x.transpose(0, 3, 1, 2)), _t(gt), masks)
    np.testing.assert_allclose(float(stats["spin_loss"]), float(wstats["spin_loss"]), rtol=TOL)
    np.testing.assert_allclose(stats["per_sample"].numpy(), wstats["per_sample"], rtol=TOL)
    assert st.count == int(wadam.count) == 1
    for key in st.mu:
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(t2n(st.mu[key]))[0],
                jax.tree_util.tree_flatten_with_path(wadam.mu[key])[0]):
            a, b = np.asarray(a), np.asarray(b)
            if a.ndim == 4:
                b = b.transpose(3, 2, 0, 1)
            assert _rel_l2(a, b) <= SPIN_GRAD_RTOL, f"{key}{jax.tree_util.keystr(path)}"
    want_p, start = hmr_from_numpy(wp, s0, "cpu")[0], hmr_from_numpy(p0, s0, "cpu")[0]
    for a, b, a0 in zip(*(map(lambda t: t.detach().numpy(), tgan.param_leaves(x))
                          for x in (p, want_p, start))):
        assert np.abs(a - b).max() <= 2 * 1e-4 and _rel_l2(a - a0, b - a0) <= UPDATE_RTOL
    for buf in tst.MEAN_PARAM_BUFFERS:
        np.testing.assert_array_equal(p[buf].detach().numpy(), p0[buf])
    assert_trees(s, s_before, rtol=0, atol=0)


def test_bn_frozen_adam_without_freezing_moves_the_buffers():
    opt = tst.bn_frozen_adam(1e-3, freeze_init_buffers=False)
    params = {"init_pose": torch.ones(1, 4, requires_grad=True),
              "fc1": {"w": torch.ones(2, 2, requires_grad=True)}}
    st = opt.init(params)
    opt.update(st, params, {"init_pose": torch.ones(1, 4), "fc1": {"w": torch.ones(2, 2)}})
    assert float(params["init_pose"].max()) < 1.0 and set(st.mu) == {"init_pose", "fc1"}
    frozen = tst.bn_frozen_adam(1e-3)
    params = {k: tgan.tree_map(lambda t: t.detach().clone().requires_grad_(True), v)
              for k, v in params.items()}
    before = params["init_pose"].detach().clone()
    st = frozen.init(params)
    frozen.update(st, params, {"fc1": {"w": torch.ones(2, 2)}})
    assert torch.equal(params["init_pose"].detach(), before) and set(st.mu) == {"fc1"}


# ---------------------------------------------------------------------------
# the loop: SPIN input, the renderer, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,crop", [((1, 512, 512, 3), (100, 412)),
                                        ((2, 96, 96, 3), (16, 80))])
def test_prepare_spin_input(shape, crop):
    """312 -> 224 shrinks, where jax.image.resize antialiases; 64 -> 224
    grows."""
    imgs = np.random.default_rng(6).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jloop.prepare_spin_input(imgs, crop))
    got = tloop.prepare_spin_input(imgs, crop, device="cpu")
    assert got.shape == (shape[0], 3, 224, 224)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=TOL, atol=TOL)


@functools.lru_cache(maxsize=None)
def _nerf():
    cfg = jr.RaycastConfig(**TINY_NERF)
    params = jr.init_raycaster(jax.random.PRNGKey(0), cfg)
    params["coarse"]["alpha_linear"]["b"] = params["coarse"]["alpha_linear"]["b"] + 2.0
    return cfg, params


def _renderers():
    cfg, params = _nerf()
    jren = jloop.NeRFRenderer(cfg, params, hw=HW, focal=FOCAL, chunk=CHUNK)
    jren._render_fn, jren.chunk = None, CHUNK
    tren = tloop.NeRFRenderer(tr.RaycastConfig(**TINY_NERF),
                              params_from_numpy(np_tree(params), "cpu"), hw=HW, focal=FOCAL,
                              chunk=CHUNK)
    return jren, tren


def _c2ws(n):
    from posegen_tpu_torch.skeleton.cameras import nerf_extrinsic_to_c2w

    return np.broadcast_to(nerf_extrinsic_to_c2w(tloop.FEEDBACK_EXTRINSIC), (n, 4, 4))


def _window_rays_hit(bones):
    """Whether every ray of the window meets each pose's cylinder on the
    ground plane (so no ray takes its chunk's mean near / far)."""
    from posegen_tpu_torch.skeleton.cameras import get_rays_np
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder

    o, d = get_rays_np(HW, HW, FOCAL, _c2ws(1)[0])
    lo, hi = WINDOW
    o, d = o[lo:hi, lo:hi].reshape(-1, 3)[:, [0, 2]], d[lo:hi, lo:hi].reshape(-1, 3)[:, [0, 2]]
    cyls = get_kp_bounding_cylinder(tloop.fk_joints(_t(bones), 0.4), ext_scale=0.001).numpy()
    for cx, cz, r, _, _ in cyls:
        rel = np.array([cx, cz]) - o
        dist = np.abs(rel[:, 0] * d[:, 1] - rel[:, 1] * d[:, 0]) / np.linalg.norm(d, axis=-1)
        if not (dist < r).all():
            return False
    return True


@pytest.mark.parametrize("window", [None, WINDOW])
def test_render_poses(window):
    """Poses at the feedback camera: one frame without a window, at a chunk
    of the frame's own ray count, and two frames in one call through the
    window."""
    jren, tren = _renderers()
    bones = (np.random.default_rng(7).standard_normal((2, 24, 3)) * 0.2).astype(np.float32)
    if window is None:
        from posegen_tpu.render.image import valid_box_for_pose

        cyls = np.asarray(jloop.get_kp_bounding_cylinder(
            jloop.fk_joints(jnp.asarray(bones), 0.4), ext_scale=0.001))
        for k in range(1):
            n = len(valid_box_for_pose(HW, HW, FOCAL, _c2ws(1)[0], cyls[k])[2])
            jren.chunk = tren.chunk = n
            want = jren.render_poses(bones[k:k + 1], _c2ws(1))
            got = tren.render_poses(bones[k:k + 1], _c2ws(1))
            assert got.shape == (1, HW, HW, 3) and float(got.max()) > 0.0
            np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_TOL)
    else:
        assert _window_rays_hit(bones)
        want = jren.render_poses(bones, _c2ws(2), window=window)
        got = tren.render_poses(_t(bones), _c2ws(2), window=window)
        np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_TOL)
        outside = got.copy()
        outside[:, window[0]:window[1], window[0]:window[1]] = 0.0
        assert float(np.abs(outside).max()) == 0.0 and float(got.max()) > 0.0


LOOP_CFG = dict(n_epochs=2, rpi=2, df=2, feedback_every=2, feedback_start_epoch=-1,
                crop=WINDOW)
N_ITERS = 4  # one epoch: feedback at iterations 0 and 2, D steps at 0 and 2


def _epoch_poses():
    return (np.random.default_rng(8).standard_normal((N_ITERS, B, 24, 3)) * 0.2).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_loop():
    """JAX's trainer over one epoch (with the PNG sink), then its checkpoint,
    one more step and a probe -> everything the loop tests compare."""
    jren, _ = _renderers()
    spin_p, spin_s = tgen.hmr_weights()
    sink = tempfile.mkdtemp(prefix="jax_sink_")
    cfg = jloop.GanLoopConfig(output_dir=sink, **LOOP_CFG)
    trainer = jloop.GanTrainer(cfg, jren, spin_p, spin_s, gen_cfg=TINY_GEN, steps_per_epoch=2)
    init = (np_tree(trainer.g_params), np_tree(trainer.g_state), np_tree(trainer.d_params))
    keys, step_stats, spin_preds = [], [], []
    next_key, train_step, feedback = trainer._next_key, trainer.train_step, trainer.spin_feedback

    def rec_key():
        keys.append(next_key())
        return keys[-1]

    def rec_step(batch):
        step_stats.append(train_step(batch))
        return step_stats[-1]

    def rec_feedback(bones, sel):
        spin_preds.append(np.asarray(feedback(bones, sel)))
        return spin_preds[-1]

    trainer._next_key, trainer.train_step, trainer.spin_feedback = rec_key, rec_step, rec_feedback
    epoch = trainer.train_epoch(_epoch_poses())
    trainer.flush_sink()
    ckpt = trainer.save_checkpoint(os.path.join(sink, "gan.npz"))
    after = (np_tree(trainer.g_params), np_tree(trainer.g_state), np_tree(trainer.d_params),
             np_tree(trainer.g_opt_state[1][0]))
    probe_key = jax.random.PRNGKey(21)
    probe = jloop.probe_hardness(trainer, _epoch_poses()[0], probe_key)
    trainer.cfg.output_dir = None  # the sink holds the epoch's renders only
    resumed = rec_step(_epoch_poses()[1])
    return dict(init=init, keys=keys, step_stats=step_stats, spin_preds=spin_preds, epoch=epoch,
                sink=sink, ckpt=ckpt, after=after, probe=probe, probe_key=probe_key,
                resumed=resumed)


def _port_trainer(output_dir=None, load_init=True):
    j = _jax_loop()
    _, tren = _renderers()
    sp, ss = hmr_from_numpy(*tgen.hmr_weights(), "cpu")
    trainer = tloop.GanTrainer(tloop.GanLoopConfig(output_dir=output_dir, **LOOP_CFG), tren, sp,
                               ss, gen_cfg=TINY_GEN, steps_per_epoch=2, device="cpu")
    if load_init:
        p, s, d = j["init"]
        trainer.g_params, trainer.g_state = generator_from_numpy(p, s, "cpu")
        trainer.d_params = discriminator_from_numpy(d, "cpu")
        trainer.g_opt_state = trainer.g_opt.init(trainer.g_params)
        trainer.d_opt_state = trainer.d_opt.init(trainer.d_params)
    keys = iter(j["keys"])
    trainer._draw_noises = lambda batch: _noises_t(next(keys), batch)
    return trainer, keys


@functools.lru_cache(maxsize=None)
def _port_loop():
    """The port's trainer through _jax_loop's epoch, with JAX's noises."""
    sink = tempfile.mkdtemp(prefix="port_sink_")
    trainer, _ = _port_trainer(output_dir=sink)
    step_stats, spin_preds = [], []
    train_step, feedback = trainer.train_step, trainer.spin_feedback
    trainer.train_step = lambda b: step_stats.append(train_step(b)) or step_stats[-1]
    trainer.spin_feedback = lambda b, s: spin_preds.append(feedback(b, s)) or spin_preds[-1]
    epoch = trainer.train_epoch(_epoch_poses())
    trainer.flush_sink()
    return trainer, dict(step_stats=step_stats, spin_preds=spin_preds, epoch=epoch, sink=sink)


def test_train_step_with_feedback_matches_jax():
    """Each iteration's G / D stats (feedback at iterations 0 and 2, the D
    step at 0 and 2), SPIN's joints on the feedback frames, and the params,
    BN state and G's Adam moments after the epoch."""
    j = _jax_loop()
    trainer, t = _port_loop()
    assert _window_rays_hit(np.concatenate(
        [np.load(os.path.join(j["sink"], f)) for f in sorted(os.listdir(j["sink"]))
         if f.endswith(".npy")]))
    assert len(t["step_stats"]) == N_ITERS and len(j["step_stats"]) == N_ITERS + 1  # + resumed
    for i, (got, want) in enumerate(zip(t["step_stats"], j["step_stats"])):
        assert set(got) == set(want), i
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=f"{i} {k}")
    assert len(t["spin_preds"]) == 2 and len(j["spin_preds"]) == 3  # + resumed
    for got, want in zip(t["spin_preds"], j["spin_preds"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=JOINT_TOL, atol=JOINT_TOL)
    p, s, d, gopt = j["after"]
    st = trainer.g_opt_state
    assert st.count == int(gopt.count) == N_ITERS
    lr = jloop.GanLoopConfig().lr_g
    _assert_generator(trainer.g_params, p, j["init"][0], st.mu, gopt.mu, st.nu, gopt.nu,
                      trainer.g_state, s, N_ITERS, lr)
    _assert_updates(trainer.d_params, d, j["init"][2], N_ITERS // 2, lr)


def test_train_epoch_means_and_feedback_count():
    j = _jax_loop()
    _, t = _port_loop()
    assert set(t["epoch"]) == set(j["epoch"])
    assert t["epoch"]["n_feedback_iters"] == j["epoch"]["n_feedback_iters"] == 2.0
    for k, v in j["epoch"].items():
        np.testing.assert_allclose(t["epoch"][k], v, rtol=TOL, atol=TOL, err_msg=k)


def test_png_sink_matches_jax():
    import imageio.v2 as imageio

    j = _jax_loop()
    _, t = _port_loop()
    names = sorted(os.listdir(os.path.join(j["sink"], "image")))
    assert names == sorted(os.listdir(os.path.join(t["sink"], "image")))
    assert names == [f"{i:05d}.png" for i in range(4)]
    for name in names:
        got = imageio.imread(os.path.join(t["sink"], "image", name)).astype(int)
        want = imageio.imread(os.path.join(j["sink"], "image", name)).astype(int)
        assert got.shape == (HW, HW, 3) and np.abs(got - want).max() <= 1, name
    for name in ("poses_axis_angles0.npy", "poses_axis_angles2.npy"):
        np.testing.assert_allclose(np.load(os.path.join(t["sink"], name)),
                                   np.load(os.path.join(j["sink"], name)), rtol=TOL, atol=TOL)


def test_jax_checkpoint_loads_into_the_port_and_resumes():
    """JAX's GAN .npz into a fresh port trainer, key for key; the JAX PRNG
    key is ignored with a warning; the next step (JAX's noises) matches
    JAX's resumed step."""
    j = _jax_loop()
    trainer, keys = _port_trainer(load_init=False)
    for _ in range(N_ITERS):
        next(keys)  # the resumed step draws the fifth key
    with pytest.warns(UserWarning, match="PRNG key is ignored"):
        trainer.load_checkpoint(j["ckpt"])
    p, s, d, gopt = j["after"]
    assert_trees(trainer.g_params, p, rtol=0, atol=0)
    assert_trees(trainer.g_state, s, rtol=0, atol=0)
    assert_trees(trainer.d_params, d, rtol=0, atol=0)
    assert trainer.g_opt_state.count == int(gopt.count)
    assert_trees(trainer.g_opt_state.mu, gopt.mu, rtol=0, atol=0)
    assert_trees(trainer.g_opt_state.nu, gopt.nu, rtol=0, atol=0)
    assert (trainer.iter_num, trainer.epoch) == (N_ITERS, 1)
    raw = np.load(j["ckpt"])
    np.testing.assert_array_equal(np.stack(trainer.fake_pool.items), raw["pool_items"])
    got = trainer.train_step(_epoch_poses()[1])
    for k, v in j["resumed"].items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    """The port's own file holds JAX's keys plus its generator state, and
    restores every tensor, counter and RNG state bit for bit."""
    trainer, _ = _port_loop()
    path = trainer.save_checkpoint(str(tmp_path / "gan.npz"))
    raw = np.load(path)
    jkeys = set(np.load(_jax_loop()["ckpt"]).files)
    assert set(raw.files) == jkeys | {tloop.GanTrainer.TORCH_GENERATOR_KEY}
    assert raw["key"].dtype == np.load(_jax_loop()["ckpt"])["key"].dtype
    fresh, _ = _port_trainer(load_init=False)
    fresh.load_checkpoint(path)
    for name in ("g_params", "g_state", "d_params"):
        for a, b in zip(tgan.param_leaves(getattr(fresh, name)),
                        tgan.param_leaves(getattr(trainer, name))):
            assert torch.equal(a, b), name
    for name in ("g_opt_state", "d_opt_state"):
        a, b = getattr(fresh, name), getattr(trainer, name)
        assert a.count == b.count
        assert all(torch.equal(x, y) for x, y in zip(tgan.param_leaves([a.mu, a.nu]),
                                                     tgan.param_leaves([b.mu, b.nu])))
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())
    assert fresh.fake_pool.rng.bit_generator.state == trainer.fake_pool.rng.bit_generator.state
    assert (fresh.iter_num, fresh.epoch, fresh._render_count) == (
        trainer.iter_num, trainer.epoch, trainer._render_count)


def test_probe_hardness_matches_jax():
    j = _jax_loop()
    trainer, _ = _port_trainer(load_init=False)
    with pytest.warns(UserWarning, match="PRNG key is ignored"):
        trainer.load_checkpoint(j["ckpt"])
    got = tloop.probe_hardness(trainer, _epoch_poses()[0], _noises_t(j["probe_key"], B))
    np.testing.assert_allclose(got, j["probe"], rtol=JOINT_TOL)


def test_trainer_without_feedback_and_mesh_refusal(monkeypatch):
    """No renderer: no feedback, spin_loss a structural 0, the noises from
    the trainer's own generator; a parallel.mesh.Mesh is accepted (one rank:
    the single-device steps, on the mesh's device) and any other mesh object
    is refused by type; the trainer and prepare_spin_input default to the
    card."""
    from posegen_tpu_torch.parallel.mesh import Mesh

    trainer = tloop.GanTrainer(tloop.GanLoopConfig(rpi=2, df=1), None, gen_cfg=TINY_GEN,
                               steps_per_epoch=4, device="cpu")
    stats = trainer.train_epoch(_epoch_poses()[:2])
    assert stats["n_feedback_iters"] == 0.0 and "dis_loss" in stats
    assert np.isfinite(stats["gen_loss"]) and trainer.epoch == 1
    one_rank = Mesh(None, 0, 1, torch.device("cpu"), "gloo")
    meshed = tloop.GanTrainer(tloop.GanLoopConfig(rpi=2, df=1), None, gen_cfg=TINY_GEN,
                              steps_per_epoch=4, mesh=one_rank)
    assert meshed.device == torch.device("cpu") and meshed.rank == 0
    assert meshed.train_epoch(_epoch_poses()[:2]) == stats
    with pytest.raises(TypeError, match="a parallel.mesh.Mesh, not object"):
        tloop.GanTrainer(tloop.GanLoopConfig(), None, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.GanTrainer(tloop.GanLoopConfig(), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.prepare_spin_input(np.zeros((1, 8, 8, 3), np.float32), (0, 8))
