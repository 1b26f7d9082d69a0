"""posegen_tpu_torch train/ against posegen_tpu train/: the losses, the
embedder schedules, both optimizers (the pose one with optax.MultiSteps'
accumulation), and one full train step of the flagship nets, weights-only
and with pose refinement, on both of the port's field paths (the plain
pipeline and the trainable kernels' plain versions) against JAX
make_train_step on its XLA path, at JAX's own bounds
(tests/test_fused_train.py:57-68)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posegen_tpu.pose import opt as jopt
from posegen_tpu.render import raycast as jr
from posegen_tpu.skeleton.geometry import get_kp_bounding_cylinder
from posegen_tpu.skeleton.skeleton import SMPL_REST_POSE
from posegen_tpu.train import losses as jl
from posegen_tpu.train import trainer as jt
from posegen_tpu.utils.fixtures import make_pose_ctx, make_rays
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.ops import embedding as temb
from posegen_tpu_torch.pose import opt as topt
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train import losses as tl
from posegen_tpu_torch.train import trainer as tt
from posegen_tpu_torch.utils.convert import (
    _adam_state, params_from_numpy, train_state_from_numpy,
)

N_IMAGES, RPI = 2, 16  # pose groups x rays per group
PARAM_TOL = 5e-5  # max|diff| of every updated parameter
LOSS_RTOL = 1e-4
# JAX weights whose coarse and fine nets both render opaque rays on this batch,
# so that every parameter of both nets has a gradient (seed 0's coarse net
# renders nothing: its gradients are all zero)
SEED = 2

# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------

LOSSES = {
    "img2mse": lambda m, p, t, f: m.img2mse(p, t),
    "img2l1": lambda m, p, t, f: m.img2l1(p, t),
    "img2huber": lambda m, p, t, f: m.img2huber(p, t, delta=0.2),
    "mse2psnr": lambda m, p, t, f: m.mse2psnr(m.img2mse(p, t)),
    "acc2bce": lambda m, p, t, f: m.acc2bce(p[:, 0], f),
    "rgb_loss_mse": lambda m, p, t, f: m.rgb_loss("MSE", p, t),
    "rgb_loss_l1": lambda m, p, t, f: m.rgb_loss("L1", p, t),
    "rgb_loss_huber": lambda m, p, t, f: m.rgb_loss("Huber", p, t, beta=0.05),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    fg = (rng.uniform(0, 1, (64,)) > 0.5).astype(np.float32)
    ref = float(LOSSES[name](jl, jnp.asarray(pred), jnp.asarray(target), jnp.asarray(fg)))
    got = float(LOSSES[name](tl, torch.as_tensor(pred), torch.as_tensor(target),
                             torch.as_tensor(fg)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tl.rgb_loss("L2", torch.as_tensor(pred), torch.as_tensor(target))


@pytest.mark.parametrize("freq_schedule", [False, True])
@pytest.mark.parametrize("step", [0, 1000, 250000])
def test_updated_embeds_match_jax(step, freq_schedule):
    jcfg = jr.RaycastConfig(freq_schedule=freq_schedule)
    tcfg = tr.RaycastConfig(freq_schedule=freq_schedule)
    j_emb = {k: v for k, v in jr.init_raycaster(jax.random.PRNGKey(0), jcfg).items()
             if k.startswith("embed")}
    t_emb = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_emb), "cpu")
    ref = jt._updated_embeds(jcfg, jt.TrainConfig(), j_emb, jnp.asarray(step))
    got = tt._updated_embeds(tcfg, tt.TrainConfig(), t_emb, step)
    for name in ref:
        for k in ref[name]:
            np.testing.assert_allclose(got[name][k].numpy(), np.asarray(ref[name][k]),
                                       rtol=1e-6, err_msg=f"{name}.{k}")


def test_schedules_keep_the_device_of_their_inputs():
    """tau / alpha / the init state are built on their inputs' device (the
    meta device stands in for a card here)."""
    cfg = tr.RaycastConfig(freq_schedule=True).embed_kp_cfg
    meta = torch.device("meta")
    step = torch.tensor(1000.0, device=meta)
    assert temb.update_tau(cfg, step, 250, 10.0).device == meta
    assert temb.update_alpha(cfg, step, 5, 6.0).device == meta
    assert temb.update_alpha(tr.RaycastConfig().embed_kp_cfg, step, 5).device == meta
    st = temb.init_embed_state(cfg, torch.full((24,), 0.5, device=meta))
    assert {t.device for t in st.values()} == {meta}
    emb = tt._updated_embeds(tr.RaycastConfig(freq_schedule=True), tt.TrainConfig(),
                             {"embed_kp": st}, 7)
    assert {t.device for t in emb["embed_kp"].values()} == {meta}
    assert temb.update_tau(cfg, 1000, 250, 10.0).device == torch.device("cpu")


@pytest.mark.parametrize("variant", ["adam", "weight_decay", "testopt"])
def test_nerf_optimizer_matches_optax(variant):
    """Three updates of a small tree with a fast-decaying learning rate."""
    kw = dict(lrate=1e-2, lrate_decay=1, decay_unit=2)
    if variant == "weight_decay":
        kw["weight_decay"] = 0.1
    if variant == "testopt":
        kw["testopt"] = True
    rng = np.random.default_rng(6)
    tree = {"coarse": {"pts_linears": [{"w": rng.standard_normal((3, 4)),
                                        "b": rng.standard_normal(4)}],
                       "rgb_linear": {"w": rng.standard_normal((4, 3)), "b": np.zeros(3)}}}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                    tree) for _ in range(3)]
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    opt = jt.nerf_optimizer(jcfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = opt.init(j_params)
    params = tt.trainable(params_from_numpy(tree, "cpu"))
    t_opt = tt.nerf_optimizer(tcfg, params)
    assert (t_opt is None) == (variant == "testopt")
    for step, g in enumerate(grads):
        upd, j_state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        if t_opt is not None:
            for p, gp in zip(tt.param_leaves(params), tt.param_leaves(params_from_numpy(g, "cpu"))):
                p.grad = gp
            for group in t_opt.param_groups:
                group["lr"] = tt.nerf_lr(tcfg, step)
            t_opt.step()
    for a, b in zip(tt.param_leaves(params), jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    if variant == "testopt":
        for a, b in zip(tt.param_leaves(params), jax.tree_util.tree_leaves(tree)):
            assert np.array_equal(a.detach().numpy(), b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "flagship": ({}, {}),
    "fix_layer": ({}, dict(fix_layer=3)),
    "framecode": (dict(opt_framecode=True, n_framecodes=4), {}),
}


@functools.lru_cache(maxsize=None)
def _batch(framecode: bool):
    """2 images x 16 rays: per-image pose rows, rays contiguous per image,
    targets and backgrounds, and per-ray frame indices (images 0 and 2)."""
    rng = np.random.default_rng(0)
    parts = []
    for i in range(N_IMAGES):
        ctx = make_pose_ctx(seed=i)
        ro, rd = make_rays(RPI, seed=10 + i)
        parts.append({
            "rays_o": np.asarray(ro), "rays_d": np.asarray(rd),
            "target_s": rng.uniform(0, 1, (RPI, 3)).astype(np.float32),
            "bgs": rng.uniform(0, 1, (RPI, 3)).astype(np.float32),
            "kp3d": np.asarray(ctx.kps), "skts": np.asarray(ctx.skts),
            "bones": np.asarray(ctx.bones), "cyls": np.asarray(ctx.cyls),
        })
        if framecode:
            parts[-1]["cam_idxs"] = np.full((RPI, 1), 2 * i, np.int32)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _configs(name, fused_train):
    rkw, tkw = STEP_CASES[name]
    rkw = dict(perturb=0.0, raw_noise_std=0.0, **rkw)
    tkw = dict(rays_per_image=RPI, use_background=True, **tkw)
    return (jr.RaycastConfig(**rkw), jt.TrainConfig(fused_train=False, **tkw),
            tr.RaycastConfig(**rkw), tt.TrainConfig(fused_train=fused_train, **tkw))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX states after 0..n steps (numpy leaves), with each step's stats:
    3 steps of the flagship (fresh and carried-state tests), 1 of the rest."""
    n_steps = 3 if name == "flagship" else 1
    jcfg, jtcfg, _, _ = _configs(name, False)
    state = jt.create_train_state(jr.init_raycaster(jax.random.PRNGKey(SEED), jcfg), jtcfg)
    step = jax.jit(jt.make_train_step(jcfg, jtcfg))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.opt_framecode).items()}
    states, stats = [jax.tree_util.tree_map(np.array, state)], []
    for _ in range(n_steps):
        state, st = step(state, batch, jax.random.PRNGKey(5))
        states.append(jax.tree_util.tree_map(np.array, state))
        stats.append({k: float(v) for k, v in st.items()})
    return states, stats


def _port_step(name, use_fused, start: int):
    """One port step from the JAX state after `start` steps."""
    jcfg, jtcfg, tcfg, ttcfg = _configs(name, use_fused)
    states, _ = _jax_run(name)
    state = train_state_from_numpy(states[start], ttcfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg.opt_framecode).items()}
    mode = tt._fused_train_mode(tcfg, ttcfg, state.params, batch)
    assert mode == ("train" if use_fused else False)
    state, stats = tt.make_train_step(tcfg, ttcfg)(state, batch)
    assert state.step == start + 1
    return state, {k: float(v) for k, v in stats.items()}


def _assert_step_matches(name, use_fused, start):
    state, stats = _port_step(name, use_fused, start)
    states, j_stats = _jax_run(name)
    ref, ref_stats = states[start + 1], j_stats[start]
    assert np.isfinite(stats["total_loss"])
    for k in ("total_loss", "grad_norm", "rgb_loss", "rgb0_loss", "psnr"):
        np.testing.assert_allclose(stats[k], ref_stats[k], rtol=LOSS_RTOL, err_msg=k)
    got = tt.param_leaves(state.params)
    want = tt.param_leaves(params_from_numpy(ref.params, "cpu"))
    assert len(got) == len(want) >= 40
    moved = 0
    for a, b in zip(got, want):
        err = float((a.detach() - b).abs().max())
        assert err < PARAM_TOL, err
    for a, b in zip(tt.param_leaves(params_from_numpy(states[start].params, "cpu")), want):
        moved += not torch.equal(a, b)
    frozen = 4 * STEP_CASES[name][1].get("fix_layer", 0)  # w, b x 2 nets per layer
    assert moved == len(want) - frozen
    for k in ref.embeds["embed_kp"]:
        np.testing.assert_allclose(state.embeds["embed_kp"][k].numpy(), ref.embeds["embed_kp"][k],
                                   rtol=1e-6)
    return state, states


@pytest.mark.parametrize("use_fused", [False, True])
def test_train_step_matches_jax(use_fused):
    """A fresh state: one step through the plain pipeline and one through
    the trainable kernels' plain versions, each against JAX's XLA step."""
    _assert_step_matches("flagship", use_fused, 0)


@pytest.mark.parametrize("use_fused", [False, True])
def test_carried_state_step_matches_jax(use_fused):
    """Two JAX steps, the state carried over by train_state_from_numpy
    (Adam moments and count included), then one step on each side."""
    state, states = _assert_step_matches("flagship", use_fused, 2)
    p = tt.param_leaves(state.params)[0]
    assert float(state.opt_state.state[p]["step"]) == 3


@pytest.mark.parametrize("name", ["fix_layer", "framecode"])
def test_train_step_variants_match_jax(name):
    state, states = _assert_step_matches(name, True, 0)
    if name == "fix_layer":
        for net in ("coarse", "fine"):
            for i, layer in enumerate(state.params[net]["pts_linears"]):
                before = states[0].params[net]["pts_linears"][i]["w"]
                assert np.array_equal(layer["w"].detach().numpy(), before) == (i < 3)
    else:
        assert "framecodes" in state.params["coarse"]
        assert not np.array_equal(state.params["coarse"]["framecodes"].detach().numpy(),
                                  states[0].params["coarse"]["framecodes"])


# ---------------------------------------------------------------------------
# pose refinement
# ---------------------------------------------------------------------------

N_FRAMES = 4
KP_IDX = np.array([1, 3], np.int32)  # frame per pose group; frame 3's next wraps to 0
POSE_CASES = {  # raycast kwargs, train kwargs, JAX steps
    "pose": ({}, dict(opt_pose_step=3), 3),
    "pose_framecode": (dict(opt_framecode=True, n_framecodes=4), dict(opt_pose_step=3), 1),
    "pose_testopt": ({}, dict(opt_pose_step=1, testopt=True), 1),
    "pose_multires9": (dict(multires=9), dict(opt_pose_step=3), 1),
    "pose_views5": (dict(multires=4, multires_views=5), dict(opt_pose_step=3), 1),
}
# pose_multires9 and pose_views5: layouts whose pose step the WMMA plan of the
# port's input-gradient pass (c) refused (241,152 bytes of shared memory at
# multires 9 / multires_views 4), sending it to the plain pipeline; its
# two-kernel plan takes every layout, so with fused_train on every case takes
# the kernels' route, "full"
# per gradient tensor, max|diff| / max|grad|: a whole step (render, composite,
# losses) in float32 on both sides, XLA's sums against PyTorch's; the worst
# tensor measured 2.8e-4 (a NeRF weight)
GRAD_REL = 1e-3


def _pose_configs(name, fused_train):
    rkw, tkw, _ = POSE_CASES[name]
    rkw = dict(perturb=0.0, raw_noise_std=0.0, **rkw)
    tkw = dict(rays_per_image=RPI, use_background=True, opt_pose=True, use_temp_loss=True,
               **tkw)
    return (jr.RaycastConfig(**rkw), jt.TrainConfig(fused_train=False, **tkw),
            tr.RaycastConfig(**rkw), tt.TrainConfig(fused_train=fused_train, **tkw))


@functools.lru_cache(maxsize=None)
def _pose_init():
    """JAX rot6d pose params over 4 frames, drifted from their anchors past
    the 0.01 tolerance, and a grouped batch: 2 groups x 16 rays at frames 1
    and 3, cylinders around the frames' joints, the dataset joints (kp3d)
    a little off the frames'."""
    rng = np.random.default_rng(12)
    bones0 = (rng.standard_normal((N_FRAMES, 24, 3)) * 0.2).astype(np.float32)
    kp0 = np.tile(SMPL_REST_POSE[None], (N_FRAMES, 1, 1))
    pcfg = jopt.PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01)
    params, anchors = jopt.init_pose_params(pcfg, bones0, kp0)
    params = {"pelvis": params["pelvis"] + 0.01,
              "bones": params["bones"] + rng.standard_normal((N_FRAMES, 24, 6)) * 0.2}
    kps = np.asarray(jopt.pose_apply(params, KP_IDX, SMPL_REST_POSE)[0])
    batch = {k: np.concatenate([_batch(False)[k][i * RPI:(i + 1) * RPI] for i in range(2)])
             for k in ("rays_o", "rays_d", "target_s", "bgs")}
    batch["cyls"] = np.asarray(get_kp_bounding_cylinder(kps, ext_scale=0.001))
    batch["kp_idx"] = KP_IDX
    batch["kp3d"] = (kps + rng.standard_normal(kps.shape) * 0.01).astype(np.float32)
    return pcfg, jax.tree_util.tree_map(np.asarray, (params, anchors)), batch


def _pose_batch(framecode: bool):
    batch = dict(_pose_init()[2])
    if framecode:
        batch["cam_idxs"] = np.repeat(np.array([[0], [2]], np.int32), RPI, 0)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_pose_run(name):
    """JAX states (numpy leaves) after 0..n pose-refinement steps, with
    each step's stats."""
    jcfg, jtcfg, _, _ = _pose_configs(name, False)
    pcfg, (params, anchors), _ = _pose_init()
    state = jt.create_train_state(jr.init_raycaster(jax.random.PRNGKey(SEED), jcfg), jtcfg,
                                  jax.tree_util.tree_map(jnp.asarray, params),
                                  jax.tree_util.tree_map(jnp.asarray, anchors))
    step = jax.jit(jt.make_train_step(jcfg, jtcfg, pcfg, rest_pose=jnp.asarray(SMPL_REST_POSE),
                                      n_frames=N_FRAMES))
    batch = {k: jnp.asarray(v) for k, v in _pose_batch(jcfg.opt_framecode).items()}
    states, stats = [jax.tree_util.tree_map(np.array, state)], []
    for _ in range(POSE_CASES[name][2]):
        state, st = step(state, batch, jax.random.PRNGKey(5))
        states.append(jax.tree_util.tree_map(np.array, state))
        stats.append({k: float(v) for k, v in st.items()})
    return states, stats


def _port_pose_step(name, use_fused, start):
    _, _, tcfg, ttcfg = _pose_configs(name, use_fused)
    states, _ = _jax_pose_run(name)
    state = train_state_from_numpy(states[start], ttcfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _pose_batch(tcfg.opt_framecode).items()}
    want = "full" if use_fused else False
    assert tt._fused_train_mode(tcfg, ttcfg, state.params, batch) == want
    pcfg = topt.PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01)
    step = tt.make_train_step(tcfg, ttcfg, pcfg, rest_pose=torch.as_tensor(SMPL_REST_POSE),
                              n_frames=N_FRAMES)
    state, stats = step(state, batch)
    return state, {k: float(v) for k, v in stats.items()}


def _assert_grad_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err < GRAD_REL, f"{what}: rel err {err}"


def _assert_pose_step(name, use_fused, start):
    state, stats = _port_pose_step(name, use_fused, start)
    states, j_stats = _jax_pose_run(name)
    ref, prev, ref_stats = states[start + 1], states[start], j_stats[start]
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "psnr", "kp_loss", "mpjpc", "temp_loss",
              "grad_norm", "pose_grad_norm"):
        np.testing.assert_allclose(stats[k], ref_stats[k], rtol=LOSS_RTOL, err_msg=k)
    assert ref_stats["kp_loss"] > 0 and ref_stats["temp_loss"] > 0
    for a, b in zip(tt.param_leaves(state.params), tt.param_leaves(ref.params)):
        assert float(np.abs(a.detach().numpy() - b).max()) < PARAM_TOL
    for k, p in state.pose_params.items():
        assert float(np.abs(p.detach().numpy() - ref.pose_params[k]).max()) < PARAM_TOL, k
    jst, pst = ref.pose_opt_state, state.pose_opt_state
    multi = hasattr(jst, "mini_step")
    adam = jst.inner_opt_state[0] if multi else jst[0]
    assert pst.count == int(adam.count)
    for k in state.pose_params:
        np.testing.assert_allclose(pst.mu[k].numpy(), adam.mu[k], atol=1e-7, rtol=1e-4)
        np.testing.assert_allclose(pst.nu[k].numpy(), adam.nu[k], atol=1e-10, rtol=1e-4)
    if multi:
        assert (pst.mini_step, pst.gradient_step) == (int(jst.mini_step), int(jst.gradient_step))
        for k in state.pose_params:
            _assert_grad_close(pst.acc_grads[k].numpy(), jst.acc_grads[k], f"acc_grads {k}")
    return state, ref, prev


@pytest.mark.parametrize("use_fused", [False, True])
def test_pose_step_matches_jax(use_fused):
    """A fresh state, opt_pose_step 3: one step on each side, through the
    plain pipeline and through the trainable kernels' plain versions with
    input gradients. The losses (photometric, regularizer, temporal), the
    NeRF gradients (Adam's first moment / 0.1 in JAX), the pose gradients
    (MultiSteps' first accumulated mean in JAX), the updated NeRF params and
    the unmoved pose params."""
    state, ref, prev = _assert_pose_step("pose", use_fused, 0)
    mu = tt.param_leaves(_adam_state(ref.opt_state).mu)
    for p, m in zip(tt.param_leaves(state.params), mu, strict=True):
        _assert_grad_close(p.grad.numpy(), m / 0.1, "nerf grad")
    for k, p in state.pose_params.items():
        _assert_grad_close(p.grad.numpy(), ref.pose_opt_state.acc_grads[k], f"pose grad {k}")
        assert np.array_equal(p.detach().numpy(), prev.pose_params[k])  # accumulating
    assert state.pose_opt_state.mini_step == 1 and state.pose_opt_state.count == 0


def _count_trainable(monkeypatch):
    """Count the calls of the trainable field (the kernels' route; on the CPU
    their plain versions) -> the list each call appends its pts size to."""
    calls, inner = [], tgrad.trainable_field

    def counted(pts, *args, **kwargs):
        calls.append(pts.shape[0])
        return inner(pts, *args, **kwargs)

    monkeypatch.setattr(tgrad, "trainable_field", counted)
    return calls


def test_pose_step_where_pass_c_refuses_matches_jax(monkeypatch):
    """multires 4 / multires_views 5 with fused_train on, where pass (c)'s
    WMMA plan refused the layout (260,608 bytes) and the pose step ran the
    plain pipeline: its two-kernel plan takes it, so the step goes through
    the trainable kernels (their plain versions here, for the coarse and
    the fine net) and matches the JAX step as test_pose_step_matches_jax's
    does."""
    calls = _count_trainable(monkeypatch)
    state, ref, prev = _assert_pose_step("pose_views5", True, 0)
    assert len(calls) == 2
    mu = tt.param_leaves(_adam_state(ref.opt_state).mu)
    for p, m in zip(tt.param_leaves(state.params), mu, strict=True):
        _assert_grad_close(p.grad.numpy(), m / 0.1, "nerf grad")
    for k, p in state.pose_params.items():
        _assert_grad_close(p.grad.numpy(), ref.pose_opt_state.acc_grads[k], f"pose grad {k}")
        assert np.array_equal(p.detach().numpy(), prev.pose_params[k])


def test_pose_step_at_multires9_is_the_plain_step(monkeypatch):
    """multires 9 / multires_views 4 with fused_train on, where pass (c)'s
    WMMA plan refused the layout (241,152 bytes) and the pose step was the
    fused_train=False step: now it takes the trainable kernels (their plain
    versions here, for both nets), and its gradients hold to the
    fused_train=False step's (per tensor, GRAD_REL of its largest) and its
    losses to the JAX step's. (At this layout the random nets' gradients
    are 1e-7-1e-5, and XLA's and PyTorch's float32 sums differ by ~1e-8 in
    them: up to 1.09e-3 of a tensor's largest, past GRAD_REL; the port's
    two routes are held to each other instead.)"""
    calls = _count_trainable(monkeypatch)
    state, stats = _port_pose_step("pose_multires9", True, 0)
    assert len(calls) == 2
    plain, plain_stats = _port_pose_step("pose_multires9", False, 0)
    assert len(calls) == 2
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "psnr", "kp_loss", "mpjpc", "temp_loss",
              "grad_norm", "pose_grad_norm"):
        np.testing.assert_allclose(stats[k], plain_stats[k], rtol=LOSS_RTOL, err_msg=k)
    for a, b in zip(tt.param_leaves(state.params), tt.param_leaves(plain.params), strict=True):
        _assert_grad_close(a.grad.numpy(), b.grad.numpy(), "nerf grad")
    for k, p in state.pose_params.items():
        q = plain.pose_params[k]
        assert torch.equal(p, q)  # accumulating: unmoved on both routes
        _assert_grad_close(p.grad.numpy(), q.grad.numpy(), f"pose grad {k}")
    _, j_stats = _jax_pose_run("pose_multires9")
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "psnr", "kp_loss", "mpjpc", "temp_loss",
              "grad_norm", "pose_grad_norm"):
        np.testing.assert_allclose(stats[k], j_stats[0][k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("use_fused", [False, True])
def test_carried_pose_state_step_matches_jax(use_fused):
    """Two JAX steps (the accumulation two gradients in), the state carried
    over by train_state_from_numpy, then the third step on each side: the
    accumulated mean goes through Adam and both move the pose alike."""
    state, ref, prev = _assert_pose_step("pose", use_fused, 2)
    assert state.pose_opt_state.mini_step == 0 and state.pose_opt_state.gradient_step == 1
    assert state.pose_opt_state.count == 1
    for k, p in state.pose_params.items():
        assert not np.array_equal(p.detach().numpy(), prev.pose_params[k])
        assert float(state.pose_opt_state.acc_grads[k].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["pose_framecode", "pose_testopt"])
def test_pose_step_variants_match_jax(name):
    """Framecodes with input gradients (the combination that once broke in
    JAX), and testopt: the NeRF frozen, the pose trained (opt_pose_step 1)."""
    state, ref, prev = _assert_pose_step(name, True, 0)
    if name == "pose_testopt":
        assert state.opt_state is None
        for a, b in zip(tt.param_leaves(state.params), tt.param_leaves(prev.params)):
            assert np.array_equal(a.detach().numpy(), b)
        for k, p in state.pose_params.items():
            assert not np.array_equal(p.detach().numpy(), prev.pose_params[k])
    else:
        assert not np.array_equal(state.params["coarse"]["framecodes"].detach().numpy(),
                                  prev.params["coarse"]["framecodes"])


@pytest.mark.parametrize("k", [1, 3])
def test_pose_optimizer_matches_optax(k):
    """Seven updates of fixed gradients, a decaying learning rate, with and
    without MultiSteps(k=3): params and every state leaf after each."""
    kw = dict(opt_pose=True, opt_pose_lrate=1e-2, opt_pose_lrate_decay=1,
              opt_pose_decay_unit=2, opt_pose_decay_rate=0.5, opt_pose_step=k)
    opt = jt.pose_optimizer(jt.TrainConfig(**kw))
    tcfg = tt.TrainConfig(**kw)
    rng = np.random.default_rng(8)
    tree = {"pelvis": rng.standard_normal((3, 3)).astype(np.float32),
            "bones": rng.standard_normal((3, 24, 6)).astype(np.float32)}
    j_params = {n: jnp.asarray(v) for n, v in tree.items()}
    j_state = opt.init(j_params)
    params = {n: torch.tensor(v) for n, v in tree.items()}
    st = tt.init_pose_opt_state(tcfg, params)
    for _ in range(7):
        g = {n: rng.standard_normal(v.shape).astype(np.float32) for n, v in tree.items()}
        upd, j_state = opt.update({n: jnp.asarray(v) for n, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        tt.pose_update(tcfg, st, params, {n: torch.as_tensor(v) for n, v in g.items()})
        adam = j_state.inner_opt_state[0] if k > 1 else j_state[0]
        assert st.count == int(adam.count)
        for n in tree:
            np.testing.assert_allclose(params[n].numpy(), np.asarray(j_params[n]), atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(st.mu[n].numpy(), np.asarray(adam.mu[n]), atol=1e-6)
            np.testing.assert_allclose(st.nu[n].numpy(), np.asarray(adam.nu[n]), atol=1e-6)
        if k > 1:
            assert (st.mini_step, st.gradient_step) == (int(j_state.mini_step),
                                                        int(j_state.gradient_step))
            for n in tree:
                np.testing.assert_allclose(st.acc_grads[n].numpy(),
                                           np.asarray(j_state.acc_grads[n]), atol=1e-6)
    assert st.count == (7 if k == 1 else 2)


TINY = dict(N_samples=8, N_importance=4, netdepth=2, netwidth=32, perturb=0.0)


@pytest.mark.parametrize("gate", [dict(opt_pose_warmup=100), dict(opt_pose_stop=0)])
def test_pose_gating_freezes_every_state_leaf(gate):
    """Outside the warmup / stop window no pose moment, count or
    accumulation advances and the pose does not move, though the NeRF
    trains (JAX test_pose_opt_warmup_freezes_optimizer_state)."""
    cfg = tr.RaycastConfig(**TINY)
    tcfg = tt.TrainConfig(opt_pose=True, opt_pose_step=3, use_temp_loss=True, **gate)
    _, (params, anchors), batch = _pose_init()
    pose = tt.trainable(params_from_numpy(params, "cpu"))
    state = tt.create_train_state(tr.init_raycaster(cfg, torch.Generator().manual_seed(0),
                                                    device="cpu"),
                                  tcfg, pose, params_from_numpy(anchors, "cpu"))
    before = [t.clone() for t in tt.param_leaves([state.pose_params, state.pose_opt_state.mu,
                                                  state.pose_opt_state.nu,
                                                  state.pose_opt_state.acc_grads])]
    nerf0 = [t.detach().clone() for t in tt.param_leaves(state.params)]
    step = tt.make_train_step(cfg, tcfg, topt.PoseOptConfig(opt_pose_tol=0.01),
                              rest_pose=torch.as_tensor(SMPL_REST_POSE), n_frames=N_FRAMES)
    state, stats = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    st = state.pose_opt_state
    assert (st.count, st.mini_step, st.gradient_step) == (0, 0, 0)
    after = tt.param_leaves([state.pose_params, st.mu, st.nu, st.acc_grads])
    assert all(torch.equal(a.detach(), b) for a, b in zip(after, before))
    assert float(stats["pose_grad_norm"]) > 0
    assert any(not torch.equal(a.detach(), b) for a, b in zip(tt.param_leaves(state.params), nerf0))


def test_train_step_contract():
    tt.TrainConfig(opt_pose=True)  # pose refinement is a supported config
    _, _, tcfg, ttcfg = _configs("flagship", None)
    batch = {k: torch.as_tensor(v) for k, v in _batch(False).items()}
    params = {"coarse": {"views_linears": [0]}}
    assert tt._fused_train_mode(tcfg, ttcfg, params, batch) is False  # auto: CPU tensors
    on = dataclasses.replace(ttcfg, fused_train=True)
    assert tt._fused_train_mode(tcfg, on, params, batch) == "train"
    odd = {**batch, "skts": batch["skts"][[0, 1, 1]]}
    assert tt._fused_train_mode(tcfg, on, params, odd) is False
    assert tt._fused_train_mode(dataclasses.replace(tcfg, view_type="world"), on,
                                params, batch) is False
    pose_on = dataclasses.replace(on, opt_pose=True)
    pose_batch = {k: torch.as_tensor(v) for k, v in _pose_batch(False).items()}
    assert tt._fused_train_mode(tcfg, pose_on, params, pose_batch) == "full"
    pose_odd = {**pose_batch, "kp_idx": pose_batch["kp_idx"][[0, 1, 1]]}
    assert tt._fused_train_mode(tcfg, pose_on, params, pose_odd) is False
