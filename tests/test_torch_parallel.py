"""posegen_tpu_torch/parallel/ against posegen_tpu/parallel/ on the CPU.

One 2-rank gloo world per module (`parallel.mesh.launch`, spawned ranks,
a file:// rendezvous) runs every scenario of tests/torch_parallel_ranks.py
on its ranks while this process computes the references: JAX's
counterpart on `make_mesh(2)` of the conftest's 8 virtual CPU devices, and
the port's single-process step on the concatenated batch (the same
scenario function with mesh None). Each rank writes its results; the tests
read them.

Tolerances. Against JAX, the port's own: the train step's parameters to
PARAM_TOL and its stats to LOSS_RTOL (tests/test_torch_train.py), the GAN
steps by tests/test_torch_gan.py's rules (TOL, MOMENT_RTOL, UPDATE_RTOL,
the pre-BN biases by Adam's bound), frames to FRAME_TOL. Against the
single-process step: every updated parameter and BN buffer to SINGLE_TOL
after 2 steps (the two halves' sums are not the whole batch's to the bit),
but for the generator's pre-BN biases, whose gradient is exactly 0 and so
rounding noise that Adam turns into steps of up to lr (held by that
bound, their BN running means to SINGLE_TOL + momentum x steps x lr). The
two ranks' states are equal bit for bit.
"""

import functools
import multiprocessing
import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gan as tgan_t
import test_torch_gen as tgen
import test_torch_train as ttrain
import torch_parallel_ranks as tpr
from posegen_tpu.data import h5dataset as jh
from posegen_tpu.gen import loop as jloop
from posegen_tpu.gen import spin_train as jst
from posegen_tpu.parallel import gan as jpgan
from posegen_tpu.parallel import mesh as jmesh
from posegen_tpu.pose import opt as jopt
from posegen_tpu.render import image as jimage
from posegen_tpu.render import raycast as jr
from posegen_tpu.skeleton.skeleton import SMPL_REST_POSE
from posegen_tpu.train import trainer as jt
from posegen_tpu_torch.cli import run_nerf as prun
from posegen_tpu_torch.data import h5dataset as ph
from posegen_tpu_torch.data import synthetic as psyn
from posegen_tpu_torch.gen import loop as ploop
from posegen_tpu_torch.gen.spin_train import MEAN_PARAM_BUFFERS
from posegen_tpu_torch.parallel import gan as ppgan
from posegen_tpu_torch.parallel import mesh as pmesh
from posegen_tpu_torch.render import raycast as pr

SINGLE_TOL = 1e-5
PARAM_TOL, LOSS_RTOL = ttrain.PARAM_TOL, ttrain.LOSS_RTOL
TOL, FRAME_TOL = tgan_t.TOL, tgan_t.FRAME_TOL
TINY_GEN = dict(width=32, num_stages=1)
STEP_KW = tgan_t.STEP_KW
B, K = tgan_t.B, tgan_t.K
RENDER_CHUNK = 64  # the 16 x 16 window: 4 chunks of 64 rays, 32 a rank
# the flagship nets at 16 + 8 samples a ray (JAX's shard_map step compiles
# in ~15 s, against ~20 s at 64 + 16)
TRAIN_RKW = dict(perturb=0.0, raw_noise_std=0.0, N_samples=16, N_importance=8)
TRAIN_CASES = {
    "train": (TRAIN_RKW,
              dict(rays_per_image=ttrain.RPI, use_background=True, fused_train=True)),
    "train_pose": (TRAIN_RKW,
                   dict(rays_per_image=ttrain.RPI, use_background=True, fused_train=True,
                        opt_pose=True, use_temp_loss=True, opt_pose_step=3)),
}
# the pose case accumulates (opt_pose_step 3, as tests/test_torch_train.py's
# does): at opt_pose_step 1 the first pose update leaves a ReLU unit of the
# fine net (pts_linears[7]) on a knife edge, and the second step's params
# part from the single step's by 1.6e-5 and from JAX's by 6.1e-5 (4.4e-4
# at 64 + 16 samples), as much as the port's single step parts from JAX's.
# The pose gradients are held through MultiSteps' running mean.
POSE_KW = dict(use_rot6d=True, opt_pose_tol=0.01)


# ---------------------------------------------------------------------------
# the inputs (numpy) and JAX's references
# ---------------------------------------------------------------------------

def _compiled(jitted, *args):
    """A jitted JAX step compiled for these arguments at XLA's backend
    optimisation level 0: about half the compile time of the default, its
    results within float32 rounding of it. For the GAN and fine-tune
    steps, whose params are held by relative rules; the train step keeps
    the default (its params are held to PARAM_TOL, which an Adam step on a
    near-zero gradient can take up from such rounding)."""
    return jitted.lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _jax_variables(rkw):
    """JAX's nets of ttrain.SEED (tests/test_torch_train.py's: both nets
    render opaque rays on its batch, so every parameter has a gradient), by
    one jitted init (the eager one compiles op by op)."""
    init = jax.jit(jr.init_raycaster, static_argnums=1)
    return tgen.np_tree(init(jax.random.PRNGKey(ttrain.SEED), jr.RaycastConfig(**dict(rkw))))


def _variables(**kw):
    """Nets and embedder states from the port's init (numpy; the JAX
    package's tree leaf for leaf, and no eager JAX init to compile)."""
    return tpr.to_numpy(pr.init_raycaster(pr.RaycastConfig(**kw),
                                          torch.Generator().manual_seed(0), device="cpu"))


def _train_batch():
    """tests/test_torch_train.py's batch (2 images x 16 rays, per-image pose
    rows, targets and backgrounds), from the port's fixtures."""
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx, make_rays

    rng = np.random.default_rng(0)
    parts = []
    for i in range(ttrain.N_IMAGES):
        ctx = make_pose_ctx(seed=i, device="cpu")
        ro, rd = make_rays(ttrain.RPI, seed=10 + i, device="cpu")
        parts.append({
            "rays_o": ro.numpy(), "rays_d": rd.numpy(),
            "target_s": rng.uniform(0, 1, (ttrain.RPI, 3)).astype(np.float32),
            "bgs": rng.uniform(0, 1, (ttrain.RPI, 3)).astype(np.float32),
            "kp3d": ctx.kps.numpy(), "skts": ctx.skts.numpy(), "bones": ctx.bones.numpy(),
            "cyls": ctx.cyls.numpy(),
        })
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _pose_inputs():
    """tests/test_torch_train.py's pose refinement case from the port's
    pose code: rot6d params over 4 frames drifted from their anchors, 2
    groups x 16 rays at frames 1 and 3."""
    from posegen_tpu_torch.pose import opt as topt
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder

    rng = np.random.default_rng(12)
    bones0 = (rng.standard_normal((ttrain.N_FRAMES, 24, 3)) * 0.2).astype(np.float32)
    kp0 = np.tile(SMPL_REST_POSE[None], (ttrain.N_FRAMES, 1, 1))
    params, anchors = topt.init_pose_params(topt.PoseOptConfig(**POSE_KW), bones0, kp0,
                                            device="cpu")
    params = {"pelvis": params["pelvis"].detach() + 0.01,
              "bones": params["bones"].detach()
              + torch.as_tensor(rng.standard_normal((ttrain.N_FRAMES, 24, 6)) * 0.2).float()}
    with torch.no_grad():
        kps = topt.pose_apply(params, torch.as_tensor(ttrain.KP_IDX).long(),
                              torch.as_tensor(SMPL_REST_POSE))[0]
        cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001).numpy()
    batch = {k: v[:2 * ttrain.RPI] for k, v in _train_batch().items()
             if k in ("rays_o", "rays_d", "target_s", "bgs")}
    batch.update(cyls=cyls, kp_idx=ttrain.KP_IDX,
                 kp3d=(kps.numpy() + rng.standard_normal(kps.shape) * 0.01).astype(np.float32))
    return tpr.to_numpy(params), tpr.to_numpy(anchors), batch


def _train_inputs(name):
    rkw, tkw = TRAIN_CASES[name]
    inp = dict(rkw=rkw, tkw=tkw, variables=_jax_variables(tuple(sorted(rkw.items()))),
               n_frames=0)
    if name == "train":
        inp["batch"] = _train_batch()
    else:
        params, anchors, batch = _pose_inputs()
        inp.update(batch=batch, pose_params=params, pose_anchors=anchors, pkw=POSE_KW,
                   rest_pose=SMPL_REST_POSE, n_frames=ttrain.N_FRAMES)
    return inp


def _jax_train(inp):
    rkw, tkw = inp["rkw"], dict(inp["tkw"], fused_train=False)
    cfg, tcfg = jr.RaycastConfig(**rkw), jt.TrainConfig(**tkw)
    pose, pcfg, kw = (), None, {}
    if tcfg.opt_pose:
        pose = tuple(jax.tree_util.tree_map(jnp.asarray, inp[k])
                     for k in ("pose_params", "pose_anchors"))
        pcfg = jopt.PoseOptConfig(**inp["pkw"])
        kw = dict(rest_pose=jnp.asarray(inp["rest_pose"]), n_frames=inp["n_frames"])
    state = jt.create_train_state(jax.tree_util.tree_map(jnp.asarray, inp["variables"]), tcfg,
                                  *pose)
    step = jmesh.make_shardmap_train_step(cfg, tcfg, pcfg, mesh=jmesh.make_mesh(2),
                                          fold_key_per_device=False, **kw)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    stats, states = [], []
    for _ in range(2):
        state, st = step(state, batch, jax.random.PRNGKey(5))
        stats.append({k: float(v) for k, v in st.items()})
        states.append(jax.tree_util.tree_map(np.array, state))
    return stats, states


def _gan_inputs():
    """tests/test_torch_gan.py's G / D inputs, the weights from the port's
    inits, and the global noises JAX's step draws from keys 10 and 11."""
    from posegen_tpu_torch.gen.discriminators import init_pos3d_discriminator
    from posegen_tpu_torch.gen.generators import GenConfig, init_pose_generator

    p, s = init_pose_generator(torch.Generator().manual_seed(0), GenConfig(**TINY_GEN), "cpu")
    d = init_pos3d_discriminator(torch.Generator().manual_seed(1), "cpu")
    real, fake, spin_pred, sel = tgan_t._gan_inputs()
    noises = jax.jit(tgen.jax_noises, static_argnums=(1, 2))
    return dict(gen_cfg=TINY_GEN, step_kw=STEP_KW, g_params=tpr.to_numpy(p),
                g_state=tpr.to_numpy(s), d_params=tpr.to_numpy(d), real=real, fake=fake,
                spin_pred=spin_pred, sel=sel,
                noises=[tgen.np_tree(noises(jax.random.PRNGKey(10 + i), B,
                                            jloop.GenConfig(**TINY_GEN)))
                        for i in range(2)])


def _jax_gan(inp):
    mesh = jmesh.make_mesh(2)
    g_opt, g_step = jpgan.make_parallel_generator_step(
        mesh, lambda b: jloop.fk_joints(b, 0.4), jloop.GenConfig(**TINY_GEN), **STEP_KW)
    d_opt, d_step = jpgan.make_parallel_discriminator_step(mesh, **STEP_KW)
    p, s, d = (jax.tree_util.tree_map(jnp.asarray, inp[k])
               for k in ("g_params", "g_state", "d_params"))
    g_os, d_os = g_opt.init(p), d_opt.init(d)
    g_args = (jnp.asarray(inp["real"]), jnp.asarray(inp["spin_pred"]), jnp.asarray(inp["sel"]),
              jnp.asarray(1.0))
    real = jnp.asarray(inp["real"])
    g_step = _compiled(g_step, p, s, g_os, d, jax.random.PRNGKey(10), *g_args)
    d_step = _compiled(d_step, d, d_os, real, jnp.asarray(inp["fake"]))
    g_stats, d_stats = [], []
    for i in range(2):
        p, s, g_os, out, st = g_step(p, s, g_os, d, jax.random.PRNGKey(10 + i), *g_args)
        g_stats.append(tgen.np_tree(st))
        d, d_os, st = d_step(d, d_os, real, jnp.asarray(inp["fake"] + 0.1 * i))
        d_stats.append(tgen.np_tree(st))
    return dict(g_stats=g_stats, d_stats=d_stats, g_params=tgen.np_tree(p),
                g_state=tgen.np_tree(s), g_adam=tgen.np_tree(g_os[1][0]),
                out=tgen.np_tree(out), d_params=tgen.np_tree(d), d_adam=tgen.np_tree(d_os[1][0]))


def _spin_case(rng, n, corrupt):
    """tests/test_torch_gan.py's _spin_case on the port's FK."""
    aa = (rng.standard_normal((n, 24, 3)) * 0.2).astype(np.float32)
    gt = ploop.fk_joints(torch.as_tensor(aa), 0.4).numpy()
    gt = gt + corrupt[:, None, None] * rng.standard_normal(gt.shape).astype(np.float32)
    return aa, gt.astype(np.float32)


def _hinge_inputs():
    """6 samples, 3 a rank: rows 0, 1 and 4 within the hinge (near their
    GT), so each rank keeps some and the kept count differs by rank."""
    from posegen_tpu_torch.skeleton.rotations import axisang_to_rot

    rng = np.random.default_rng(3)
    corrupt = np.array([0.01, 0.01, 1, 1, 0.01, 1.0], np.float32)
    aa, gt = _spin_case(rng, 6, corrupt)
    return dict(rot=axisang_to_rot(torch.as_tensor(aa)).numpy(), gt=gt)


def _finetune_inputs(kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, tgan_t.SPIN_RES_TEST, tgan_t.SPIN_RES_TEST, 3)).astype(
        np.float32)
    inp = dict(kind=kind, x=x.transpose(0, 3, 1, 2).copy())
    if kind == "spin":
        inp["gt"] = _spin_case(rng, 4, np.zeros(4, np.float32))[1]
    else:
        inp["gt"] = (rng.standard_normal((4, 14, 3)) * 0.3).astype(np.float32)
        j_reg = rng.uniform(0, 1, (17, 20)).astype(np.float32)
        inp["j_reg"] = j_reg / j_reg.sum(1, keepdims=True)
    return inp


def _jax_finetune(inp, hmr):
    mesh = jmesh.make_mesh(2)
    if inp["kind"] == "spin":
        opt, step = jpgan.make_parallel_spin_finetune_step(mesh, lr=1e-4, hinge=None)
    else:
        opt, step = jpgan.make_parallel_ski_finetune_step(
            mesh, tgan_t._mock_smpl("jax"), inp["j_reg"], lr=1e-4)
    p = jax.tree_util.tree_map(jnp.asarray, hmr[0])
    os1 = opt.init(p)
    args = (p, jax.tree_util.tree_map(jnp.asarray, hmr[1]), os1,
            jnp.asarray(inp["x"].transpose(0, 2, 3, 1)), jnp.asarray(inp["gt"]), None)
    p1, os1, stats = _compiled(step, *args)(*args)
    return tgen.np_tree(p1), tgen.np_tree(os1.inner_states["train"].inner_state[0]), \
        tgen.np_tree(stats)


@functools.lru_cache(maxsize=None)
def _render_inputs():
    """tests/test_torch_gan.py's feedback scene: the tiny NeRF, its coarse
    alpha biased up by 2 so the frames are not empty, two poses whose
    window rays all meet their cylinders (no chunk-mean near / far)."""
    params = _variables(**tgan_t.TINY_NERF)
    params["coarse"]["alpha_linear"]["b"] = params["coarse"]["alpha_linear"]["b"] + 2.0
    bones = (np.random.default_rng(7).standard_normal((2, 24, 3)) * 0.2).astype(np.float32)
    assert tgan_t._window_rays_hit(bones)
    return dict(nerf_cfg=tgan_t.TINY_NERF, nerf=params, hw=tgan_t.HW,
                focal=tgan_t.FOCAL, chunk=RENDER_CHUNK, bones=bones,
                c2ws=np.array(tgan_t._c2ws(2)), window=tgan_t.WINDOW)


def _jax_render(inp):
    cfg = jr.RaycastConfig(**inp["nerf_cfg"])
    params = jax.tree_util.tree_map(jnp.asarray, inp["nerf"])
    mesh = jmesh.make_mesh(2)
    ren = jloop.NeRFRenderer(cfg, params, hw=inp["hw"], focal=inp["focal"], chunk=RENDER_CHUNK)
    ren.chunk = RENDER_CHUNK
    out = {}
    real = jimage.render_images_pipelined
    for half in (True, False):
        ren._render_fn = jmesh.make_shardmap_render_cam(cfg, mesh, RENDER_CHUNK,
                                                        half_readback=half)
        jimage.render_images_pipelined = (
            lambda *a, _h=half, **kw: real(*a, **{**kw, "half_readback": _h}))
        try:
            out["half" if half else "f32"] = ren.render_poses(inp["bones"], inp["c2ws"],
                                                              window=inp["window"])
        finally:
            jimage.render_images_pipelined = real
    return out


def _epoch_inputs(sink):
    return dict(_render_inputs(), loop_cfg=dict(tgan_t.LOOP_CFG), gen_cfg=TINY_GEN,
                poses=tgan_t._epoch_poses(), sink=sink)


@functools.lru_cache(maxsize=None)
def _world(tmp: str):
    """Launch the world, compute the references meanwhile, join -> (inputs,
    {rank: results}, {scenario: single-process result}, JAX's)."""
    inputs = {name: _train_inputs(name) for name in TRAIN_CASES}
    inputs.update(hmr=tgen.hmr_weights(), gan_steps=_gan_inputs(), spin_hinge=_hinge_inputs(),
                  finetune_spin=_finetune_inputs("spin"), finetune_ski=_finetune_inputs("ski"),
                  render=_render_inputs(), gan_epoch=_epoch_inputs(os.path.join(tmp, "sink")))
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    # the single-process references in a process of their own (outside the
    # world: its renders must not take the world's cam render)
    one = multiprocessing.get_context("spawn").Process(target=tpr.rank_main,
                                                       args=(None, path, tmp, "single"))
    one.start()
    try:
        # the world on a thread of its own; JAX's compiles release the GIL:
        # several at a time beside it
        jobs = {name: functools.partial(_jax_train, inputs[name]) for name in TRAIN_CASES}
        jobs.update(gan_steps=functools.partial(_jax_gan, inputs["gan_steps"]),
                    render=functools.partial(_jax_render, inputs["render"]),
                    **{k: functools.partial(_jax_finetune, inputs[k], inputs["hmr"])
                       for k in ("finetune_spin", "finetune_ski")})
        with ThreadPoolExecutor(5) as pool:
            world = pool.submit(pmesh.launch, tpr.rank_main, 2, "cpu", args=(path, tmp))
            futures = {k: pool.submit(fn) for k, fn in jobs.items()}
            jax_ref = {k: f.result() for k, f in futures.items()}
            world.result()
    finally:
        one.join()
    assert one.exitcode == 0, f"the single-process references exited {one.exitcode}"
    out = {}
    for name in ("rank0", "rank1", "single"):
        with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
            out[name] = pickle.load(f)
    # the pickles hold the HMR's params and moments (~1 GB in all)
    for name in ("rank0", "rank1", "single", "inputs"):
        os.remove(os.path.join(tmp, f"{name}.pkl"))
    return inputs, {0: out["rank0"], 1: out["rank1"]}, out["single"], jax_ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _world(str(tmp_path_factory.mktemp("world")))


def _leaves(tree, prefix=""):
    """[(path, numpy leaf)] of a nested dict / list tree, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, np.asarray(tree))]


def _assert_close(got, want, atol, what=""):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, f"{what}{path}"
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert err <= atol, f"{what}{path}: {err}"


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.as_tensor(np.asarray(tree))


# ---------------------------------------------------------------------------
# the world's scenarios
# ---------------------------------------------------------------------------

def test_ranks_end_bit_equal(world):
    """Every scenario leaves the same state, stats and outputs on both
    ranks: the replicated state never parts ways."""
    _, ranks, _, _ = world
    for name in tpr.SCENARIOS:
        a, b = ranks[0][name], ranks[1][name]
        if name.startswith("finetune"):
            a, b = {k: v for k, v in a.items() if k not in ("params", "mu")}, b
        assert set(a) == set(b), name
        for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
            if x.dtype.kind in "fc":
                assert x.tobytes() == y.tobytes(), f"{name}{path}"
            else:
                assert np.array_equal(x, y), f"{name}{path}"


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_matches_jax_and_single(world, name):
    """Two steps of the 2-rank train step (the trainable kernels' route,
    their plain versions here; weights-only, and with pose refinement)
    against JAX's shard_map step on make_mesh(2) and against the port's
    single-process step on the concatenated batch; every parameter moves
    in the first step."""
    inputs, ranks, single, jax_ref = world
    got = ranks[0][name]
    want_stats, wants = jax_ref[name]
    want = wants[-1]
    keys = ["total_loss", "grad_norm", "rgb_loss", "rgb0_loss", "psnr"]
    if name == "train_pose":
        keys += ["kp_loss", "mpjpc", "temp_loss", "pose_grad_norm"]
    for i in range(2):
        for k in keys:
            np.testing.assert_allclose(got["stats"][i][k], want_stats[i][k], rtol=LOSS_RTOL,
                                       err_msg=f"{i} {k}")
    assert got["step"] == 2 == int(want.step)
    start = [a for _, a in _leaves({k: inputs[name]["variables"][k] for k in ("coarse", "fine")})]
    assert all(not np.array_equal(a, b)
               for (_, a), b in zip(_leaves(got["params_1"]), start, strict=True))
    for params, ref in ((got["params_1"], wants[0]), (got["params"], want)):
        g = [a for _, a in _leaves(params)]
        w = [np.asarray(b) for b in jax.tree_util.tree_leaves(ref.params)]
        assert len(g) == len(w) >= 40
        for a, b in zip(g, w):
            assert float(np.abs(a - b).max()) < PARAM_TOL
    if name == "train_pose":
        for k, v in got["pose_params"].items():
            np.testing.assert_array_equal(v, inputs[name]["pose_params"][k])  # accumulating
        jst = want.pose_opt_state
        assert (got["pose_mini_step"], int(jst.mini_step)) == (2, 2)
        for k, v in got["pose_acc"].items():
            ttrain._assert_grad_close(v, jst.acc_grads[k], f"acc_grads {k}")
    # the single-process step: every stat but psnr (a mean of the ranks'
    # psnr, as JAX's pmean makes it) and every updated tensor
    one = single[name]
    for i in range(2):
        for k in (k for k in keys if k != "psnr"):
            np.testing.assert_allclose(got["stats"][i][k], one["stats"][i][k],
                                       rtol=SINGLE_TOL, err_msg=f"{i} {k}")
    for part in ("params_1", "params", "embeds", "pose_params", "pose_acc"):
        if part in one:
            _assert_close(got[part], one[part], SINGLE_TOL, part)


def test_gan_steps_match_jax_and_single(world):
    """Two G steps with the SPIN feedback on and two D steps over 2 ranks:
    against JAX's make_parallel_*_step on make_mesh(2) (stats, params, BN
    state, Adam moments, the gathered poses) and against the single
    steps."""
    inputs, ranks, single, jax_ref = world
    got, want, one = ranks[0]["gan_steps"], jax_ref["gan_steps"], single["gan_steps"]
    for i in range(2):
        for part in ("g_stats", "d_stats"):
            for k, v in want[part][i].items():
                np.testing.assert_allclose(got[part][i][k], v, rtol=TOL, atol=TOL,
                                           err_msg=f"{part} {i} {k}")
                np.testing.assert_allclose(got[part][i][k], one[part][i][k], rtol=SINGLE_TOL,
                                           atol=SINGLE_TOL, err_msg=f"single {part} {i} {k}")
    inp, lr = inputs["gan_steps"], STEP_KW["lr"]
    tgan_t._assert_generator(_tensors(got["g_params"]), want["g_params"], inp["g_params"],
                             _tensors(got["g_mu"]), want["g_adam"].mu, _tensors(got["g_nu"]),
                             want["g_adam"].nu, _tensors(got["g_state"]), want["g_state"], 2, lr)
    tgan_t._assert_updates(_tensors(got["d_params"]), want["d_params"], inp["d_params"], 2, lr)
    for name, a, b, _ in tgan_t._pairs(_tensors(got["d_mu"]), want["d_adam"].mu):
        assert tgan_t._rel_l2(a, b) <= tgan_t.MOMENT_RTOL, name
    tgen.assert_trees(_tensors(got["out"]), want["out"])
    _assert_close(got["out"], one["out"], SINGLE_TOL, "out")
    for part in ("d_params", "d_mu", "d_nu"):
        _assert_close(got[part], one[part], SINGLE_TOL, part)
    _assert_single_generator(got, one, 2, lr)


def _assert_single_generator(got, one, n_steps, lr, prefix="g_"):
    """A generator's params, BN state and first moment against the single
    step's: SINGLE_TOL, but for the pre-BN biases (Adam's bound; their
    moment at the noise level) and the BN running means (SINGLE_TOL +
    momentum x steps x lr)."""
    for part in (f"{prefix}params", f"{prefix}mu", f"{prefix}state"):
        if part not in got:
            continue
        for (path, a), (_, b) in zip(_leaves(got[part]), _leaves(one[part]), strict=True):
            err = float(np.abs(a - b).max())
            if path.endswith(("['w_in']['b']", "['w1']['b']", "['w2']['b']")):
                bound = (2 * n_steps * lr if part.endswith("params")
                         else tgan_t.NOISE_MU if part.endswith("mu") else SINGLE_TOL)
            elif path.endswith("['mean']"):
                bound = SINGLE_TOL + 0.1 * n_steps * lr
            else:
                bound = SINGLE_TOL
            assert err <= bound, f"{part}{path}: {err}"


def test_spin_hinge_loss_sums_to_the_global_loss(world):
    """spin_pose_loss with the hinge over 2 ranks, each keeping a different
    count: the summed loss and d loss / d rotmat are JAX's (the global kept
    count) and the single-process loss's."""
    inputs, ranks, single, _ = world
    inp, got, one = inputs["spin_hinge"], ranks[0]["spin_hinge"], single["spin_hinge"]
    (jloss, jps), jgrad = jax.jit(jax.value_and_grad(
        lambda r: jst.spin_pose_loss(r, jnp.asarray(inp["gt"]), 0.4, 0.02), has_aux=True))(
        jnp.asarray(inp["rot"]))
    keep = np.asarray(jps) < 0.02
    assert keep[:3].sum() != keep[3:].sum() and keep.sum() > 0
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=TOL)
    np.testing.assert_allclose(got["grad"], np.asarray(jgrad), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=SINGLE_TOL)
    np.testing.assert_allclose(got["grad"], one["grad"], rtol=SINGLE_TOL, atol=SINGLE_TOL)
    np.testing.assert_array_equal(got["per_sample"], one["per_sample"])


@pytest.mark.parametrize("kind", ["spin", "ski"])
def test_finetune_step_matches_jax_and_single(world, kind):
    """One BN-frozen SPIN / SKI fine-tune step over 2 ranks, no dropout:
    loss, per-sample errors, the gradients (Adam's mu / 0.1) and the
    params against JAX's parallel step on make_mesh(2) and against the
    single step."""
    from posegen_tpu_torch.train.trainer import param_leaves
    from posegen_tpu_torch.utils.convert import hmr_from_numpy

    inputs, ranks, single, jax_ref = world
    name = f"finetune_{kind}"
    got, one = ranks[0][name], single[name]
    wp, wadam, wstats = jax_ref[name]
    np.testing.assert_allclose(got["spin_loss"], float(wstats["spin_loss"]), rtol=TOL)
    np.testing.assert_allclose(got["per_sample"], wstats["per_sample"], rtol=TOL)
    assert got["count"] == int(wadam.count) == 1
    # JAX's params and mu carried to the port's layout, leaf by leaf (in
    # param_leaves' order: dict keys sorted; conv weights HWIO -> OIHW)
    p0, s0 = inputs["hmr"]
    flat = lambda tree: [t.detach().numpy().reshape(-1)  # noqa: E731
                         for t in param_leaves(hmr_from_numpy(tree, s0, "cpu")[0])]
    offs = 0
    for a0, b in zip(flat(p0), flat(wp), strict=True):
        a = got["params"][offs:offs + a0.size]
        offs += a0.size
        assert np.abs(a - b).max() <= 2 * 1e-4
        assert np.array_equal(b, a0) or tgan_t._rel_l2(a - a0, b - a0) <= tgan_t.UPDATE_RTOL
    assert offs == got["params"].size
    offs = 0
    for path, b in _leaves({k: wadam.mu[k] for k in p0 if k not in MEAN_PARAM_BUFFERS}):
        b = (b.transpose(3, 2, 0, 1) if b.ndim == 4 else b).reshape(-1)
        a = got["mu"][offs:offs + b.size]
        offs += b.size
        assert tgan_t._rel_l2(a, b) <= tgan_t.SPIN_GRAD_RTOL, path
    assert offs == got["mu"].size
    # the single-process step
    np.testing.assert_allclose(got["spin_loss"], one["spin_loss"], rtol=SINGLE_TOL)
    np.testing.assert_allclose(got["per_sample"], one["per_sample"], rtol=SINGLE_TOL)
    assert float(np.abs(got["params"] - one["params"]).max()) <= SINGLE_TOL
    assert tgan_t._rel_l2(got["mu"], one["mu"]) <= SINGLE_TOL


@pytest.mark.parametrize("half", [True, False])
def test_cam_render_matches_jax_and_single(world, half):
    """The feedback frames through make_shardmap_render_cam over 2 ranks
    (each renders 32 of every 64-ray chunk; the f16 arm through
    NeRFRenderer, which took the cam render from auto_render_fn): against
    JAX's cam render on make_mesh(2) and against the single render."""
    _, ranks, single, jax_ref = world
    key = "half" if half else "f32"
    got, one = ranks[0]["render"], single["render"]
    assert got["cam_render"] and not one["cam_render"] and got["chunk"] == RENDER_CHUNK
    frames = got[key]
    assert frames.shape == (2, tgan_t.HW, tgan_t.HW, 3) and float(frames.max()) > 0.0
    np.testing.assert_allclose(frames, jax_ref["render"][key], rtol=0,
                               atol=FRAME_TOL if half else TOL)
    np.testing.assert_allclose(frames, one[key], rtol=0,
                               atol=FRAME_TOL if half else SINGLE_TOL)


def test_host_ray_render_matches_single(world):
    """make_shardmap_render on 255 host rays of the window (each rank 128,
    the last ray repeated on rank 1 and cut from the gathered maps)
    against render_rays on the 255 in one process."""
    _, ranks, single, _ = world
    got, one = ranks[0]["render"]["rays"], single["render"]["rays"]
    assert got["rgb_map"].shape == (255, 3) and float(got["acc_map"].max()) > 0.0
    _assert_close(got, one, SINGLE_TOL, "maps")


def test_gan_trainer_epoch_over_two_ranks_equals_single(world):
    """GanTrainer(mesh=...) over one epoch (feedback at iterations 0 and 2
    through the cam render, D steps at 0 and 2, the PNG sink) against the
    single trainer's epoch; then train_spin(mesh=...) on the sink. The
    discriminator's params after its 2 steps are within 4.6e-8 of the
    single trainer's."""
    inputs, ranks, single, _ = world
    got, one = ranks[0]["gan_epoch"], single["gan_epoch"]
    assert len(got["steps"]) == len(one["steps"]) == 4
    for i, (a, b) in enumerate(zip(got["steps"], one["steps"])):
        assert set(a) == set(b), i
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=SINGLE_TOL, atol=SINGLE_TOL,
                                       err_msg=f"{i} {k}")
    assert got["epoch"]["n_feedback_iters"] == one["epoch"]["n_feedback_iters"] == 2.0
    assert got["files"] == one["files"] == [f"{i:05d}.png" for i in range(4)]
    np.testing.assert_allclose(got["last_bones"], one["last_bones"], atol=SINGLE_TOL, rtol=0)
    np.testing.assert_allclose(got["pool"], one["pool"], atol=SINGLE_TOL, rtol=0)
    lr = ploop.GanLoopConfig().lr_g
    _assert_single_generator(got, one, 4, lr)
    _assert_close(got["d_params"], one["d_params"], SINGLE_TOL, "d_params")
    sink = inputs["gan_epoch"]["sink"] + "_mesh"
    assert os.listdir(os.path.join(sink, "spin_ckpts")) == ["spin_000.npz"]
    assert len(got["spin_history"]) == 1 and np.isfinite(got["spin_history"][0]["spin_loss"])


# ---------------------------------------------------------------------------
# without a world: the batch layout, the refusals, the loader's shard
# ---------------------------------------------------------------------------

FAKE_MESH = pmesh.Mesh(None, 0, 2, torch.device("cpu"), "gloo")


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["rays_and_groups", "one_group", "scalar", "ragged_groups",
                                  "ragged_rays"])
def test_batch_pspecs_matches_jax(case):
    n = 32
    batch = {"rays_o": np.zeros((n, 3)), "target_s": np.zeros((n, 3)), "cyls": np.zeros((4, 5)),
             "skts": np.zeros((4, 24, 4, 4)), "kp_idx": np.zeros((4,)), "bg": np.zeros((1, 3)),
             "step": np.float32(0)}
    if case == "one_group":
        batch.update(cyls=np.zeros((1, 5)), skts=np.zeros((1, 24, 4, 4)))
    if case == "ragged_groups":
        batch["skts"] = np.zeros((3, 24, 4, 4))
    if case == "ragged_rays":
        batch.update(rays_o=np.zeros((31, 3)))
    want = _outcome(lambda: jmesh.batch_pspecs(batch, 2))
    assert _outcome(lambda: pmesh.batch_pspecs(batch, 2)) == want
    if want is None:
        specs = jmesh.batch_pspecs(batch, 2)
        assert pmesh.batch_pspecs(batch, 2) == {k: v != jax.sharding.PartitionSpec()
                                                for k, v in specs.items()}
    else:
        assert case.startswith("ragged")


def test_ragged_batches_are_refused_with_jax_messages():
    """A batch the mesh does not divide: the G, D and fine-tune steps and
    the cam render's chunk raise JAX's errors before any collective."""
    jm = jmesh.make_mesh(2)
    fk = lambda b: b  # noqa: E731
    real = np.zeros((7, 24, 3), np.float32)
    cases = [
        (lambda: jpgan.make_parallel_generator_step(jm, fk)[1](
            None, None, None, None, None, jnp.asarray(real), None, None, None),
         lambda: ppgan.make_parallel_generator_step(FAKE_MESH, fk)[1](
             None, None, None, None, None, torch.as_tensor(real), None, None, None)),
        (lambda: jpgan.make_parallel_discriminator_step(jm)[1](
            None, None, jnp.asarray(real), jnp.asarray(real)),
         lambda: ppgan.make_parallel_discriminator_step(FAKE_MESH)[1](
             None, None, torch.as_tensor(real), torch.as_tensor(real))),
        (lambda: jpgan.make_parallel_spin_finetune_step(jm)[1](
            None, None, None, jnp.zeros((3, 8, 8, 3)), None, None),
         lambda: ppgan.make_parallel_spin_finetune_step(FAKE_MESH)[1](
             None, None, None, torch.zeros(3, 3, 8, 8), None, None)),
        (lambda: jmesh.make_shardmap_render_cam(jr.RaycastConfig(), jm, 101),
         lambda: pmesh.make_shardmap_render_cam(pr.RaycastConfig(), FAKE_MESH, 101)),
    ]
    for jfn, pfn in cases:
        want = _outcome(jfn)
        assert want is not None and _outcome(pfn) == want


def test_run_gan_refuses_a_world_that_does_not_divide_the_batch(monkeypatch):
    """run_gan under a world of 2 ranks and --batch_size 3: refused before
    any mesh is made (each rank would otherwise run the whole loop and
    write the same files); a batch of 4 takes the mesh."""
    from posegen_tpu_torch.cli import run_gan

    made = []
    monkeypatch.setattr(pmesh, "world_size", lambda: 2)
    monkeypatch.setattr(pmesh, "make_mesh", lambda: made.append(FAKE_MESH) or FAKE_MESH)
    with pytest.raises(ValueError, match=re.escape("--batch_size (3) must divide evenly over "
                                                   "the 2 ranks")):
        run_gan.main(["--batch_size", "3", "--epochs", "1"], device="cpu")
    assert made == []
    assert run_gan.gan_mesh(4) is FAKE_MESH and made == [FAKE_MESH]


def test_make_mesh_takes_the_device_init_rank_chose(tmp_path):
    """A 1-rank gloo group started by init_rank gives a mesh on the device
    it was given; one started by init_process_group directly does not say
    where its ranks compute, and make_mesh refuses it (never the CPU by
    default)."""
    init = f"file://{tmp_path}/rendezvous"
    torch.distributed.init_process_group("gloo", init_method=init + "0", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="rank's device is unknown"):
            pmesh.make_mesh()
    finally:
        torch.distributed.destroy_process_group()
    assert pmesh.init_rank(init + "1", 0, 1, "cpu") == torch.device("cpu")
    try:
        mesh = pmesh.make_mesh()
        assert (mesh.rank, mesh.size, mesh.device, mesh.backend) == (0, 1, torch.device("cpu"),
                                                                      "gloo")
    finally:
        pmesh.shutdown()


def test_gan_trainer_and_make_mesh_refusals():
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ploop.GanTrainer(ploop.GanLoopConfig(), None, mesh=jmesh.make_mesh(2), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh()
    assert pmesh.auto_render_fn(pr.RaycastConfig(), 4096) == (None, 4096)
    assert pmesh.node_index_count() == (0, 1) and pmesh.world_size() == 1


@functools.lru_cache(maxsize=None)
def _h5(tmp: str) -> str:
    return psyn.make_synthetic_h5(os.path.join(tmp, "data.h5"), n_images=12, H=24, W=32,
                                  n_poses=6)


@pytest.mark.parametrize("process_index", [0, 1])
def test_loader_shard_draws_jax_s_batches(tmp_path_factory, process_index):
    """RayBatchLoader(process_index, process_count=2): the same images and
    pixels as JAX's loader, key for key, batch after batch (3 batches of 4
    images: one epoch of 12 images is 6 a node); the two nodes' images of
    an epoch are disjoint and cover it; an index out of range is refused."""
    path = _h5(str(tmp_path_factory.mktemp("loader")))
    loaders = [mod.RayBatchLoader(mod.H5RayDataset(path, 8, seed=5), n_images_per_batch=4,
                                  seed=5, process_index=process_index, process_count=2)
               for mod in (ph, jh)]
    for _ in range(3):
        got, want = (ld.make_batch() for ld in loaders)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert loaders[0].seed == loaders[1].seed == 5 + 100003 * process_index
    other = ph.RayBatchLoader(ph.H5RayDataset(path, 8, seed=5), n_images_per_batch=6, seed=5,
                              process_index=1 - process_index, process_count=2)
    mine = ph.RayBatchLoader(ph.H5RayDataset(path, 8, seed=5), n_images_per_batch=6, seed=5,
                             process_index=process_index, process_count=2)
    a, b = mine._next_idxs(), other._next_idxs()
    assert set(a) | set(b) == set(range(12)) and not set(a) & set(b)
    with pytest.raises(ValueError, match=re.escape("process_index 2 not in [0, 2)")):
        ph.RayBatchLoader(ph.H5RayDataset(path, 8), process_index=2, process_count=2)


# ---------------------------------------------------------------------------
# the CLI's multi-device branch
# ---------------------------------------------------------------------------

def test_run_nerf_on_two_cpu_ranks(tmp_path, monkeypatch):
    """run_nerf --device cpu --n_devices 2: two gloo ranks take 2 steps on
    halves of each batch, with a val render over both ranks; the run ends
    with the ranks' states checked bit-equal, and rank 0 alone writes (one
    line a step in sched.txt, one val line). TensorFlow is hidden from the
    ranks (a module that fails to import, first on the path they inherit):
    tensorboard's SummaryWriter falls back to its own stub instead of a
    ~10 s import; each rank takes one OpenMP thread."""
    from posegen_tpu_torch.train.checkpoints import latest_checkpoint

    (tmp_path / "hide").mkdir()
    (tmp_path / "hide" / "tensorflow.py").write_text("raise ImportError('hidden')\n")
    monkeypatch.syspath_prepend(str(tmp_path / "hide"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share the cores
    os.makedirs(tmp_path / "data" / "synthetic")
    psyn.make_synthetic_h5(str(tmp_path / "data" / "synthetic" / "demo.h5"))
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic",
                                     "demo.txt"),
            "--data_root", str(tmp_path / "data"), "--basedir", str(tmp_path / "logs"),
            "--n_iters", "2", "--i_print", "1", "--i_weights", "2", "--i_testset", "2",
            "--i_video", "0", "--num_workers", "0", "--n_devices", "2"]
    assert prun.rank_count(2, torch.device("cpu")) == 2
    assert prun.rank_count(0, torch.device("cpu")) == 1
    log_dir = prun.train(argv, device="cpu")
    with open(os.path.join(log_dir, "sched.txt")) as f:
        assert [line.split("\t")[0] for line in f] == ["1", "2"]
    with open(os.path.join(log_dir, "psnr.txt")) as f:
        assert len(f.readlines()) == 1
    assert latest_checkpoint(log_dir).endswith("00000002.ckpt.npz")
    with pytest.raises(SystemExit, match="multiple of the device count"):
        prun.train([*argv[:-1], "2", "--N_sample_images", "3"], device="cpu")
