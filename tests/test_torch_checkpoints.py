"""posegen_tpu_torch.train.checkpoints against posegen_tpu.train.checkpoints:
the .npz train states both ways in the four optimizer layouts (optax.adam,
with add_decayed_weights, testopt's set_to_zero, and the pose optimizer's
MultiSteps), the reference .tar scheme both ways, and the pose files. Every
array is held exactly: the files carry float32 and int32 as they are."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from posegen_tpu.render import raycast as jr
from posegen_tpu.train import checkpoints as jck
from posegen_tpu.train import trainer as jt
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train import checkpoints as tck
from posegen_tpu_torch.train import trainer as tt
from posegen_tpu_torch.utils.convert import params_from_numpy, train_state_from_numpy

TINY = dict(N_samples=8, N_importance=4, netdepth=2, netwidth=32)
N_FRAMES = 4
# (TrainConfig kwargs, with pose refinement)
CONFIGS = {
    "adam": ({}, False),
    "weight_decay": ({"weight_decay": 1e-4}, False),
    "testopt": ({"testopt": True}, False),
    "pose_multisteps": ({"opt_pose": True, "opt_pose_step": 3}, True),
}


def _pose_tree(rng):
    return {"bones": rng.standard_normal((N_FRAMES, 24, 3)).astype(np.float32),
            "pelvis": rng.standard_normal((N_FRAMES, 3)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_state(name, seed=0):
    """A JAX TrainState of the config whose every leaf is drawn from a seed:
    floats uniform in [0.1, 1) (Adam's second moments must not be
    negative), counters 2 (moments, counts and MultiSteps' accumulation all
    nonzero, as mid-run)."""
    tkw, pose = CONFIGS[name]
    variables = jr.init_raycaster(jax.random.PRNGKey(seed), jr.RaycastConfig(**TINY))
    rng = np.random.default_rng(seed + 1)
    pp = _pose_tree(rng) if pose else None
    state = jt.create_train_state(variables, jt.TrainConfig(**tkw), pose_params=pp,
                                  pose_anchors=_pose_tree(rng) if pose else None)

    def fill(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return rng.uniform(0.1, 1.0, a.shape).astype(a.dtype)
        return np.full(a.shape, 2, a.dtype)

    return jax.tree_util.tree_map(fill, state)


def _template(name):
    """A fresh port state of the config from other weights."""
    tkw, pose = CONFIGS[name]
    j = jr.init_raycaster(jax.random.PRNGKey(7), jr.RaycastConfig(**TINY))
    variables = params_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    pp = params_from_numpy(_pose_tree(np.random.default_rng(9)), "cpu") if pose else None
    return tt.create_train_state(variables, tt.TrainConfig(**tkw), pose_params=pp,
                                 pose_anchors=pp)


def _eq(a, b, what):
    assert a.dtype == b.dtype and a.device == b.device, what
    assert torch.equal(a, b), what


def _assert_same_state(got: tt.TrainState, want: tt.TrainState):
    assert got.step == want.step
    for part in ("params", "embeds", "pose_params", "pose_anchors"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is None:
            continue
        for i, (x, y) in enumerate(zip(tt.param_leaves(g), tt.param_leaves(w), strict=True)):
            _eq(x, y, f"{part}[{i}]")
            assert x.requires_grad == y.requires_grad, part
    assert (got.opt_state is None) == (want.opt_state is None)
    if got.opt_state is not None:
        assert got.opt_state.defaults == want.opt_state.defaults
        for i, (p, q) in enumerate(zip(tt.param_leaves(got.params), tt.param_leaves(want.params))):
            sg, sw = got.opt_state.state[p], want.opt_state.state[q]
            assert sorted(sg) == sorted(sw)
            for k in sw:
                _eq(sg[k], sw[k], f"adam state {k} of leaf {i}")
    g, w = got.pose_opt_state, want.pose_opt_state
    assert (g is None) == (w is None)
    if g is not None:
        assert (g.count, g.mini_step, g.gradient_step) == (w.count, w.mini_step, w.gradient_step)
        for part in ("mu", "nu", "acc_grads"):
            a, b = getattr(g, part), getattr(w, part)
            assert (a is None) == (b is None), part
            for k in b or {}:
                _eq(a[k], b[k], f"pose {part} {k}")


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_files(got, want):
    g, w = _npz(got), _npz(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_npz_loads_into_the_port(name, tmp_path):
    """A JAX-written file restores into a port template as
    train_state_from_numpy builds the same JAX state: params, embeds, the
    Adam moments and count, the pose params, anchors and MultiSteps state."""
    state = _jax_state(name)
    path = jck.save_checkpoint(str(tmp_path), state)
    got = tck.load_checkpoint(path, _template(name))
    want = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                  tt.TrainConfig(**CONFIGS[name][0]), "cpu")
    _assert_same_state(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_npz_loads_into_jax(name, tmp_path):
    """The port's file of a state equals the JAX file of the same state key
    for key and array for array, and JAX's load_checkpoint restores it."""
    state = _jax_state(name)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), state)
    port = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                  tt.TrainConfig(**CONFIGS[name][0]), "cpu")
    tpath = tck.save_checkpoint(str(tmp_path / "port"), port)
    assert os.path.basename(tpath) == os.path.basename(jpath) == "00000002.ckpt.npz"
    _assert_same_files(tpath, jpath)
    tkw, pose = CONFIGS[name]
    template = jt.create_train_state(
        jr.init_raycaster(jax.random.PRNGKey(7), jr.RaycastConfig(**TINY)),
        jt.TrainConfig(**tkw),
        pose_params=_pose_tree(np.random.default_rng(9)) if pose else None,
        pose_anchors=_pose_tree(np.random.default_rng(9)) if pose else None)
    restored = jck.load_checkpoint(tpath, template)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_state_round_trips_after_a_step(tmp_path):
    """A state the port's own Adam advanced comes back bit-equal."""
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_state("adam")),
                                   tt.TrainConfig(), "cpu")
    for p in tt.param_leaves(state.params):
        p.grad = torch.ones_like(p)
    state.opt_state.step()
    path = tck.save_checkpoint(str(tmp_path), state._replace(step=3))
    _assert_same_state(tck.load_checkpoint(path, _template("adam")), state._replace(step=3))
    assert int(_npz(path)["opt_state//0//count"]) == 3


def test_missing_key_names_the_key(tmp_path):
    """A testopt file has no optimizer leaves: an Adam template refuses it,
    naming the first key it lacks, as the JAX package does."""
    path = jck.save_checkpoint(str(tmp_path), _jax_state("testopt"))
    with pytest.raises(KeyError, match="checkpoint missing key 'opt_state//0//count'"):
        tck.load_checkpoint(path, _template("adam"))
    with pytest.raises(KeyError, match="checkpoint missing key 'opt_state//0//"):
        jck.load_checkpoint(path, _jax_state("adam"))


def test_latest_checkpoint(tmp_path):
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_state("testopt")),
                                   tt.TrainConfig(testopt=True), "cpu")
    assert tck.latest_checkpoint(str(tmp_path)) is None
    for step in (12, 3, 100):
        tck.save_checkpoint(str(tmp_path), state, step=step)
    assert tck.latest_checkpoint(str(tmp_path)) == jck.latest_checkpoint(str(tmp_path))
    assert tck.latest_checkpoint(str(tmp_path)).endswith("00000100.ckpt.npz")


# ---------------------------------------------------------------------------
# the reference .tar scheme
# ---------------------------------------------------------------------------

TAR_CFG = dict(TINY, opt_framecode=True, n_framecodes=5, freq_schedule=True)


@functools.lru_cache(maxsize=None)
def _tar_inputs():
    """Render variables with framecodes and a multiview pose layer."""
    variables = jax.tree_util.tree_map(
        np.asarray, jr.init_raycaster(jax.random.PRNGKey(3), jr.RaycastConfig(**TAR_CFG)))
    for name in variables:
        if name.startswith("embed") and "alpha" in variables[name]:
            variables[name]["alpha"] = np.float32(2.5)
    rng = np.random.default_rng(4)
    pose = {"bones": rng.standard_normal((6, 24, 3)).astype(np.float32),
            "pelvis": rng.standard_normal((6, 3)).astype(np.float32),
            "root_bones": rng.standard_normal((2, 3)).astype(np.float32)}
    kw = dict(global_step=77, pose_params=pose, rest_pose=rng.standard_normal((24, 3)),
              kp_map=np.array([0, 0, 1, 1, 2, 2]), kp_uidxs=np.array([0, 2, 4]))
    return variables, kw


def _tree_equal(got, want):
    """A tree of port tensors against one of JAX / numpy arrays."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    elif isinstance(want, (int, float)):
        assert got == want
    else:
        w = np.asarray(want)
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        if np.issubdtype(w.dtype, np.integer):
            # index maps: int64 in the port, int32 in JAX (x64 off)
            assert g.dtype == np.int64
        else:
            assert g.dtype == w.dtype
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _sd_equal(got, want):
    """Two torch.load'ed checkpoints, entry for entry."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _sd_equal(got[k], want[k])
        elif isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        elif isinstance(want[k], list):
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                if isinstance(w, dict):
                    _sd_equal(g, w)
                else:
                    assert g == w, k
        else:
            assert got[k] == want[k], k


def test_jax_tar_imports_into_the_port(tmp_path):
    variables, kw = _tar_inputs()
    path = jck.export_torch_checkpoint(str(tmp_path / "j.tar"), variables,
                                       jr.RaycastConfig(**TAR_CFG), **kw)
    got_vars, got_extras = tck.import_torch_checkpoint(path, device="cpu")
    want_vars, want_extras = jck.import_torch_checkpoint(path)
    _tree_equal(got_vars, want_vars)
    _tree_equal(got_extras, want_extras)
    assert "framecodes" in got_vars["coarse"] and "kp_map" in got_extras


def test_port_tar_matches_jax_export(tmp_path):
    """The port's export of the same variables (as tensors) writes the JAX
    export's entries, and JAX imports it."""
    variables, kw = _tar_inputs()
    cfg = jr.RaycastConfig(**TAR_CFG)
    jpath = jck.export_torch_checkpoint(str(tmp_path / "j.tar"), variables, cfg, **kw)
    tkw = dict(kw, pose_params=params_from_numpy(kw["pose_params"], "cpu"),
               rest_pose=torch.as_tensor(kw["rest_pose"], dtype=torch.float32),
               kp_map=torch.as_tensor(kw["kp_map"]), kp_uidxs=torch.as_tensor(kw["kp_uidxs"]))
    tpath = tck.export_torch_checkpoint(str(tmp_path / "t.tar"),
                                        params_from_numpy(variables, "cpu"),
                                        tr.RaycastConfig(**TAR_CFG), **tkw)
    load = functools.partial(torch.load, map_location="cpu", weights_only=False)
    _sd_equal(load(tpath), load(jpath))
    want = jck.import_torch_checkpoint(jpath)
    got = jck.import_torch_checkpoint(tpath)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_tar_export_refusals(tmp_path):
    variables, kw = _tar_inputs()
    tvars = params_from_numpy(variables, "cpu")
    cfg = tr.RaycastConfig(**TAR_CFG)
    with pytest.raises(ValueError, match="rest_pose"):
        tck.export_torch_checkpoint(str(tmp_path / "a.tar"), tvars, cfg,
                                    pose_params=kw["pose_params"])
    with pytest.raises(ValueError, match="kp_map and kp_uidxs"):
        tck.export_torch_checkpoint(str(tmp_path / "b.tar"), tvars, cfg,
                                    pose_params=kw["pose_params"], rest_pose=kw["rest_pose"])


# ---------------------------------------------------------------------------
# pose files
# ---------------------------------------------------------------------------

def test_pose_files_both_ways(tmp_path):
    """save_pose_checkpoint: the port's file equals JAX's for the same state;
    load_pose_params reads either package's .npz, and the .tar, as JAX does."""
    jstate = _jax_state("pose_multisteps")
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                    tt.TrainConfig(**CONFIGS["pose_multisteps"][0]), "cpu")
    jpath = jck.save_pose_checkpoint(str(tmp_path / "jax"), jstate)
    tpath = tck.save_pose_checkpoint(str(tmp_path / "port"), tstate)
    _assert_same_files(tpath, jpath)
    for path in (jpath, tpath):
        _tree_equal(tck.load_pose_params(path, device="cpu"), jck.load_pose_params(path))
    variables, kw = _tar_inputs()
    tar = jck.export_torch_checkpoint(str(tmp_path / "p.tar"), variables,
                                      jr.RaycastConfig(**TAR_CFG), **kw)
    _tree_equal(tck.load_pose_params(tar, device="cpu"), jck.load_pose_params(tar))
    bare = jck.export_torch_checkpoint(str(tmp_path / "n.tar"), variables,
                                       jr.RaycastConfig(**TAR_CFG))
    with pytest.raises(KeyError, match="no poseopt state"):
        tck.load_pose_params(bare, device="cpu")
    ckpt = tck.save_checkpoint(str(tmp_path / "full"), tstate._replace(pose_params=None))
    with pytest.raises(KeyError, match="no pose_params"):
        tck.load_pose_params(ckpt, device="cpu")
