"""posegen_tpu_torch's body models (`body/lbs.py`, `body/smpl.py`) and pose
metrics (`evals/pose.py`) against posegen_tpu's on the CPU.

The same numpy inputs, drawn from a seed, go through both packages. The
models come from `make_random_model` in each package (the same numpy
draws, held bit-equal here) or from official-layout `.npz` / `.pkl` files
the test writes; `utils/convert.smpl_from_numpy` carries a JAX model over.
Tolerances: float32 on both sides; vertices and joints to 1e-5 absolute,
each pose metric to 1e-5.
"""

import functools
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from posegen_tpu.body import smpl as jsmpl
from posegen_tpu.evals import pose as jpose
from posegen_tpu_torch.body import smpl as tsmpl
from posegen_tpu_torch.evals import pose as tpose
from posegen_tpu_torch.utils.convert import smpl_from_numpy

# the modules (each package's body/__init__ exports a function named lbs)
jlbs = importlib.import_module("posegen_tpu.body.lbs")
tlbs = importlib.import_module("posegen_tpu_torch.body.lbs")

TOL = 1e-5
SHAPES = {"small": (64, 24, 10), "smpl": (6890, 24, 10)}  # (vertices, joints, betas)
B = 3


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _models(kind):
    V, J, L = SHAPES[kind]
    return (jsmpl.make_random_model(V, J, L, seed=4),
            tsmpl.make_random_model(V, J, L, seed=4, device="cpu"))


def _inputs(kind, seed=0):
    V, J, L = SHAPES[kind]
    rng = np.random.default_rng(seed)
    betas = rng.standard_normal((B, L)).astype(np.float32)
    aa = (rng.standard_normal((B, J, 3)) * 0.6).astype(np.float32)
    transl = rng.standard_normal((B, 3)).astype(np.float32)
    extra = rng.uniform(0, 1, (14, V)).astype(np.float32)
    return betas, aa, transl, extra / extra.sum(1, keepdims=True)


def test_make_random_model_draws_jax_s_numbers():
    for kind in SHAPES:
        jm, tm = _models(kind)
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
        np.testing.assert_array_equal(tm.parents, jm.parents)
        assert (tm.n_joints, tm.n_vertices) == (jm.n_joints, jm.n_vertices)
        assert tm.extra_joint_regressor is None and tm.faces is None


@functools.lru_cache(maxsize=None)
def _jax_forward(kind, pose2rot, extra):
    jm, _ = _models(kind)
    betas, aa, transl, ereg = _inputs(kind)
    if extra:
        jm = jsmpl.SMPLModel(**{**jm.__dict__, "extra_joint_regressor": jnp.asarray(ereg)})
    if pose2rot:
        body, glob = aa[:, 1:].reshape(B, -1), aa[:, 0]
    else:
        rots = np.asarray(jax.vmap(jax.vmap(_jax_rot))(jnp.asarray(aa)))
        body, glob = rots[:, 1:], rots[:, :1]
    out = jm(jnp.asarray(betas), jnp.asarray(body), jnp.asarray(glob),
             transl=jnp.asarray(transl) if extra else None, pose2rot=pose2rot)
    return body, glob, {k: np.asarray(v) for k, v in out.items()}


def _jax_rot(a):
    from posegen_tpu.skeleton.rotations import axisang_to_rot

    return axisang_to_rot(a)


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "transl_extra"])
@pytest.mark.parametrize("pose2rot", [True, False])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_smpl_forward(kind, pose2rot, extra):
    """Vertices and joints to 1e-5; with `transl` and the extra joint
    regressor (the joints then the regressor's 14)."""
    body, glob, want = _jax_forward(kind, pose2rot, extra)
    _, tm = _models(kind)
    betas, _, transl, ereg = _inputs(kind)
    if extra:
        tm = tsmpl.SMPLModel(tm.v_template, tm.shapedirs, tm.posedirs, tm.J_regressor,
                             tm.parents, tm.lbs_weights, extra_joint_regressor=ereg)
    with torch.no_grad():
        got = tm(_t(betas), _t(body), _t(glob), transl=_t(transl) if extra else None,
                 pose2rot=pose2rot)
    assert got["joints"].shape == (B, 14 if extra else 24, 3)
    for k in ("vertices", "joints"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=TOL, err_msg=k)


def test_global_orient_defaults():
    """No global_orient: zeros (axis-angle) or the identity (rotations)."""
    jm, tm = _models("small")
    betas, aa, _, _ = _inputs("small", seed=1)
    body = aa[:, 1:].reshape(B, -1)
    want = jm(jnp.asarray(betas), jnp.asarray(body))
    got = tm(_t(betas), _t(body))
    np.testing.assert_allclose(got["vertices"].numpy(), np.asarray(want["vertices"]), atol=TOL)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 23, 3, 3))
    got_r = tm(_t(betas), _t(eye), pose2rot=False)["vertices"]
    got_a = tm(_t(betas), _t(np.zeros((B, 69), np.float32)))["vertices"]
    np.testing.assert_allclose(got_r.numpy(), got_a.numpy(), atol=TOL)


def test_lbs_pieces():
    rng = np.random.default_rng(2)
    V, J, L = 40, 24, 10
    betas = rng.standard_normal((B, L)).astype(np.float32)
    disps = rng.standard_normal((V, 3, L)).astype(np.float32)
    np.testing.assert_allclose(tlbs.blend_shapes(_t(betas), _t(disps)).numpy(),
                               np.asarray(jlbs.blend_shapes(betas, disps)), atol=TOL)
    reg = rng.uniform(0, 1, (J, V)).astype(np.float32)
    verts = rng.standard_normal((B, V, 3)).astype(np.float32)
    np.testing.assert_allclose(tlbs.vertices2joints(_t(reg), _t(verts)).numpy(),
                               np.asarray(jlbs.vertices2joints(reg, verts)), atol=TOL)
    parents = np.array([-1] + [i // 2 for i in range(J - 1)], np.int64)
    assert tlbs._levels_from_parents(np.r_[0, parents[1:]]) == tuple(
        tuple(int(i) for i in lv) for lv in jlbs._levels_from_parents(np.r_[0, parents[1:]]))
    rots = np.asarray(jax.vmap(jax.vmap(_jax_rot))(
        jnp.asarray(rng.standard_normal((B, J, 3)).astype(np.float32))))
    joints = rng.standard_normal((B, J, 3)).astype(np.float32)
    want = jlbs.batch_rigid_transform(jnp.asarray(rots), jnp.asarray(joints), parents)
    got = tlbs.batch_rigid_transform(_t(rots), _t(joints), parents)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def _official(kind, tmp_path, fmt):
    """An official-layout model file (posedirs (V, 3, P), kintree_table,
    weights, faces; in the .pkl a scipy-sparse J_regressor) from the random
    model's arrays."""
    jm, _ = _models(kind)
    V = jm.n_vertices
    data = {
        "v_template": np.asarray(jm.v_template, np.float64),
        "shapedirs": np.asarray(jm.shapedirs, np.float64),
        "posedirs": np.asarray(jm.posedirs).T.reshape(V, 3, -1),
        "J_regressor": np.asarray(jm.J_regressor),
        "kintree_table": np.stack([np.r_[4294967295, jm.parents[1:]], np.arange(24)]),
        "weights": np.asarray(jm.lbs_weights),
        "f": np.arange(30).reshape(10, 3).astype(np.uint32),
    }
    path = tmp_path / f"SMPL_TEST.{fmt}"
    if fmt == "npz":
        np.savez(path, **data)
    else:
        data["J_regressor"] = scipy.sparse.csc_matrix(data["J_regressor"])
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    return str(path)


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
def test_load_smpl_model(tmp_path, fmt):
    path = _official("small", tmp_path, fmt)
    ereg = _inputs("small")[3]
    jm = jsmpl.load_smpl_model(path, n_betas=8, extra_joint_regressor=ereg)
    tm = tsmpl.load_smpl_model(path, n_betas=8, extra_joint_regressor=ereg, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
                 "extra_joint_regressor"):
        a = getattr(tm, name)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jm, name)), err_msg=name)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    betas, aa, _, _ = _inputs("small", seed=3)
    want = jm(jnp.asarray(betas[:, :8]), jnp.asarray(aa[:, 1:].reshape(B, -1)),
              jnp.asarray(aa[:, 0]))
    got = tm(_t(betas[:, :8]), _t(aa[:, 1:].reshape(B, -1)), _t(aa[:, 0]))
    for k in ("vertices", "joints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL)


def test_smpl_from_numpy_and_buffers():
    jm, _ = _models("small")
    ereg = _inputs("small")[3]
    jm = jsmpl.SMPLModel(**{**jm.__dict__, "extra_joint_regressor": jnp.asarray(ereg),
                            "faces": np.arange(6).reshape(2, 3)})
    tm = smpl_from_numpy(jax.tree_util.tree_map(np.asarray, jm), "cpu")
    assert sorted(dict(tm.named_buffers())) == sorted(
        ["v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
         "extra_joint_regressor"])
    for name, buf in tm.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(tm.faces, jm.faces)
    tm64 = tm.to(torch.float64)
    assert tm64.v_template.dtype == torch.float64  # buffers move with the module


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tsmpl.make_random_model(),
               lambda: tsmpl.load_smpl_model(_official("small", tmp_path, "npz")),
               lambda: tpose.evaluate_pose_batch(np.zeros((1, 14, 3)), np.zeros((1, 14, 3)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# ---------------------------------------------------------------------------
# pose metrics
# ---------------------------------------------------------------------------

def _poses():
    """(pred, gt) of 8 poses of 14 joints: noisy, one reflected (the guard
    flips the last singular direction), one coplanar and one collinear-free
    rank-deficient case (a rank-2 cross-covariance), one exact copy."""
    rng = np.random.default_rng(7)
    gt = rng.standard_normal((8, 14, 3)).astype(np.float32)
    pred = (1.3 * gt + 0.15 * rng.standard_normal((8, 14, 3))).astype(np.float32)
    pred[1] = gt[1] * np.array([-1.0, 1.0, 1.0], np.float32)
    pred[2, :, 2] = 0.25
    gt[3, :, 0] = -0.5
    pred[3, :, 0] = 0.75
    pred[4] = gt[4]
    return pred, gt


def test_similarity_transform_and_procrustes():
    pred, gt = _poses()
    want = jax.vmap(jpose.similarity_transform)(jnp.asarray(pred), jnp.asarray(gt))
    got = tpose.similarity_transform(_t(pred), _t(gt))
    for name, g, w in zip(("S1_hat", "scale", "R", "t"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)
    assert float(torch.linalg.det(got[2][1])) > 0  # the reflection is not taken
    single = tpose.similarity_transform(_t(pred[0]), _t(gt[0]))[0]
    np.testing.assert_allclose(single.numpy(), np.asarray(want[0][0]), atol=TOL)
    np.testing.assert_allclose(tpose.procrustes_align(_t(pred), _t(gt)).numpy(),
                               np.asarray(jpose.procrustes_align(pred, gt)), atol=TOL)
    np.testing.assert_allclose(tpose.procrustes_align(_t(pred[:4].reshape(2, 2, 14, 3)),
                                                      _t(gt[:4].reshape(2, 2, 14, 3))).numpy(),
                               np.asarray(jpose.procrustes_align(pred[:4].reshape(2, 2, 14, 3),
                                                                 gt[:4].reshape(2, 2, 14, 3))),
                               atol=TOL)


def test_zero_pose_pair_aligns_as_jax():
    """A degenerate pair (all joints at the origin: K = 0, var = 0, the
    1e-12 clamp): both packages take the guard's d = sign(det(V U^T)) from
    their SVD as it comes and give the same transform."""
    z = np.zeros((1, 14, 3), np.float32)
    want = jax.vmap(jpose.similarity_transform)(jnp.asarray(z), jnp.asarray(z))
    got = tpose.similarity_transform(_t(z), _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_pose_metrics():
    pred, gt = _poses()
    for name in ("mpjpe", "pa_mpjpe"):
        np.testing.assert_allclose(float(getattr(tpose, name)(_t(pred), _t(gt))),
                                   float(getattr(jpose, name)(pred, gt)), rtol=TOL, atol=TOL)
    for align in (False, True):
        np.testing.assert_allclose(
            tpose.per_joint_error(_t(pred), _t(gt), align=align).numpy(),
            np.asarray(jpose.per_joint_error(jnp.asarray(pred), jnp.asarray(gt), align=align)),
            rtol=TOL, atol=TOL)
    errs = np.array([0.1, 0.15, 0.149, 0.2, 0.0, 0.075], np.float32)  # one exactly at 0.15
    for th in (0.15, 0.075):
        assert float(tpose.pck(_t(errs), th)) == float(jpose.pck(jnp.asarray(errs), th))
    e = np.asarray(jpose.per_joint_error(jnp.asarray(pred), jnp.asarray(gt), align=True)) * 0.3
    np.testing.assert_allclose(float(tpose.auc(_t(e))), float(jpose.auc(jnp.asarray(e))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tpose.auc(_t(e), 0.1, 11)),
                               float(jpose.auc(jnp.asarray(e), 0.1, 11)), atol=TOL)


@pytest.mark.parametrize("pelvis", [None, (2, 3)])
def test_evaluate_pose_batch(pelvis):
    pred, gt = _poses()
    pred, gt = pred * 0.3, gt * 0.3  # meters: the PCK thresholds bite
    want = jpose.evaluate_pose_batch(pred, gt, pelvis_idx=pelvis)
    got = tpose.evaluate_pose_batch(pred, gt, pelvis_idx=pelvis, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
