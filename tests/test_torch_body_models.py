"""posegen_tpu_torch's SMPL-X / MANO / FLAME models (`body/models.py`) and
the parameter-transfer fit (`body/transfer.py`) against posegen_tpu's on
the CPU.

Both packages load the same random official-layout model files (`.npz` and
`.pkl`, drawn from a seed as tests/test_body_models.py draws them) and run
the same numpy inputs. Vertices, joints and full_pose are held to 1e-5
relative L2; `utils/convert.body_model_from_numpy` of JAX's model holds the
port's loader's buffers exactly and JAX's results to the same rule.
`run_fitting` on a 48-vertex, 6-joint model (tests/test_transfer.py's)
runs short per-part schedules in both packages, params and losses to 1e-4
relative. Where the edge stage trains every param at once (per_part off),
the translation's gradient is rounding noise (edges do not see it) that
Adam scales to steps of up to lr, so that case holds the edge loss, which
the translation cannot move, to JAX's. The port alone reaches JAX's own
recovery fit's bounds.
"""

import dataclasses
import functools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.body import models as jmodels
from posegen_tpu.body import smpl as jsmpl
from posegen_tpu.body import transfer as jtransfer
from posegen_tpu_torch.body import models as tmodels
from posegen_tpu_torch.body import smpl as tsmpl
from posegen_tpu_torch.body import transfer as ttransfer
from posegen_tpu_torch.utils.convert import body_model_from_numpy, smpl_from_numpy

TOL = 1e-5
FIT_TOL = 1e-4
B = 4


@pytest.fixture
def one_thread():
    """The fits are hundreds of steps on tiny tensors, where torch's thread
    pool costs more than it gives (most under the parallel test run's load):
    one thread for a fit test, the process's count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


# ---------------------------------------------------------------------------
# model files (tests/test_body_models.py's draws)
# ---------------------------------------------------------------------------


def _softmax_rows(rng, V, J):
    w = np.exp(rng.standard_normal((V, J)) * 2)
    return w / w.sum(1, keepdims=True)


def _base_body_data(rng, V, J, F, n_shapecols, parents=None):
    if parents is None:
        parents = np.zeros(J, np.int64)
        for j in range(1, J):
            parents[j] = rng.integers(0, j)
    kintree = np.stack([parents.astype(np.uint32), np.arange(J, dtype=np.uint32)])
    kintree[0, 0] = np.uint32(4294967295)  # official files store -1 as uint32
    J_reg = rng.random((J, V))
    return {
        "v_template": rng.standard_normal((V, 3)) * 0.1,
        "shapedirs": rng.standard_normal((V, 3, n_shapecols)) * 0.01,
        "posedirs": rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
        "J_regressor": J_reg / J_reg.sum(1, keepdims=True),
        "kintree_table": kintree,
        "weights": _softmax_rows(rng, V, J),
        "f": rng.integers(0, V, (F, 3)).astype(np.int64),
    }


@functools.lru_cache(maxsize=None)
def _files(tmp: str) -> dict:
    """Writes the model files of every family into `tmp` -> tmp."""
    rng = np.random.default_rng(0)
    V, J, F = 10475, 55, 800  # the SMPL-X vertex ids reach 9929
    smplx = _base_body_data(rng, V, J, F, n_shapecols=20)  # 10 shape + 10 expression
    smplx.update(
        hands_componentsl=rng.standard_normal((45, 45)) * 0.5,
        hands_componentsr=rng.standard_normal((45, 45)) * 0.5,
        hands_meanl=rng.standard_normal(45) * 0.1,
        hands_meanr=rng.standard_normal(45) * 0.1,
        lmk_faces_idx=rng.integers(0, F, (51,)).astype(np.int64),
        lmk_bary_coords=_softmax_rows(rng, 51, 3),
        dynamic_lmk_faces_idx=rng.integers(0, F, (79, 17)).astype(np.int64),
        dynamic_lmk_bary_coords=np.stack([_softmax_rows(rng, 17, 3) for _ in range(79)]),
    )
    smplx["posedirs"] = smplx["posedirs"].astype(np.float32)  # halves the 10475-vertex file
    np.savez(os.path.join(tmp, "SMPLX_NEUTRAL.npz"), **smplx)
    with open(os.path.join(tmp, "SMPLX_NEUTRAL.pkl"), "wb") as f:
        pickle.dump(smplx, f)

    mano = _base_body_data(rng, 778, 16, 300, n_shapecols=10)
    mano.update(hands_components=rng.standard_normal((45, 45)) * 0.5,
                hands_mean=rng.standard_normal(45) * 0.1)
    with open(os.path.join(tmp, "MANO_RIGHT.pkl"), "wb") as f:
        pickle.dump(mano, f)

    V, F = 600, 200
    flame = _base_body_data(rng, V, 5, F, n_shapecols=400,  # 300 shape + 100 expression
                            parents=np.array([0, 0, 1, 1, 1], np.int64))
    with open(os.path.join(tmp, "FLAME_NEUTRAL.pkl"), "wb") as f:
        pickle.dump(flame, f)
    with open(os.path.join(tmp, "flame_static_embedding.pkl"), "wb") as f:
        pickle.dump({"lmk_face_idx": rng.integers(0, F, (51,)).astype(np.int64),
                     "lmk_b_coords": _softmax_rows(rng, 51, 3)}, f)
    np.save(os.path.join(tmp, "flame_dynamic_embedding.npy"),
            {"lmk_face_idx": rng.integers(0, F, (79, 17)).astype(np.int64),
             "lmk_b_coords": np.stack([_softmax_rows(rng, 17, 3) for _ in range(79)])},
            allow_pickle=True)
    return tmp


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("body_models")))


# (family, file, loader keyword arguments)
CASES = {
    "smplx_pca_contour": ("smplx", "SMPLX_NEUTRAL.npz",
                          dict(use_pca=True, num_pca_comps=6, use_face_contour=True)),
    "smplx_full_flat": ("smplx", "SMPLX_NEUTRAL.pkl",
                        dict(use_pca=False, flat_hand_mean=True, use_face_contour=False)),
    "smplx_pca12_contour_head": ("smplx", "SMPLX_NEUTRAL.npz",
                                 dict(use_pca=True, num_pca_comps=12, use_face_contour=True,
                                      n_expr=10)),
    "mano_pca": ("mano", "MANO_RIGHT.pkl", dict(use_pca=True, num_pca_comps=6)),
    "mano_45": ("mano", "MANO_RIGHT.pkl", dict(num_pca_comps=45)),
    "flame": ("flame", "FLAME_NEUTRAL.pkl", dict(n_betas=10, n_expr=10)),
}
LOADERS = {"smplx": "load_smplx_model", "mano": "load_mano_model", "flame": "load_flame_model"}


def _kwargs(case: str, d: str) -> dict:
    family, _, kw = CASES[case]
    if family == "flame":
        kw = dict(kw, landmark_path=os.path.join(d, "flame_static_embedding.pkl"),
                  contour_path=os.path.join(d, "flame_dynamic_embedding.npy"))
    return kw


def _inputs(case: str, model) -> dict:
    """Forward arguments of `case` as numpy, drawn from a seed."""
    family = CASES[case][0]
    rng = np.random.default_rng(7)
    n = lambda *s, scale=0.3: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    if family == "mano":
        hand = model.hand_components.shape[0] if model.use_pca else 45
        return dict(betas=n(B, 10, scale=0.5), hand_pose=n(B, hand), global_orient=n(B, 3),
                    transl=n(B, 3, scale=1.0))
    if family == "flame":
        return dict(betas=n(B, 10, scale=0.5), global_orient=n(B, 3, scale=0.4),
                    neck_pose=n(B, 3, scale=0.2), jaw_pose=n(B, 3, scale=0.1),
                    leye_pose=n(B, 3, scale=0.1), reye_pose=n(B, 3, scale=0.1),
                    expression=n(B, 10, scale=0.5))
    hand = model.left_hand_components.shape[0] if model.use_pca else 45
    go = n(B, 3, scale=0.5)
    body = n(B, 63)
    if case.endswith("_head"):
        # head y rotations of -69, -17, +17 and +69 degrees: the contour's
        # bins past -39 (78) and its clip at +39
        go = np.zeros((B, 3), np.float32)
        go[:, 1] = [-1.2, -0.3, 0.3, 1.2]
        body = n(B, 63, scale=0.05)
    return dict(betas=n(B, 10, scale=0.5), body_pose=body, global_orient=go,
                left_hand_pose=n(B, hand), right_hand_pose=n(B, hand), jaw_pose=n(B, 3, scale=0.1),
                leye_pose=n(B, 3, scale=0.1), reye_pose=n(B, 3, scale=0.1),
                expression=n(B, 10, scale=0.5), transl=n(B, 3, scale=1.0))


@functools.lru_cache(maxsize=None)
def _jax_run(case: str, d: str):
    family, fname, _ = CASES[case]
    jm = getattr(jmodels, LOADERS[family])(os.path.join(d, fname), **_kwargs(case, d))
    args = _inputs(case, jm)
    out = jm(**{k: jnp.asarray(v) for k, v in args.items()})
    return jm, args, {k: np.asarray(v) for k, v in out.items()}


def _port_out(model, args) -> dict:
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in args.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(model_dir, case):
    family, fname, _ = CASES[case]
    jm, args, ref = _jax_run(case, model_dir)
    tm = getattr(tmodels, LOADERS[family])(os.path.join(model_dir, fname), device="cpu",
                                          **_kwargs(case, model_dir))
    got = _port_out(tm, args)
    assert sorted(got) == sorted(ref) == ["full_pose", "joints", "vertices"]
    for k in ref:
        assert got[k].shape == ref[k].shape, (k, got[k].shape, ref[k].shape)
        assert rel_l2(got[k], ref[k]) <= TOL, (k, rel_l2(got[k], ref[k]))
    if family == "smplx":
        n_joints = 127 + (17 if tm.use_face_contour else 0)
        assert got["joints"].shape == (B, n_joints, 3)
    # the same model carried over from JAX's fields: its buffers equal the
    # loader's, its outputs JAX's by the same rule (the loader's and the
    # carried copy's products may round apart: MKL picks its kernels by the
    # buffers' alignment)
    fields = {f.name: (None if getattr(jm, f.name) is None else np.asarray(getattr(jm, f.name)))
              for f in dataclasses.fields(jm)}
    carried_model = body_model_from_numpy(family, fields, device="cpu")
    for name, buf in tm.named_buffers():
        torch.testing.assert_close(dict(carried_model.named_buffers())[name], buf, rtol=0, atol=0)
    carried = _port_out(carried_model, args)
    for k in ref:
        assert rel_l2(carried[k], ref[k]) <= TOL, (k, rel_l2(carried[k], ref[k]))


def test_contour_bins_cross_39_degrees(model_dir):
    """The head rotations of the _head case land in the table's clipped bins
    (39) and past -39 (78), in both packages alike."""
    jm, args, _ = _jax_run("smplx_pca12_contour_head", model_dir)
    tm = body_model_from_numpy("smplx", {f.name: getattr(jm, f.name)
                                         for f in dataclasses.fields(jm)}, device="cpu")
    full = tm(**{k: torch.as_tensor(v) for k, v in args.items()})["full_pose"]
    chain = tm.neck_kin_chain
    # the bin of each batch row: the row of the table its faces come from
    table = np.asarray(jm.dynamic_lmk_faces_idx)
    j_idx, _ = jmodels.find_dynamic_lmk_idx_and_bcoords(
        jnp.asarray(full.detach().numpy()), jm.dynamic_lmk_faces_idx,
        jm.dynamic_lmk_bary_coords, chain)
    t_idx, _ = tmodels.find_dynamic_lmk_idx_and_bcoords(
        full, tm.dynamic_lmk_faces_idx, tm.dynamic_lmk_bary_coords, chain)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    bins = [int(np.flatnonzero((table == row).all(1))[0]) for row in t_idx.numpy()]
    assert 78 in bins and 39 in bins, bins


def test_tables_and_helpers():
    assert tmodels.SMPLX_JOINT_NAMES == jmodels.SMPLX_JOINT_NAMES
    assert tmodels.VERTEX_IDS == jmodels.VERTEX_IDS
    assert (tmodels.SMPLX_N_JOINTS, tmodels.MANO_N_JOINTS, tmodels.FLAME_N_JOINTS) == (55, 16, 5)
    for vids in tmodels.VERTEX_IDS.values():
        if "LBigToe" in vids:
            np.testing.assert_array_equal(tmodels.extra_joints_idxs(vids),
                                          jmodels.extra_joints_idxs(vids))
    parents = np.array([0, 0, 1, 2, 1, 4], np.int64)
    np.testing.assert_array_equal(tmodels.find_joint_kin_chain(5, parents),
                                  jmodels.find_joint_kin_chain(5, parents))
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((2, 30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (20, 3))
    idx = rng.integers(0, 20, (2, 7))
    bary = rng.uniform(0, 1, (7, 3)).astype(np.float32)
    got = tmodels.vertices2landmarks(torch.as_tensor(verts), torch.as_tensor(faces),
                                     torch.as_tensor(idx), torch.as_tensor(bary))
    ref = jmodels.vertices2landmarks(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(idx),
                                     jnp.asarray(bary))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# run_fitting and the transfer CLI
# ---------------------------------------------------------------------------


def _with_faces(model, seed=0):
    """tests/test_transfer.py's random faces on a JAX model."""
    rng = np.random.default_rng(seed)
    V = model.n_vertices
    faces = rng.choice(V, (3 * V, 3))
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return dataclasses.replace(model, faces=faces[ok].astype(np.int64))


@functools.lru_cache(maxsize=None)
def _fit_problem():
    jm = _with_faces(jsmpl.make_random_model(n_vertices=48, n_joints=6, n_betas=4))
    rng = np.random.default_rng(0)
    gt = dict(betas=rng.standard_normal((2, 4)).astype(np.float32) * 0.5,
              global_orient=(rng.standard_normal((2, 3)) * 0.2).astype(np.float32),
              body_pose=(rng.standard_normal((2, 15)) * 0.2).astype(np.float32),
              transl=rng.standard_normal((2, 3)).astype(np.float32) * 0.3)
    target = np.asarray(jm(**{k: jnp.asarray(v) for k, v in gt.items()})["vertices"])
    return jm, target


def _port_model(jm):
    return smpl_from_numpy(jm, "cpu")


SHORT = dict(part_steps=3, transl_steps=2, vertex_steps=5)
FITS = {
    "plain": dict(),
    "mask_ids": dict(mask_ids=np.arange(40)),
    "def_matrix": dict(def_matrix=True),
}


@functools.lru_cache(maxsize=None)
def _jax_fit(case: str):
    jm, target = _fit_problem()
    kw = dict(FITS[case])
    if kw.get("def_matrix") is not None:
        # targets on a 30-vertex source topology, mapped to the model's 48
        rng = np.random.default_rng(1)
        D = rng.uniform(0, 1, (48, 30)).astype(np.float32)
        D /= D.sum(-1, keepdims=True)
        src = np.linalg.lstsq(D, target.transpose(1, 0, 2).reshape(48, -1), rcond=None)[0]
        target = src.reshape(30, 2, 3).transpose(1, 0, 2).astype(np.float32)
        kw["def_matrix"] = D
    params, losses = jtransfer.run_fitting(jm, target, cfg=jtransfer.FitConfig(**SHORT), **kw)
    return target, kw, {k: np.asarray(v) for k, v in params.items()}, losses


@pytest.mark.parametrize("case", list(FITS))
def test_run_fitting_matches_jax(case, one_thread):
    jm, _ = _fit_problem()
    target, kw, ref, ref_losses = _jax_fit(case)
    got, losses = ttransfer.run_fitting(_port_model(jm), target,
                                        cfg=ttransfer.FitConfig(**SHORT), device="cpu", **kw)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        assert rel_l2(got[k], ref[k]) <= FIT_TOL, (k, rel_l2(got[k], ref[k]))
    for k in ("edge_loss", "vertex_loss"):
        assert abs(losses[k] - ref_losses[k]) <= FIT_TOL * abs(ref_losses[k]), (k, losses, ref_losses)


def test_joint_edge_stage_edge_loss_matches_jax(one_thread):
    jm, target = _fit_problem()
    cfg = dict(per_part=False, edge_steps=4, transl_steps=2, vertex_steps=2)
    _, ref = jtransfer.run_fitting(jm, target, cfg=jtransfer.FitConfig(**cfg))
    _, got = ttransfer.run_fitting(_port_model(jm), target, cfg=ttransfer.FitConfig(**cfg),
                                   device="cpu")
    assert abs(got["edge_loss"] - ref["edge_loss"]) <= FIT_TOL * ref["edge_loss"], (got, ref)


def _v2v(model, params, target) -> float:
    with torch.no_grad():
        v = model(**{k: torch.as_tensor(v) for k, v in params.items()})["vertices"].numpy()
    return float(np.linalg.norm(v - target, axis=-1).mean())


def test_port_fit_reaches_jax_tests_bounds(one_thread):
    """tests/test_transfer.py's recovery fit (marked slow there), the port
    alone, on that test's schedule: vertex loss < 1e-3 and v2v < 0.05."""
    jm, target = _fit_problem()
    model = _port_model(jm)
    params, losses = ttransfer.run_fitting(
        model, target, cfg=ttransfer.FitConfig(edge_steps=250, vertex_steps=400, lr=0.03),
        device="cpu")
    assert losses["vertex_loss"] < 1e-3, losses
    assert _v2v(model, params, target) < 0.05


def test_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    D = rng.uniform(0, 1, (16, 10)).astype(np.float32)
    src = rng.standard_normal((2, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttransfer.apply_deformation_transfer(D, src),
                                  jtransfer.apply_deformation_transfer(D, src))
    faces = rng.integers(0, 20, (30, 3))
    np.testing.assert_array_equal(ttransfer._edges_from_faces(faces),
                                  jtransfer._edges_from_faces(faces))
    jm, _ = _fit_problem()
    got = ttransfer.init_variables(3, _port_model(jm), 4)
    ref = jtransfer.init_variables(3, jm, 4)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    import scipy.sparse

    for name, obj in (("d.npy", None), ("d.npz", None), ("d.pkl", scipy.sparse.csr_matrix(D)),
                      ("m.pkl", {"mtx": scipy.sparse.csr_matrix(D)})):
        path = str(tmp_path / name)
        if name.endswith(".npy"):
            np.save(path, D)
        elif name.endswith(".npz"):
            np.savez(path, D)
        else:
            with open(path, "wb") as f:
                pickle.dump(obj, f)
        np.testing.assert_array_equal(ttransfer._load_def_matrix(path),
                                      jtransfer._load_def_matrix(path))


def test_transfer_cli_matches_jax(tmp_path, one_thread):
    """Both packages' `transfer.main` on one directory of .obj, .ply and .npy
    meshes: the same npz keys in the same order, values to 1e-4."""
    rng = np.random.default_rng(5)
    jm = jsmpl.make_random_model(n_vertices=48, n_joints=6, n_betas=4, seed=2)
    mdl = {
        "v_template": np.asarray(jm.v_template, np.float64),
        "shapedirs": np.asarray(jm.shapedirs, np.float64),
        "posedirs": np.asarray(jm.posedirs, np.float64).T.reshape(48, 3, -1),
        "J_regressor": np.asarray(jm.J_regressor, np.float64),
        "kintree_table": np.stack([jm.parents, np.arange(6)]),
        "weights": np.asarray(jm.lbs_weights, np.float64),
        "f": rng.integers(0, 48, (40, 3)).astype(np.int64),
    }
    with open(tmp_path / "model.pkl", "wb") as f:
        pickle.dump(mdl, f)
    out = jm(jnp.asarray((rng.standard_normal((3, 4)) * 0.5).astype(np.float32)),
             body_pose=jnp.asarray((rng.standard_normal((3, 15)) * 0.2).astype(np.float32)),
             global_orient=jnp.asarray((rng.standard_normal((3, 3)) * 0.2).astype(np.float32)))
    verts = np.asarray(out["vertices"])
    meshes = tmp_path / "meshes"
    meshes.mkdir()
    with open(meshes / "m0.obj", "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts[0])
    with open(meshes / "m1.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(verts[1])}\n"
                "property float x\nproperty float y\nproperty float z\nend_header\n")
        f.writelines(f"{x} {y} {z}\n" for x, y, z in verts[1])
    np.save(meshes / "m2.npy", verts[2])
    argv = ["--target-model", str(tmp_path / "model.pkl"), "--mesh-dir", str(meshes),
            "--vertex-steps", "20"]
    jtransfer.main(argv + ["--out", str(tmp_path / "jax.npz")])
    ttransfer.main(argv + ["--out", str(tmp_path / "port.npz")], device="cpu")
    ref, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == ref.files == ["betas", "body_pose", "global_orient", "transl",
                                      "mesh_paths"]
    np.testing.assert_array_equal(got["mesh_paths"], ref["mesh_paths"])
    for k in ref.files[:-1]:
        assert rel_l2(got[k], ref[k]) <= FIT_TOL, (k, rel_l2(got[k], ref[k]))


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card every new body entry point raises; none falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    path = str(tmp_path / "none.npz")
    for fn in (lambda: tmodels.load_smplx_model(path), lambda: tmodels.load_mano_model(path),
               lambda: tmodels.load_flame_model(path),
               lambda: ttransfer.run_fitting(tsmpl.make_random_model(device="cpu"),
                                             np.zeros((1, 64, 3), np.float32)),
               lambda: ttransfer.main(["--target-model", path, "--mesh-dir", str(tmp_path)]),
               lambda: body_model_from_numpy("mano", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
