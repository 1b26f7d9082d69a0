"""posegen_tpu_torch's SPIN evaluation harness (`evals/harness.py`), the SKI
fine-tune driver (`gen/spin_driver.train_ski`) and the MPII dataset on JPEGs
against posegen_tpu's on the CPU.

One small set per benchmark schema, written once per module in the layout
tests/test_harness.py writes (3DPW annotation npz + JPEGs, SKI's labels.h5
by h5py + a PNG tree, 3DHP's dataset-extras npz + JPEGs, AGORA's detection
pickle + PNGs), at res 64. The HMR is the port's seed-0 init carried to
JAX (`test_torch_gen.hmr_weights`), the SMPL models the JAX package's
`make_random_model` carried over by `smpl_from_numpy` (gendered: three
seeds). JAX's evaluator runs its jitted steps, one compile per entry point
(every batch has the same shape). Tolerances: the metrics and the AGORA
arrays to 1e-4 relative; the dataset items to 1e-5 (`crop`'s float64
resize is cv2's to within an ulp) or bit for bit (SKI's INTER_AREA, the
decoded images); train_ski's batches bit for bit.
"""

import contextlib
import functools
import io
import os
import pickle

import h5py
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from posegen_tpu.body.smpl import make_random_model
from posegen_tpu.evals import harness as jh
from posegen_tpu.gen import datasets as jds
from posegen_tpu.gen import spin_driver as jsd
from posegen_tpu.train.checkpoints import _unflatten_into
from posegen_tpu_torch.evals import harness as th
from posegen_tpu_torch.gen import datasets as pds
from posegen_tpu_torch.gen import spin_driver as psd
from posegen_tpu_torch.gen.hmr import init_hmr
from posegen_tpu_torch.utils.convert import hmr_from_numpy, smpl_from_numpy
from test_torch_gen import hmr_weights

RES = 64
BATCH = 2
RTOL = 1e-4
ITEM_TOL = 1e-5
N_VERTS = 64


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _img(rng, h, w):
    y, x = np.mgrid[:h, :w]
    base = np.stack([y * 255 // h, x * 255 // w, (2 * x + 3 * y) % 256], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The four schemas' files, once per module."""
    root = tmp_path_factory.mktemp("eval_sets")
    rng = np.random.default_rng(0)
    out = {}

    # 3DPW: one sequence npz (a PW3D_TEST_SEQS name), JPEG frames, mixed genders
    pw = root / "3dpw"
    (pw / "imageFiles").mkdir(parents=True)
    names = []
    for i in range(4):
        name = f"frame_{i:03d}.jpg"
        imageio.imwrite(pw / "imageFiles" / name, _img(rng, 90, 120), quality=90)
        names.append(name)
    np.savez(pw / "downtown_walking_00.npz", imgname=np.array(names),
             center=rng.uniform(40, 80, (4, 2)).astype(np.float32),
             scale=rng.uniform(0.3, 0.5, 4).astype(np.float32),
             pose=(rng.standard_normal((4, 72)) * 0.2).astype(np.float32),
             shape=(rng.standard_normal((4, 10)) * 0.5).astype(np.float32),
             gender=np.array(["m", "f", "f", "m"]))
    out["3dpw"] = (str(pw), str(pw / "imageFiles"))

    # SKI: labels.h5 (seq / cam / frame / 2D / 3D) + seq_*/cam_*/image_*.png,
    # test and train splits (80^2 images: a fractional INTER_AREA at res 64)
    for split, n in (("test", 4), ("train2/train", 6)):
        base = root / "ski" / split
        seqs, cams, frames = [1, 1, 2, 3, 3, 4][:n], [0, 3, 1, 2, 0, 5][:n], [5, 6, 2, 9, 1, 4][:n]
        for s, c, fr in zip(seqs, cams, frames):
            d = base / f"seq_{s:03d}" / f"cam_{c:02d}"
            d.mkdir(parents=True, exist_ok=True)
            imageio.imwrite(d / f"image_{fr:06d}.png", _img(rng, 80, 80))
        with h5py.File(base / "labels.h5", "w") as f:
            f["seq"] = np.asarray(seqs)
            f["cam"] = np.asarray(cams)
            f["frame"] = np.asarray(frames)
            f["3D"] = (rng.standard_normal((n, 17 * 3)) * 0.3).astype(np.float32)
            f["2D"] = rng.uniform(0, 1, (n, 17 * 2)).astype(np.float32)
    out["ski"] = str(root / "ski")

    # 3DHP: SPIN's dataset-extras npz (imgname / center / scale / S) + JPEGs
    hp = root / "3dhp"
    hp.mkdir()
    names = []
    for i in range(4):
        name = f"S1_Seq1_{i}.jpg"
        imageio.imwrite(hp / name, _img(rng, 70, 60))
        names.append(name)
    np.savez(hp / "mpi_inf_3dhp_valid.npz", imgname=np.array(names),
             center=np.full((4, 2), 32.0, np.float32), scale=np.full(4, 0.3, np.float32),
             S=(rng.standard_normal((4, 24, 4)) * 0.3).astype(np.float32))
    out["3dhp"] = (str(hp / "mpi_inf_3dhp_valid.npz"), str(hp))

    # AGORA: PNGs + HRNet detections (two people in one image)
    ag = root / "agora"
    ag.mkdir()
    entries = []
    for i, name in enumerate(["ag_0.png", "ag_1.png", "ag_0.png"]):
        if i < 2:
            imageio.imwrite(ag / name, _img(rng, 64, 96))
        entries.append({"image_name": name,
                        "2dpose": rng.uniform(10, 60, (1, 17, 2)).astype(np.float32)})
    with open(root / "dets.pkl", "wb") as f:
        pickle.dump(entries, f)
    out["agora"] = (str(ag), str(root / "dets.pkl"))
    return out


@functools.lru_cache(maxsize=None)
def _smpl_models():
    """(neutral, male, female) JAX models and the (17, V) H36M regressor."""
    models = tuple(make_random_model(N_VERTS, 24, 10, seed=s) for s in (0, 1, 2))
    rng = np.random.default_rng(1)
    j_reg = rng.uniform(0, 1, (17, N_VERTS)).astype(np.float32)
    return models, j_reg / j_reg.sum(-1, keepdims=True)


def _evaluators():
    (neutral, male, female), j_reg = _smpl_models()
    p, s = hmr_weights()
    jev = jh.SpinEvaluator(p, s, neutral, male, female, J_regressor=j_reg)
    tp, ts = hmr_from_numpy(p, s, "cpu")
    to_np = lambda m: jax.tree_util.tree_map(np.asarray, m)  # noqa: E731
    tev = th.SpinEvaluator(tp, ts, smpl_from_numpy(to_np(neutral), "cpu"),
                           smpl_from_numpy(to_np(male), "cpu"),
                           smpl_from_numpy(to_np(female), "cpu"), J_regressor=j_reg)
    return jev, tev


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(*args, **kwargs)
    return res, out.getvalue()


def _datasets(sets, name):
    if name == "3dpw":
        return (jh.pw3d_dataset(*sets["3dpw"], res=RES), th.pw3d_dataset(*sets["3dpw"], res=RES))
    if name == "ski":
        return (jh.SkiDataset(sets["ski"], "test", res=RES), th.SkiDataset(sets["ski"], "test",
                                                                           res=RES))
    if name == "3dhp":
        return jh.Hp3dDataset(*sets["3dhp"], res=RES), th.Hp3dDataset(*sets["3dhp"], res=RES)
    return jh.AgoraDataset(*sets["agora"], res=RES), th.AgoraDataset(*sets["agora"], res=RES)


@pytest.mark.parametrize("name", ["3dpw", "ski", "3dhp", "agora"])
def test_dataset_items_match_jax(sets, name):
    jds_, tds = _datasets(sets, name)
    assert len(tds) == len(jds_)
    for i in range(len(tds)):
        a, b = tds[i], jds_[i]
        assert sorted(a) == sorted(b)
        for k in b:
            if k == "image_name":
                assert a[k] == b[k]
                continue
            assert a[k].shape == np.shape(b[k]) and a[k].dtype == np.asarray(b[k]).dtype, k
            if k == "image" and name != "ski":  # crop's float64 resize, cv2's within an ulp
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ITEM_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if name != "agora":
        for a, b in zip(tds.batches(3), jds_.batches(3)):
            assert sorted(a) == sorted(b) and all(a[k].shape == b[k].shape for k in b)


def test_pw3d_dataset_dispatch(sets, tmp_path):
    """Sequence files by PW3D_TEST_SEQS; else every loose npz, sorted."""
    annot, img_dir = sets["3dpw"]
    assert th.pw3d_dataset(annot, img_dir).annot_files == jh.pw3d_dataset(annot, img_dir).annot_files
    for n in ("b.npz", "a.npz"):
        src = np.load(os.path.join(annot, "downtown_walking_00.npz"))
        np.savez(tmp_path / n, **src)
    a, b = th.pw3d_dataset(str(tmp_path), img_dir), jh.pw3d_dataset(str(tmp_path), img_dir)
    assert a.annot_files == b.annot_files and len(a) == 8
    np.testing.assert_array_equal(a.genders, b.genders)


def _jax_results(sets, kind):
    """JAX's evaluator on one set (its printed lines too)."""
    jev, _ = _evaluators()
    jds_, _ = _datasets(sets, kind)
    if kind == "3dpw":
        return _quiet(jev.inference, jds_.batches(BATCH))
    select = jh.SKI_PRED_J14 if kind == "ski" else jh.H36M_TO_J17
    return _quiet(jev.inference_joints, jds_.batches(BATCH), pred_select=select)


@pytest.mark.parametrize("kind", ["3dpw", "ski", "3dhp"])
def test_evaluator_matches_jax(sets, kind):
    """`inference` (3DPW schema: gendered GT meshes, posed and unposed) and
    `inference_joints` (SKI and 3DHP maps): every metric to 1e-4 relative,
    the same "== Final Results ==" keys."""
    want, want_out = _jax_results(sets, kind)
    _, tev = _evaluators()
    _, tds = _datasets(sets, kind)
    if kind == "3dpw":
        got, got_out = _quiet(tev.inference, tds.batches(BATCH))
    else:
        select = th.SKI_PRED_J14 if kind == "ski" else th.H36M_TO_J17
        got, got_out = _quiet(tev.inference_joints, tds.batches(BATCH), pred_select=select)
    assert list(got) == list(want)
    for k in want:
        assert np.isfinite(got[k]), k
        assert _rel(got[k], want[k]) <= RTOL, (k, got[k], want[k])
    assert got_out.splitlines()[0] == want_out.splitlines()[0] == "== Final Results =="
    assert [l.split(":")[0] for l in got_out.splitlines()] == \
        [l.split(":")[0] for l in want_out.splitlines()]


def test_joint_maps_and_constants():
    for name in ("SKI_TO_J14", "SKI_PRED_J14", "J24_TO_J17", "H36M_TO_J17"):
        assert getattr(th, name) == getattr(jh, name)
    from posegen_tpu.utils import constants as jc
    from posegen_tpu_torch.utils import constants as tc

    for name in ("IMG_NORM_MEAN", "IMG_NORM_STD", "IMG_RES", "FOCAL_LENGTH", "H36M_TO_J17",
                 "H36M_TO_J14", "JOINT_NAMES_49", "SPIN_ALIGN_JOINT", "PW3D_TEST_SEQS"):
        assert getattr(tc, name) == getattr(jc, name), name


def test_export_agora_matches_jax(sets, tmp_path):
    """One pickle per detected person, the same names (a second person in an
    image takes personId_1), every array to 1e-4 relative."""
    jev, tev = _evaluators()
    jds_, tds = _datasets(sets, "agora")
    assert jev.export_agora_predictions(jds_, str(tmp_path / "jax")) == 3
    assert tev.export_agora_predictions(tds, str(tmp_path / "port")) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "ag_0_personId_0.pkl", "ag_0_personId_1.pkl", "ag_1_personId_0.pkl"]
    for n in names:
        with open(tmp_path / "jax" / n, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / n, "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == sorted(want) == ["allSmplJoints3d", "joints", "verts"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RTOL * scale, err_msg=k)


def test_joint_metrics_need_the_regressor(sets):
    (neutral, _, _), _ = _smpl_models()
    tp, ts = hmr_from_numpy(*hmr_weights(), "cpu")
    tev = th.SpinEvaluator(tp, ts, smpl_from_numpy(jax.tree_util.tree_map(np.asarray, neutral),
                                                   "cpu"))
    assert tev.smpl_male is tev.smpl_neutral and tev.device == torch.device("cpu")
    _, tds = _datasets(sets, "ski")
    for fn in (lambda: tev.inference([]), lambda: tev.inference_joints(tds.batches(2), [0])):
        with pytest.raises(ValueError, match="needs J_regressor"):
            fn()


# -- train_ski -------------------------------------------------------------------

def _recording_ski_step(seen: list):
    """For JAX's make_ski_finetune_step: a step that records what JAX's
    driver feeds it, (images, joints), and runs no HMR."""
    def make(smpl, J_regressor, lr=5e-5, **_):
        class Opt:
            def init(self, params):
                return None

        def step(params, state, opt_state, images, gt, key):
            seen.append((np.asarray(images), np.asarray(gt)))
            return params, opt_state, {"spin_loss": 0.0}

        return Opt(), step

    return make


def test_train_ski_batches_and_checkpoints_match_jax(sets, tmp_path, monkeypatch):
    """The batches each driver feeds its step (recorded as
    test_train_spin_batches_and_checkpoints_match_jax records them: JAX's
    step replaced, the port's real step run), bit-equal; the port's
    spin_ski_*.npz hold JAX's keys, shapes and dtypes, and JAX's loader
    takes them; the per-epoch evaluator hook."""
    (neutral, _, _), j_reg = _smpl_models()
    kw = dict(epochs=2, batch_size=3, res=32, seed=1)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jsd, "make_ski_finetune_step", _recording_ski_step(seen["jax"]))
    jp, js = hmr_weights()
    _quiet(jsd.train_ski, jp, js, sets["ski"], neutral, j_reg, ckpt_dir=str(tmp_path / "jax"), **kw)

    real = psd.make_ski_finetune_step

    def port_steps(smpl, J_regressor, **k):  # the port's real step, its inputs recorded
        opt, step = real(smpl, J_regressor, **k)

        def rec(params, state, opt_state, images, gt, masks):
            seen["port"].append((images.permute(0, 2, 3, 1).numpy(), gt.numpy()))
            return step(params, state, opt_state, images, gt, masks)

        return opt, rec

    monkeypatch.setattr(psd, "make_ski_finetune_step", port_steps)
    pp, ps = init_hmr(torch.Generator().manual_seed(0), device="cpu")
    before = pp["fc1"]["w"].detach().clone()
    calls = []
    (params, hist), _ = _quiet(psd.train_ski, pp, ps, sets["ski"],
                          smpl_from_numpy(jax.tree_util.tree_map(np.asarray, neutral), "cpu"),
                          j_reg, ckpt_dir=str(tmp_path / "port"),
                          evaluator=lambda p, s: calls.append(1) or {"probe": len(calls)}, **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 2 * 2  # 6 samples: 2 steps an epoch
    for (ip, gp), (ij, gj) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(gp, gj)
    assert [h["eval"] for h in hist] == [{"probe": 1}, {"probe": 2}]
    assert all(np.isfinite(h["ski_loss"]) and h["ski_loss"] > 0 for h in hist)
    assert not torch.equal(params["fc1"]["w"].detach(), before)  # the steps moved the weights
    for epoch in range(2):
        name = f"spin_ski_{epoch:03d}.npz"
        fp, fj = dict(np.load(tmp_path / "port" / name)), dict(np.load(tmp_path / "jax" / name))
        assert sorted(fp) == sorted(fj)
        assert all(fp[k].shape == fj[k].shape and fp[k].dtype == fj[k].dtype for k in fj)
        tree = _unflatten_into({"params": jp, "state": js}, fp)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
            {"params": jp, "state": js})


def test_train_ski_without_samples_raises(tmp_path):
    (tmp_path / "ski" / "train2" / "train").mkdir(parents=True)
    with h5py.File(tmp_path / "ski" / "train2" / "train" / "labels.h5", "w") as f:
        for k in ("seq", "cam", "frame"):
            f[k] = np.zeros(0, np.int64)
        f["3D"] = np.zeros((0, 51), np.float32)
        f["2D"] = np.zeros((0, 34), np.float32)
    pp, ps = init_hmr(torch.Generator().manual_seed(0), device="cpu")
    (neutral, _, _), j_reg = _smpl_models()
    with pytest.raises(FileNotFoundError, match="no SKI samples"):
        psd.train_ski(pp, ps, str(tmp_path / "ski"),
                      smpl_from_numpy(jax.tree_util.tree_map(np.asarray, neutral), "cpu"), j_reg)


# -- MPII on JPEGs -------------------------------------------------------------

def test_mpii_reads_jpegs_as_jax_does(tmp_path):
    """MPII's JPEG crops through the port's decoder: the items equal JAX's
    MPIIPoseDataset's (imageio + cv2), images bit for bit, joints to 1e-5."""
    rng = np.random.default_rng(3)
    names = []
    for i in range(3):
        names.append(f"mpii_{i}.jpg")
        imageio.imwrite(tmp_path / names[-1], _img(rng, 75 + 10 * i, 100), quality=85)
    np.savez(tmp_path / "mpii.npz", pose=(rng.standard_normal((3, 72)) * 0.3).astype(np.float32),
             imgname=np.array(names), center=rng.uniform(30, 60, (3, 2)).astype(np.float32),
             scale=rng.uniform(0.2, 0.4, 3).astype(np.float32))
    args = (str(tmp_path / "mpii.npz"), str(tmp_path))
    a, b = pds.MPIIPoseDataset(*args, res=RES), jds.MPIIPoseDataset(*args, res=RES)
    for i in range(3):
        np.testing.assert_array_equal(a[i]["image"], b[i]["image"])
        np.testing.assert_allclose(a[i]["pose"], b[i]["pose"], rtol=0, atol=ITEM_TOL)
