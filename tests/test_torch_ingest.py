"""posegen_tpu_torch's data front (`data/spin.py`, `data/loaders.py`,
`data/ingest.py`, `data/imutils.undistort_u8`, `data/bench_loader.py`)
against posegen_tpu's on the CPU.

Each raw tree is written inside the test, in the real layouts of
tests/test_ingest.py (a few frames of 32-40^2, numpy draws from a seed;
PNG and JPEG files by cv2, the SPIN and DeepLab-mask h5 files by h5py).
Both packages' `ingest.main` write an H5 file from the same tree, and the
two files are compared key for key through the port's `data/hdf5.read_h5`:
uint8 and integer arrays equal, float arrays to ||port - jax|| <= 1e-5
||jax|| + 1e-6 (REL, ABS). The spin / loaders functions are compared one by
one to the same rule. `undistort_u8` is held bit-equal to cv2.undistort,
and `_imread` equal to the JAX package's cv2 reading.
"""

import functools
import json
import os
import pickle

import cv2
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.body import smpl as jsmpl
from posegen_tpu.data import ingest as jing
from posegen_tpu.data import loaders as jload
from posegen_tpu.data import spin as jspin
from posegen_tpu.skeleton.rotations import axisang_to_rot as j_axisang_to_rot
from posegen_tpu_torch.body import smpl as tsmpl
from posegen_tpu_torch.data import bench_loader as tbench
from posegen_tpu_torch.data import ingest as ting
from posegen_tpu_torch.data import loaders as tload
from posegen_tpu_torch.data import spin as tspin
from posegen_tpu_torch.data.hdf5 import read_h5
from posegen_tpu_torch.data.imutils import undistort_u8

REL, ABS = 1e-5, 1e-6
HW = 32
N = 4


def _close(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        err = float(np.linalg.norm((got - ref).astype(np.float64)))
        bound = REL * float(np.linalg.norm(ref.astype(np.float64))) + ABS
        assert err <= bound, f"{name}: |port - jax| {err:.3e} > {bound:.3e}"
    else:
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
        assert np.array_equal(got, ref), f"{name}: {int((got != ref).sum())} values differ"


def _same_h5(port_path, jax_path):
    got, _ = read_h5(port_path)
    ref, _ = read_h5(jax_path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(k, got[k], ref[k])
    return got


def _rgb(rng, h=HW, w=HW):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _rot_mats(rng, n):
    aa = rng.standard_normal((n, 24, 3)) * 0.2
    return np.asarray(j_axisang_to_rot(jnp.asarray(aa))).astype(np.float32)


def _spin_arrays(rng, n, h, w):
    return {
        "pred_betas": rng.standard_normal((n, 10)).astype(np.float32) * 0.3,
        "pred_rot_mat": _rot_mats(rng, n),
        "bbox_params": np.stack([np.full(n, w / 2), np.full(n, h / 2), np.full(n, h * 0.8)],
                                -1).astype(np.float32),
        "pred_camera": np.stack([np.full(n, 0.9), rng.uniform(-0.1, 0.1, n),
                                 np.full(n, 0.1)], -1).astype(np.float32),
        "joints": rng.standard_normal((n, 49, 3)).astype(np.float32) * 0.3,
    }


def _spin_h5(path, rng, img_paths, h=HW, w=HW, group=None, extra=None):
    """A SPIN-estimate h5 by h5py, its arrays at the root or in `group`."""
    with h5py.File(path, "w") as f:
        g = f.create_group(group) if group else f
        for k, v in _spin_arrays(rng, len(img_paths), h, w).items():
            g[k] = v
        g["img_path"] = [p.encode() for p in img_paths]
        for k, v in (extra or {}).items():
            f[k] = v


def _smpl_pkl(path, V=120, J=24, seed=13):
    """A random SMPL file in the official layout (both packages load it)."""
    rng = np.random.default_rng(seed)
    parents = np.array([0] + [int(rng.integers(0, j)) for j in range(1, J)])
    kintree = np.stack([parents.astype(np.uint32), np.arange(J, dtype=np.uint32)])
    kintree[0, 0] = np.uint32(4294967295)
    J_reg = rng.random((J, V))
    w = np.exp(rng.standard_normal((V, J)) * 2)
    data = {
        "v_template": rng.standard_normal((V, 3)) * 0.3,
        "shapedirs": rng.standard_normal((V, 3, 10)) * 0.01,
        "posedirs": rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
        "J_regressor": J_reg / J_reg.sum(1, keepdims=True),
        "kintree_table": kintree,
        "weights": w / w.sum(1, keepdims=True),
        "f": rng.integers(0, V, (50, 3)).astype(np.int64),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ingest")


@pytest.fixture(scope="module")
def smpl_path(root):
    return _smpl_pkl(root / "SMPL_NEUTRAL.pkl")


# ---------------------------------------------------------------------------
# raw trees, one per dataset
# ---------------------------------------------------------------------------

def _look_at(eye):
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def surreal_tree(d, rng, n_kp=2, n_cams=2):
    """Two sequences (two render types) of n_kp poses x n_cams cameras."""
    from scipy.io import savemat

    for si, seq in enumerate(["run_01", "walk_02"]):
        sub = d / seq / "0-1"
        (sub / "imageSequences").mkdir(parents=True)
        meta = {
            "focal": 600.0, "int_scale": 1.0,
            "render_type": "static" if si == 0 else "moving",
            "cams": np.stack([_look_at(np.array([3.0, 0.5, 0.0])),
                              _look_at(np.array([0.0, 0.5, 3.0]))]),
            "N_kp": n_kp, "N_cams": n_cams, "N_cam_per_subdir": n_cams,
            "joints3D": rng.standard_normal((n_kp, 24, 3)).astype(np.float32) * 0.2,
            "poses": (rng.standard_normal((n_kp, 72)) * 0.2).astype(np.float32),
        }
        with open(d / seq / "metadata.pkl", "wb") as f:
            pickle.dump(meta, f)
        savemat(sub / "001_segm.mat",
                {"data": rng.integers(0, 3, (n_cams * n_kp, HW, HW)).astype(np.uint8)})
        for i in range(n_cams * n_kp):
            cv2.imwrite(str(sub / "imageSequences" / f"{i:04d}.png"), _rgb(rng))


def h36m_tree(d, rng, H=40):
    """S9: 4 frames over 3 cameras (one a 'Sitting-' chair sequence, one a
    camera of H + 2 rows, cut by [1:-1]) as JPEGs, the SPIN and mask h5
    files by h5py, clean and chair background plates."""
    (d / "images").mkdir(parents=True)
    paths = []
    for i, (seq, cam, h) in enumerate((("Walking-", "54138969", H), ("Walking-", "55011271", H),
                                       ("Sitting-", "58860488", H), ("Walking-", "60457274",
                                                                     H + 2))):
        p = f"images/{seq}{cam}_{i:05d}.jpg"
        cv2.imwrite(str(d / p), _rgb(rng, h, H))
        paths.append(p)
    _spin_h5(d / "S9_SPIN_rect_output-maxmin.h5", rng, paths, H, H)
    with h5py.File(d / "S9_mask_deeplab_crop.h5", "w") as f:
        f["masks"] = rng.integers(0, 4, (len(paths), H, H), dtype=np.uint8)
    np.save(d / "S9_clean_bkgds.npy", rng.integers(0, 256, (4, H, H, 3), dtype=np.uint8))
    np.save(d / "S9_chair_bkgds.npy", rng.integers(0, 256, (4, H, H, 3), dtype=np.uint8))


def perfcap_tree(d, rng, subj="Weipeng_outdoor"):
    """Images and DeepLab-id masks as PNGs, the SPIN arrays in a `data/`
    group (deepdish's nesting)."""
    base = d / "MonoPerfCap" / subj
    (base / "images").mkdir(parents=True)
    (base / "masks").mkdir(parents=True)
    cv2.imwrite(str(base / "bkgd.png"), _rgb(rng))
    paths = []
    for i in range(N):
        p = f"MonoPerfCap/{subj}/images/{i:04d}.png"
        cv2.imwrite(str(d / p), _rgb(rng))
        cv2.imwrite(str(d / p.replace("/images/", "/masks/")),
                    rng.integers(0, 4, (HW, HW), dtype=np.uint8))
        paths.append(p)
    _spin_h5(d / "MonoPerfCap" / f"MonoPerfCap-{subj}.h5", rng, paths, group="data")


def mixamo_tree(d, rng, subj="James", seq="Jab", n_cam=2, n_kp=2):
    paths = []
    for c in range(n_cam):
        cam_d = d / subj / seq / f"Camera_{c}"
        (cam_d / "Masks").mkdir(parents=True)
        for k in range(n_kp):
            name = f"Image{k + 1:04d}.png"
            cv2.imwrite(str(cam_d / name), _rgb(rng))
            cv2.imwrite(str(cam_d / "Masks" / name), rng.integers(0, 4, (HW, HW), dtype=np.uint8))
            paths.append(f"{subj}/{seq}/Camera_{c}/{name}")
    gt = [{f"j{j}": rng.standard_normal(3).astype(np.float32) for j in range(24)}
          for _ in range(n_kp)]
    with open(d / subj / seq / "Camera_0" / "metadata.pickle", "wb") as f:
        pickle.dump({"gt_pose": gt}, f)
    _spin_h5(d / subj / f"{subj}.h5", rng, paths)


def hp3d_tree(d, rng):
    """S1 (4 frames) and S2 (2), a background plate for S1, gt pose_3d."""
    paths = []
    for subj, n in (("S1", N), ("S2", 2)):
        (d / subj / "imageSequence").mkdir(parents=True)
        (d / subj / "masks").mkdir(parents=True)
        for i in range(n):
            p = f"{subj}/imageSequence/img_{i:04d}.png"
            cv2.imwrite(str(d / p), _rgb(rng))
            cv2.imwrite(str(d / p.replace("/imageSequence/", "/masks/")),
                        rng.integers(0, 4, (HW, HW), dtype=np.uint8))
            paths.append(p)
    cv2.imwrite(str(d / "S1_bkgd.png"), _rgb(rng))
    _spin_h5(d / "MPI_SPIN_rect_output-maxmin.h5", rng, paths,
             extra={"pose_3d": rng.standard_normal((len(paths), 24, 4)).astype(np.float32)})


def zju_tree(d, rng, n_frames=3, n_cams=19):
    """CoreView_377 with 19 cameras (main's training views 0, 6, 12, 18
    exist on disk), real-magnitude distortion, JPEG frames, PNG masks under
    mask/ (and mask_cihp/ for one view, which takes precedence)."""
    sp = d / "CoreView_377"
    (sp / "params").mkdir(parents=True)
    Ks, Ds, Rs, Ts = [], [], [], []
    for c in range(n_cams):
        f = 40.0 + c
        Ks.append(np.array([[f, 0, HW / 2 + 0.3], [0, f * 1.01, HW / 2 - 0.4], [0, 0, 1]]))
        Ds.append(np.array([[-0.2 + 0.01 * c], [0.05], [0.001], [-0.001], [0.01]]))
        Rs.append(cv2.Rodrigues(np.array([0.0, 2 * np.pi * c / n_cams, 0.0]))[0])
        Ts.append(np.array([[0.0], [0.0], [2500.0]]))
    ims = []
    for fi in range(n_frames):
        frame = []
        for v in range(n_cams):
            p = f"images/Camera_B{v + 1}/{fi:06d}.jpg"
            frame.append(p)
            if v % 6:
                continue
            (sp / os.path.dirname(p)).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(sp / p), _rgb(rng))
            for md in ("mask", "mask_cihp") if v == 6 else ("mask",):
                mp = p.replace("images", md).replace(".jpg", ".png")
                (sp / os.path.dirname(mp)).mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(sp / mp), rng.integers(0, 2, (HW, HW), dtype=np.uint8) * 255)
        ims.append({"ims": frame})
        np.save(sp / "params" / f"{fi}.npy", {
            "poses": (rng.standard_normal((1, 72)) * 0.2).astype(np.float32),
            "shapes": (rng.standard_normal((1, 10)) * 0.2).astype(np.float32),
            "Rh": (rng.standard_normal((1, 3)) * 0.2).astype(np.float32),
            "Th": rng.standard_normal((1, 3)).astype(np.float32),
        })
    np.save(sp / "annots.npy", {"cams": {"K": Ks, "D": Ds, "R": Rs, "T": Ts}, "ims": ims})


TREES = {
    # dataset: (tree writer, seed, extra argv)
    "surreal": (surreal_tree, 0, []),
    "h36m": (h36m_tree, 1, ["--subject", "S9"]),
    "h36m_smpl_res": (h36m_tree, 2, ["--subject", "S9", "--res", "0.7", "--extend_iter", "1"]),
    "perfcap": (perfcap_tree, 3, ["--subject", "Weipeng_outdoor"]),
    "mixamo": (mixamo_tree, 4, ["--subject", "James", "--n_cam", "2"]),
    "3dhp": (hp3d_tree, 5, ["--subject", "S1"]),
    "zju": (zju_tree, 6, ["--subject", "377", "--n_frames", "2"]),
}


@functools.lru_cache(maxsize=None)
def _ingested(case, root, smpl_path):
    """Both packages' ingest.main on one raw tree -> (port h5, jax h5)."""
    write, seed, argv = TREES[case]
    d = root / f"raw_{case}"
    d.mkdir()
    write(d, np.random.default_rng(seed))
    if case in ("h36m_smpl_res", "zju"):
        argv = argv + ["--smpl_path", smpl_path]
    dataset = case.split("_")[0]
    out_p, out_j = str(root / f"{case}_port.h5"), str(root / f"{case}_jax.h5")
    ting.main([dataset, str(d), out_p] + argv, device="cpu")
    jing.main([dataset, str(d), out_j] + argv)
    return out_p, out_j


@pytest.mark.parametrize("case", sorted(TREES))
def test_ingest_main_matches_jax(case, root, smpl_path):
    """The port's H5 equals JAX's key for key (module doc's rule)."""
    got = _same_h5(*_ingested(case, root, smpl_path))
    n = got["imgs"].shape[0]
    assert got["kp_idxs"].shape == (n,) and np.isfinite(got["skts"]).all()
    if case == "zju":  # 2 frames x the 4 training views, undistorted
        raw = cv2.imread(str(root / "raw_zju" / "CoreView_377" / "images" / "Camera_B1" /
                             "000000.jpg"))[..., ::-1]
        assert got["imgs"].shape == (8, HW, HW, 3) and not np.array_equal(got["imgs"][0], raw)


def test_ingested_file_loads(root, smpl_path):
    """The port's SURREAL file through the port's training dataset."""
    from posegen_tpu_torch.data.h5dataset import H5RayDataset

    ds = H5RayDataset(_ingested("surreal", root, smpl_path)[0], n_rays_per_image=8)
    try:
        assert ds.n_images == 8 and (ds.H, ds.W) == (HW, HW)
        out = ds.sample_image(0)
        assert out["rays_o"].shape == (8, 3) and np.isfinite(out["rays_o"]).all()
    finally:
        ds.close()


def test_read_spin_h5_missing_joints_raises_as_jax(tmp_path):
    path = tmp_path / "S9_SPIN_rect_output-maxmin.h5"
    with h5py.File(path, "w") as f:
        f["pred_betas"] = np.zeros((2, 10), np.float32)
    for read in (ting.read_spin_h5, jing.read_spin_h5):
        with pytest.raises(KeyError, match="joints"):
            read(str(path))


def test_read_spin_h5_nested_group_and_pose_3d(tmp_path):
    rng = np.random.default_rng(7)
    path = tmp_path / "spin.h5"
    _spin_h5(path, rng, ["a/b.png", "a/c.png"], group="data",
             extra={"pose_3d": rng.standard_normal((2, 24, 4)).astype(np.float32)})
    got, ref = ting.read_spin_h5(str(path)), jing.read_spin_h5(str(path))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_read_spin_h5_refuses_a_filter_it_cannot_decode(tmp_path):
    """A compressed dump the reader cannot decode (blosc in deepdish's
    dumps; lzf stands in here) raises ValueError naming the dataset."""
    path = tmp_path / "spin.h5"
    with h5py.File(path, "w") as f:
        for k, v in _spin_arrays(np.random.default_rng(8), 2, HW, HW).items():
            f.create_dataset(k, data=v, compression="lzf" if k == "joints" else None)
    with pytest.raises(ValueError, match="joints"):
        ting.read_spin_h5(str(path))


# ---------------------------------------------------------------------------
# spin.py and loaders.py, function by function
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _spin_inputs(seed=11):
    rng = np.random.default_rng(seed)
    a = _spin_arrays(rng, N, 48, 64)
    return (a["pred_betas"], a["pred_camera"], a["joints"], a["pred_rot_mat"],
            a["bbox_params"])


@functools.lru_cache(maxsize=None)
def _models():
    return (jsmpl.make_random_model(100, 24, 10, seed=3),
            tsmpl.make_random_model(100, 24, 10, seed=3, device="cpu"))


@pytest.mark.parametrize("new_focal", [None, 1000.0])
def test_crop_cam_conversions(new_focal):
    betas, cams, joints, rots, bboxes = _spin_inputs()
    _close("orig cam", tspin.convert_crop_cam_to_orig_img_and_focal(
        cams, bboxes, 64, 48, new_focal=new_focal),
        jspin.convert_crop_cam_to_orig_img_and_focal(cams, bboxes, 64, 48, new_focal=new_focal))
    for got, ref in zip(tspin.pred_cams_to_orig_cam_params(cams, bboxes, 64, 48, ext_scale=0.7,
                                                           new_focal=new_focal),
                        jspin.pred_cams_to_orig_cam_params(cams, bboxes, 64, 48, ext_scale=0.7,
                                                           new_focal=new_focal)):
        _close("cam params", got, ref)


@pytest.mark.parametrize("with_model", [False, True])
def test_rest_pose_from_betas(with_model):
    jm, tm = _models() if with_model else (None, None)
    betas = _spin_inputs()[0]
    _close("rest", tspin.rest_pose_from_betas(betas, tm), jspin.rest_pose_from_betas(betas, jm))


@pytest.mark.parametrize("scale_rest_pose", [True, False])
def test_keypoints_from_spin(scale_rest_pose):
    _, _, joints, rots, _ = _spin_inputs()
    rest = tspin.rest_pose_from_betas(_spin_inputs()[0], _models()[1])
    got = tspin.keypoints_from_spin(joints, rots, rest, 1.7, scale_rest_pose=scale_rest_pose,
                                    device="cpu")
    ref = jspin.keypoints_from_spin(joints, rots, rest, 1.7, scale_rest_pose=scale_rest_pose)
    for name, g, r in zip(("kp3d", "bones", "skts", "rest", "scale"), got, ref):
        _close(name, g, r)


@pytest.mark.parametrize("with_model", [False, True])
def test_process_spin_data(with_model):
    jm, tm = _models() if with_model else (None, None)
    args = _spin_inputs()
    got = tspin.process_spin_data(*args, smpl_model=tm, res=(48, 64), device="cpu")
    ref = jspin.process_spin_data(*args, smpl_model=jm, res=(48, 64))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(k, got[k], ref[k])


@functools.lru_cache(maxsize=None)
def _bones(seed=12):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((N, 24, 3)) * 0.3).astype(np.float32),
            rng.standard_normal((N, 3)).astype(np.float32),
            (rng.standard_normal((N, 24, 3)) * 0.2).astype(np.float32))


@pytest.mark.parametrize("branch", ["plain", "pelvis", "root_rot_override", "rest_scale"])
def test_pose_block_from_bones(branch):
    bones, pelvis, kp3d = _bones()
    kw = {"plain": {}, "pelvis": dict(pelvis=pelvis),
          "root_rot_override": dict(root_rot=jload.SURREAL_ROT_ROOTBONE, kp3d_override=kp3d,
                                    head="-y", scale=0.7),
          "rest_scale": dict(rest_pose=_models()[1].v_template[:24].numpy() * 0.5, scale=1.3,
                             pelvis=pelvis, ext_scale=0.002)}[branch]
    got = tload.pose_block_from_bones(bones, device="cpu", **kw)
    ref = jload.pose_block_from_bones(bones, **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(k, got[k], ref[k])


def _images(rng, n=N):
    imgs = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
    masks = (rng.uniform(size=(n, HW, HW, 1)) > 0.6).astype(np.uint8)
    c2ws = np.stack([_look_at(np.array([3.0 * np.cos(t), 0.4, 3.0 * np.sin(t)]))
                     for t in np.linspace(0, 6, n)])
    return imgs, masks, c2ws, np.full(n, 50.0, np.float32)


@pytest.mark.parametrize("proc", ["surreal", "spin_estimated", "mixamo", "zju"])
def test_process_writers_match_jax(proc, tmp_path):
    """Each process_* writer: the two H5 files key for key."""
    rng = np.random.default_rng(13)
    imgs, masks, c2ws, focals = _images(rng)
    bones, pelvis, kp3d = _bones()
    out = {}
    for name, mod, kw in (("port", tload, dict(device="cpu")), ("jax", jload, {})):
        path = str(tmp_path / f"{name}.h5")
        if proc == "surreal":
            mod.process_surreal(path, imgs, masks, bones, kp3d, c2ws, focals,
                                np.arange(N) % 2, np.arange(N), bkgds=imgs[:1], **kw)
        elif proc == "spin_estimated":
            mod.process_spin_estimated(path, imgs, masks, *_spin_inputs(), res=HW,
                                       gt_kp3d=kp3d, dilate_iters=1, **kw)
        elif proc == "mixamo":
            mod.process_mixamo(path, imgs, masks, bones, pelvis, c2ws, focals, **kw)
        else:
            mod.process_zju(path, imgs, masks, bones.reshape(N, 72), pelvis, c2ws, focals,
                            centers=np.full((N, 2), HW / 2), **kw)
        out[name] = path
    _same_h5(out["port"], out["jax"])


@pytest.mark.parametrize("scale_to_ref", [True, False])
def test_zju_get_smpls(scale_to_ref, tmp_path):
    rng = np.random.default_rng(14)
    sp = tmp_path / "subject"
    (sp / "params").mkdir(parents=True)
    for i in range(N):
        np.save(sp / "params" / f"{i}.npy", {
            "poses": (rng.standard_normal((1, 72)) * 0.25).astype(np.float32),
            "shapes": (rng.standard_normal((1, 10)) * 0.25).astype(np.float32),
            "Rh": (rng.standard_normal((1, 3)) * 0.3).astype(np.float32),
            "Th": rng.standard_normal((1, 3)).astype(np.float32),
        })
    jm, tm = _models()
    got = ting.zju_get_smpls(str(sp), range(N), tm, ext_scale=0.001, scale_to_ref=scale_to_ref)
    ref = jing.zju_get_smpls(str(sp), range(N), jm, ext_scale=0.001, scale_to_ref=scale_to_ref)
    for name, g, r in zip(("betas", "kp3d", "bones", "skts", "rest_pose", "vertices",
                           "pose_scale"), got, ref):
        _close(name, g, r)


# ---------------------------------------------------------------------------
# _imread, undistort_u8
# ---------------------------------------------------------------------------

def _png_files(d):
    """One PNG of each kind the JAX package's cv2 reading distinguishes."""
    from PIL import Image

    rng = np.random.default_rng(15)
    rgb = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    files = {
        "rgb": Image.fromarray(rgb),
        "rgba": Image.fromarray(rng.integers(0, 256, (9, 7, 4), dtype=np.uint8)),
        "grey": Image.fromarray(rng.integers(0, 256, (9, 7), dtype=np.uint8)),
        "grey_alpha": Image.fromarray(rng.integers(0, 256, (9, 7, 2), dtype=np.uint8), "LA"),
        "palette": Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=200),
    }
    out = {}
    for k, im in files.items():
        out[k] = str(d / f"{k}.png")
        im.save(out[k])
    out["palette_trns"] = str(d / "palette_trns.png")
    files["palette"].save(out["palette_trns"], transparency=3)
    for k, shape in (("grey16", (9, 7)), ("rgb16", (9, 7, 3)), ("rgba16", (9, 7, 4))):
        out[k] = str(d / f"{k}.png")
        cv2.imwrite(out[k], rng.integers(0, 65536, shape, dtype=np.uint16))
    return out


JPEG_DIR = os.path.join(os.path.dirname(__file__), "data", "jpeg")
PNG_KINDS = ["rgb", "rgba", "grey", "grey_alpha", "palette", "palette_trns", "grey16", "rgb16",
             "rgba16"]
JPEGS = sorted(f for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))


@pytest.mark.parametrize("kind", PNG_KINDS + JPEGS)
def test_imread_matches_jax(kind, root):
    d = root / "imread"
    if not d.exists():
        d.mkdir()
    path = _png_files(d)[kind] if kind in PNG_KINDS else os.path.join(JPEG_DIR, kind)
    got, ref = ting._imread(path), jing._imread(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref)


UNDISTORT_CASES = {
    # name: (H, W, channels, focal, distortion)
    "odd_rgb": (37, 53, 3, 40.0, [-0.2, 0.05, 0.001, -0.002, 0.01]),
    "odd_grey": (31, 29, 1, 25.0, [-0.25, 0.08, -0.001, 0.002, 0.0]),
    "grey_hw1": (33, 41, None, 30.0, [-0.2, 0.05, 0.0, 0.0]),
    "wide_stripes_of_1_row": (5, 4200, 3, 2000.0, [-0.2, 0.02, 0.001, 0.001, 0.0]),
    "strong_k1_k3": (40, 36, 3, 25.0, [-0.9, 0.4, 0.01, 0.01, 0.8]),
    "strong_positive": (31, 29, 1, 20.0, [0.5, 1.0, 0.0, 0.0, 2.0]),
    "zero": (36, 36, 3, 50.0, [0.0] * 5),
}


@pytest.mark.parametrize("case", sorted(UNDISTORT_CASES))
def test_undistort_u8_bit_equal_to_cv2(case):
    H, W, C, f, d = UNDISTORT_CASES[case]
    rng = np.random.default_rng(sorted(UNDISTORT_CASES).index(case))
    img = rng.integers(0, 256, (H, W) if C is None else (H, W, C), dtype=np.uint8)
    K = np.array([[f, 0, W / 2 + 0.3], [0, f * 1.01, H / 2 - 0.7], [0, 0, 1]])
    D = np.array(d)
    got, ref = undistort_u8(img, K, D), cv2.undistort(img, K, D)
    assert got.shape == ref.shape and np.array_equal(got, ref), int((got != ref).sum())
    if case.startswith("strong"):
        assert (ref == 0).any()  # the border's black reaches into the frame


def test_undistort_u8_refuses_more_coefficients():
    with pytest.raises(ValueError, match="distortion coefficients"):
        undistort_u8(np.zeros((4, 4), np.uint8), np.eye(3), np.zeros(8))


# ---------------------------------------------------------------------------
# entry points and the loader benchmark
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ting.main(["surreal", str(tmp_path), str(tmp_path / "x.h5")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tload.pose_block_from_bones(_bones()[0])


def test_bench_loader_both_variants(tmp_path, capsys):
    tbench.main(["--res", "32", "--n_images", "4", "--N_rand", "64", "--N_sample_images", "4",
                 "--n_batches", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["variant"] for r in lines] == ["native", "numpy"]
    for r in lines:
        assert r["batches_per_s"] > 0 and r["rays_per_s"] == pytest.approx(64 * r["batches_per_s"])
