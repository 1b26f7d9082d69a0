"""The port's data layer (posegen_tpu_torch/data/) against the JAX
package's (posegen_tpu/data/) on the same files and seeds: the synthetic
builder, the files each package writes read by the other's loader, batches
bit-equal through the native sampler, the numpy sampler, worker processes
and multi-subject concatenation, the render data and image subsets, the
catalog's triple."""

import functools
import os
import pickle
import shutil

import h5py
import numpy as np
import pytest

from posegen_tpu.data import catalog as jcat
from posegen_tpu.data import h5dataset as jh
from posegen_tpu.data import native as jnative
from posegen_tpu.data import synthetic as jsyn
from posegen_tpu_torch.data import catalog as pcat
from posegen_tpu_torch.data import h5dataset as ph
from posegen_tpu_torch.data import native as pnative
from posegen_tpu_torch.data import synthetic as psyn
from posegen_tpu_torch.data.hdf5 import read_h5

SHAPE = dict(n_images=12, H=24, W=32, n_poses=6)
POSE_TOL = 1e-5  # kp3d / skts / cyls, float32 kinematics of each package
PIXEL_FRAC = 1e-3  # pixels allowed to differ (by at most one level)


@functools.lru_cache(maxsize=None)
def _files(tmp_dir: str):
    """(port-written, JAX-written) synthetic files of one scene."""
    return (psyn.make_synthetic_h5(f"{tmp_dir}/port.h5", **SHAPE),
            jsyn.make_synthetic_h5(f"{tmp_dir}/jax.h5", **SHAPE))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("data")))


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_make_synthetic_h5_matches_jax(files):
    port, jax_ = (read_h5(p)[0] for p in files)
    assert sorted(port) == sorted(jax_)
    for k in jax_:
        assert port[k].dtype == jax_[k].dtype and port[k].shape == jax_[k].shape, k
        if k in ("kp3d", "skts", "cyls"):
            np.testing.assert_allclose(port[k], jax_[k], atol=POSE_TOL, rtol=0, err_msg=k)
        elif k in ("imgs", "masks", "sampling_masks"):
            d = np.abs(port[k].astype(np.int16) - jax_[k].astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() <= PIXEL_FRAC, k
        elif k not in ("sampling_idxs", "sampling_idx_offsets"):
            np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)


def test_jax_loader_reads_the_port_file(files):
    """JAX's H5RayDataset takes its unchunked fast path on the port's file
    and reads the same metadata as the port's dataset."""
    j, p = jh.H5RayDataset(files[0], 8), ph.H5RayDataset(files[0], 8)
    assert j._row_offs is not None and j._sidx_off is not None
    assert p._row_offs is not None
    for name in ("imgs", "masks", "sampling_masks", "bkgds"):
        np.testing.assert_array_equal(p._row_offs[name], j._row_offs[name])
    assert p._sidx_off[0] == j._sidx_off[0]
    np.testing.assert_array_equal(p._sidx_off[1], j._sidx_off[1])
    for k in ("kp3d", "bones", "skts", "cyls", "rest_pose", "c2ws", "focals", "kp_idxs",
              "cam_idxs", "bkgd_idxs", "temp_validity", "temp_val", "_pixel_dirs"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    assert (p.H, p.W, p.n_images, p.ext_scale) == (j.H, j.W, j.n_images, j.ext_scale)


def _no_lib(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda *a, **k: None)
    monkeypatch.setattr(pnative, "get_lib", lambda *a, **k: None)


def _loaders(paths, case, seed=5):
    def make(mod):
        if case == "concat":
            ds = mod.ConcatRayDataset([mod.H5RayDataset(p, 8, seed=i)
                                       for i, p in enumerate(paths)])
        else:
            ds = mod.H5RayDataset(paths[0], 8, seed=seed)
        return mod.RayBatchLoader(ds, n_images_per_batch=4, seed=seed,
                                  num_workers=2 if case.endswith("workers") else 0)
    return make(ph), make(jh)


@pytest.mark.parametrize("case", ["native", "numpy", "workers", "numpy_workers", "concat"])
def test_batches_bit_equal_to_jax(files, case, monkeypatch):
    """Three batches of each package's loader on the JAX-written (per-image
    chunked) file, the same seed: equal bit for bit. With worker processes,
    the JAX loader's batch depends on which worker took its task (worker w
    seeds with loader seed + 1 + w); the port's draws what JAX's worker 0
    draws, whichever worker takes it. So each port batch is held to that
    JAX draw, and each JAX batch to one of its workers' draws. On the numpy
    sampler, a port worker draws batch `bid` from rng (seed + 1, bid, 0);
    each of its batches is held to JAX's numpy sampler on that rng."""
    if case.startswith("numpy"):
        _no_lib(monkeypatch)
    # worker processes: pretend to have cores, as the JAX loader's test does
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    paths = [files[1], files[0]]
    port, jax_ = _loaders(paths, case)
    try:
        if case.endswith("workers"):
            pit, jit_ = iter(port), iter(jax_)
            assert len(port._procs) == 2 and len(jax_._procs) == 2
            pairs = [(next(pit), next(jit_)) for _ in range(3)]
        else:
            pairs = [(port.make_batch(), jax_.make_batch()) for _ in range(3)]
    finally:
        port.close()
        jax_.close()
    perm = np.random.default_rng(5).permutation(12)
    ds = jh.H5RayDataset(paths[0], 8)
    if case == "numpy_workers":
        for bid, (got, _) in enumerate(pairs):
            ds.rng = np.random.default_rng((5 + 1, bid, 0))
            parts = [ds.sample_image(int(i)) for i in perm[4 * bid:4 * bid + 4]]
            _assert_batches_equal(got, {k: np.concatenate([p[k] for p in parts])
                                        for k in parts[0]})
        return
    if case == "workers":
        for bid, (got, want) in enumerate(pairs):
            idxs = perm[4 * bid:4 * bid + 4]
            draws = [ds.sample_batch(idxs, (5 + 1 + w) * 600011 + bid) for w in range(2)]
            _assert_batches_equal(got, draws[0])
            assert any(all(np.array_equal(want[k], d[k]) for k in d) for d in draws)
        return
    for got, want in pairs:
        _assert_batches_equal(got, want)
    if case == "concat":
        assert set(np.unique(pairs[0][0]["subject_idxs"])) <= {0, 1}


def test_native_sampler_path_is_taken(files):
    ds = ph.H5RayDataset(files[1], 8)
    out = ds.sample_batch(np.arange(3), seed=11)
    assert out is not None and out["rays_o"].shape == (24, 3)
    assert ds._sample_image_native(0) is not None
    _assert_batches_equal(ph.H5RayDataset(files[1], 8, seed=3).sample_image(2),
                          jh.H5RayDataset(files[1], 8, seed=3).sample_image(2))


def test_sample_and_gather_matches_jax_native(rng):
    n = 40 * 30
    smask = (rng.uniform(size=n) > 0.6).astype(np.uint8)
    img = rng.integers(0, 255, (n, 3), dtype=np.uint8)
    mask = (rng.uniform(size=n) > 0.5).astype(np.uint8)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    bkgd = rng.integers(0, 255, (n, 3), dtype=np.uint8)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, 3] = [0.5, -1.0, 2.0]
    args = (smask, img, mask, dirs, c2w, 50.0, 47.0, 64, 1234)
    _assert_batches_equal(pnative.sample_and_gather(*args, bkgd=bkgd),
                          jnative.sample_and_gather(*args, bkgd=bkgd))


def test_failed_sampler_build_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a build that fails raises with the
    compiler's output."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnative, "CXX_FLAGS", pnative.CXX_FLAGS + ("--not-a-compiler-flag",))
    with pytest.raises(RuntimeError, match="native sampler build failed"):
        pnative.get_lib()


def test_dataset_pickles_without_its_memmap(files):
    ds = ph.H5RayDataset(files[0], 8)
    ds.sample_batch(np.arange(2), seed=1)
    assert ds._filemap is not None
    clone = pickle.loads(pickle.dumps(ds))
    assert clone._filemap is None
    _assert_batches_equal(clone.sample_batch(np.arange(2), seed=1),
                          ds.sample_batch(np.arange(2), seed=1))


def _with_paths(src: str, dst: str, paths) -> str:
    shutil.copy(src, dst)
    with h5py.File(dst, "r+") as f:
        f.create_dataset("img_paths", data=[p.encode() for p in paths],
                         dtype=h5py.string_dtype("ascii"))
    return dst


@functools.lru_cache(maxsize=None)
def _paths_file(tmp_dir: str) -> str:
    """A 16-image file with per-image poses and img_paths: two motion sets
    of 8 frames (4 views x 2 poses each), sequences split by val prefix."""
    src = jsyn.make_synthetic_h5(f"{tmp_dir}/mv_src.h5", n_images=16, H=16, W=20)
    paths = [f"S9/{'Walking-1' if i < 8 else 'Eating-2'}/cam{i % 4}/{i:04d}.png"
             for i in range(16)]
    return _with_paths(src, f"{tmp_dir}/mv.h5", paths)


@pytest.mark.parametrize("subset", ["all", "use_val_train", "use_val_val", "camera", "n_cams",
                                    "multiview"])
def test_render_data_and_subsets_match_jax(tmp_path_factory, subset):
    path = _paths_file(str(tmp_path_factory.mktemp("paths")))
    kw = {"all": {}, "use_val_train": {"split": "train"}, "use_val_val": {"split": "val"},
          "camera": {"camera": 5}, "n_cams": {"n_cams": 2}, "multiview": {"multiview": True}
          }[subset]
    p, j = ph.H5RayDataset(path, 8, **kw), jh.H5RayDataset(path, 8, **kw)
    assert p.n_images == j.n_images
    assert (p.n_images < 16) == (subset not in ("all", "multiview"))
    for k in ("_img_map", "kp_idxs", "cam_idxs", "c2ws", "kp_map", "kp_uidxs", "temp_val"):
        a, b = getattr(p, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert list(p._img_paths) == list(j._img_paths)
    idxs = list(range(0, p.n_images, 3))
    got, want = p.get_render_data(idxs), j.get_render_data(idxs)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "hwf":
            assert got[k][:2] == want[k][:2] and float(got[k][2]) == float(want[k][2])
        elif subset == "multiview" and k in ("kp3d", "bones", "skts"):
            # float32 forward kinematics of each package
            np.testing.assert_allclose(got[k], want[k], atol=POSE_TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if subset != "multiview":
        loader_p = ph.RayBatchLoader(p, n_images_per_batch=3, seed=2)
        loader_j = jh.RayBatchLoader(j, n_images_per_batch=3, seed=2)
        _assert_batches_equal(loader_p.make_batch(), loader_j.make_batch())


def _data_cfg(mod, root, **kw):
    return mod.DataConfig(dataset="synthetic", subject="demo", data_root=root, n_rand=64,
                          n_sample_images=4, num_val_images=2, num_workers=0, **kw)


def test_load_data_triple_matches_jax(tmp_path):
    path = tmp_path / "synthetic" / "demo.h5"
    path.parent.mkdir(parents=True)
    jsyn.make_synthetic_h5(str(path), n_images=8, H=24, W=24)
    (lp, rp, ap), (lj, rj, aj) = (mod.load_data(_data_cfg(mod, str(tmp_path)))
                                  for mod in (pcat, jcat))
    _assert_batches_equal(lp.make_batch(), lj.make_batch())
    assert sorted(rp) == sorted(rj)
    for k in rj:
        if k == "hwf":
            assert rp[k][:2] == rj[k][:2]
            np.testing.assert_array_equal(rp[k][2], rj[k][2])
        else:
            np.testing.assert_array_equal(rp[k], rj[k], err_msg=k)
    assert sorted(ap) == sorted(aj)
    for k in aj:
        if k == "hwf":
            assert ap[k][:2] == aj[k][:2]
        elif aj[k] is None:
            assert ap[k] is None, k
        else:
            np.testing.assert_array_equal(ap[k], aj[k], err_msg=k)
    lp.close()
    lj.close()


def test_load_data_builds_a_missing_synthetic_file(tmp_path):
    loader, render_data, attrs = pcat.load_data(_data_cfg(pcat, str(tmp_path)))
    assert os.path.exists(tmp_path / "synthetic" / "demo.h5")
    assert loader.make_batch()["rays_o"].shape == (64, 3)
    assert render_data["imgs"].shape[0] == 2 and attrs["n_framecodes"] == 8
    assert pcat.resolve_h5_path(pcat.DataConfig(dataset="surreal", subject="female",
                                                data_root="r")) == \
        jcat.resolve_h5_path(jcat.DataConfig(dataset="surreal", subject="female",
                                             data_root="r"))
    assert pcat.DATASET_CATALOG == jcat.DATASET_CATALOG
    assert ph.VAL_SEQ_PREFIXES == jh.VAL_SEQ_PREFIXES


def test_dilate_masks_matches_jax(rng):
    from posegen_tpu.data.writer import dilate_masks as jdil
    from posegen_tpu_torch.data.writer import dilate_masks as pdil

    m = (rng.uniform(size=(3, 20, 18, 1)) > 0.93).astype(np.uint8)
    np.testing.assert_array_equal(pdil(m), jdil(m))
