"""The port's HDF5 reader and writer (posegen_tpu_torch/data/hdf5.py)
against h5py: files that h5py and the JAX package's writer produce read
bit-equal key for key, with their row offsets; the port's files read
bit-equal through h5py; what the reader does not support raises."""

import functools

import h5py
import numpy as np
import pytest

from posegen_tpu_torch.data.hdf5 import H5File, read_h5, write_h5


def _assert_same(got, want, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == object:
        assert list(got.reshape(-1)) == list(want.reshape(-1)), name
    else:
        assert got.tobytes() == want.tobytes(), name


def _h5py_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                     else None)
    return out


@functools.lru_cache(maxsize=None)
def _jax_pose_h5(tmp_dir: str) -> str:
    from posegen_tpu.data.synthetic import make_synthetic_h5

    # 70 images: the per-image chunk index outgrows one B-tree node (64
    # entries at h5py's K = 32), so the reader walks two levels
    return make_synthetic_h5(f"{tmp_dir}/jax.h5", n_images=70, H=8, W=12, n_poses=9)


@pytest.fixture(scope="module")
def jax_h5(tmp_path_factory):
    return _jax_pose_h5(str(tmp_path_factory.mktemp("h5")))


def test_jax_written_pose_h5_reads_bit_equal(jax_h5):
    got, _ = read_h5(jax_h5)
    want = _h5py_arrays(jax_h5)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_same(got[k], want[k], k)


def test_row_offsets_equal_h5py_chunk_info(jax_h5):
    _, rows = read_h5(jax_h5)
    assert sorted(rows) == ["bkgds", "imgs", "masks", "sampling_masks"]
    with h5py.File(jax_h5, "r") as f:
        for name, offs in rows.items():
            ds = f[name]
            want = np.full(ds.shape[0], -1, np.int64)
            for i in range(ds.id.get_num_chunks()):
                info = ds.id.get_chunk_info(i)
                want[info.chunk_offset[0]] = info.byte_offset
            np.testing.assert_array_equal(offs, want, err_msg=name)
        # and each row's bytes in the file are the row
        raw = np.fromfile(jax_h5, np.uint8)
        row = f["imgs"][5]
        np.testing.assert_array_equal(raw[rows["imgs"][5]:rows["imgs"][5] + row.size],
                                      row.reshape(-1))


def _case_file(path, case):
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        if case == "contiguous":
            f.create_dataset("x", data=rng.standard_normal((5, 7)).astype(np.float32))
            f.create_dataset("u8", data=rng.integers(0, 255, (4, 3, 2), dtype=np.uint8))
            f.create_dataset("i64", data=rng.integers(-9, 9, (6,), dtype=np.int64))
        elif case == "scalar":
            f.create_dataset("s", data=np.float32(0.001))
            f.create_dataset("d", data=np.float64(2.5))
            f.create_dataset("n", data=np.int64(-7))
        elif case == "gzip_shuffle":
            f.create_dataset("g", data=rng.standard_normal((50, 7)).astype(np.float32),
                             compression="gzip", shuffle=True, chunks=(8, 3))
            f.create_dataset("g8", data=rng.integers(0, 9, (100, 33), dtype=np.int64),
                             compression="gzip", compression_opts=9, chunks=(10, 10))
            f.create_dataset("s8", data=rng.integers(0, 255, (6, 5, 5), dtype=np.uint8),
                             shuffle=True, chunks=(1, 5, 5))
        elif case == "fixed_string":
            f.create_dataset("fs", data=np.array([b"hello", b"x", b""], dtype="S7"))
        elif case == "vlen_string":
            paths = [f"S9/{'Greeting' if i % 3 else 'Walking'}-{i}/img_{i:04d}.png".encode()
                     for i in range(40)]
            f.create_dataset("img_paths", data=paths, dtype=h5py.string_dtype("ascii"))
            f.create_dataset("utf8", data=["é/ab", "c"], dtype=h5py.string_dtype())
        elif case == "unallocated":
            f.create_dataset("z", shape=(4, 3), dtype="i4")
            f.create_dataset("fill", shape=(4, 3), dtype="f8", fillvalue=2.5)
            f.create_dataset("partial", shape=(10, 4), dtype="f4", chunks=(3, 4), fillvalue=-1)
            f["partial"][0:3] = 1.0
            f["partial"][9] = 4.0
        elif case == "byte_orders":
            f.create_dataset("be_i", data=np.arange(5, dtype=">i4"))
            f.create_dataset("be_f", data=np.arange(5, dtype=">f8") / 3)
            f.create_dataset("u16", data=np.arange(5, dtype="<u2"))
            f.create_dataset("i8", data=np.arange(-2, 3, dtype="<i1"))
        elif case == "groups":
            g = f.create_group("grp")
            g.create_dataset("inner", data=np.arange(3))
            g.create_group("deeper").create_dataset("x", data=np.ones((2, 2), np.float32))
            for i in range(30):  # more symbols than one leaf node holds
                f.create_dataset(f"many{i:02d}", data=np.arange(i, dtype=np.int16))


@pytest.mark.parametrize("case", ["contiguous", "scalar", "gzip_shuffle", "fixed_string",
                                  "vlen_string", "unallocated", "byte_orders", "groups"])
def test_h5py_files_read_bit_equal(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    _case_file(path, case)
    got, rows = read_h5(path)
    want = _h5py_arrays(path)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_same(got[k], want[k], k)
    with h5py.File(path, "r") as f:
        for name, offs in rows.items():
            ds = f[name]
            assert ds.compression is None and ds.dtype == np.uint8
            if ds.chunks is None:
                rowbytes = int(np.prod(ds.shape[1:]))
                np.testing.assert_array_equal(
                    offs, ds.id.get_offset() + np.arange(ds.shape[0]) * rowbytes)


def test_filtered_rows_have_no_offsets(tmp_path):
    path = str(tmp_path / "f.h5")
    _case_file(path, "gzip_shuffle")
    _, rows = read_h5(path)
    assert "s8" not in rows  # shuffled rows are not the row's bytes


def _written(rng, n):
    d = {f"key{i:02d}": rng.standard_normal((3, i % 4 + 1)).astype(np.float32)
         for i in range(n - 7)}
    d.update({
        "imgs": rng.integers(0, 255, (5, 4, 6, 3), dtype=np.uint8),
        "img_shape": np.asarray([4, 6, 3], np.int64),
        "ext_scale": np.float32(0.001),
        "f8": rng.standard_normal((2, 2)),
        "empty": np.empty(0, np.int32),
        "names": np.array([b"abc", b"de"]),
        "Zscalar": np.int16(-3),
    })
    return d


@pytest.mark.parametrize("n", [7, 18, 45])
def test_write_h5_reads_bit_equal_through_h5py(tmp_path, n):
    d = _written(np.random.default_rng(n), n)
    path = write_h5(str(tmp_path / "w.h5"), d)
    want = _h5py_arrays(path)
    assert sorted(want) == sorted(d)
    for k, v in d.items():
        _assert_same(np.asarray(want[k]), v, k)
    got, rows = read_h5(path)
    for k, v in d.items():
        _assert_same(got[k], v, k)
    with h5py.File(path, "r") as f:
        assert f["imgs"].chunks is None and f["imgs"].compression is None
        np.testing.assert_array_equal(
            rows["imgs"], f["imgs"].id.get_offset() + np.arange(5) * 72)


def test_write_h5_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        write_h5(str(tmp_path / "o.h5"), {"o": np.array([b"a"], dtype=object)})
    with pytest.raises(ValueError, match="root datasets"):
        write_h5(str(tmp_path / "g.h5"), {"a/b": np.zeros(2)})


@pytest.mark.parametrize("case", ["lzf", "fletcher32", "scaleoffset", "latest", "userblock",
                                  "compact", "float16"])
def test_unsupported_files_raise(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    kw = {"latest": {"libver": "latest"}, "userblock": {"userblock_size": 512}}.get(case, {})
    with h5py.File(path, "w", **kw) as f:
        data = np.arange(300, dtype=np.int32)
        if case == "lzf":
            f.create_dataset("a", data=data, compression="lzf")
        elif case == "fletcher32":
            f.create_dataset("a", data=data, fletcher32=True, chunks=(30,))
        elif case == "scaleoffset":
            f.create_dataset("a", data=data, scaleoffset=0, chunks=(30,))
        elif case == "compact":
            space = h5py.h5s.create_simple((4,))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"a", h5py.h5t.NATIVE_INT32, space, dcpl=dcpl)
        elif case == "float16":
            f.create_dataset("a", data=np.arange(4, dtype=np.float16))
        else:
            f.create_dataset("a", data=data)
    with pytest.raises(ValueError) as e:
        read_h5(path)
    want = {"latest": "superblock version", "userblock": "user block",
            "compact": "a: layout class 0", "float16": "a: floating-point type of 2 bytes"
            }.get(case, "a: filter")
    assert want in str(e.value)


def test_h5file_reads_one_dataset_on_demand(jax_h5):
    with H5File(jax_h5) as f:
        assert f.datasets["imgs"].chunks == (1, 8, 12, 3)
        assert f.data_offset("sampling_idxs") is not None
        assert f.data_offset("imgs") is None  # chunked
        np.testing.assert_array_equal(f.read("kp_idxs"), np.arange(70) % 9)
