"""The port's PNG codec (posegen_tpu_torch/utils/png.py) against imageio and
PIL: its files read back bit-equal in imageio; imageio's and PIL's files at
every compress level, and hand-built files with each row filter, 16-bit
samples, a palette with tRNS, gray + alpha and many IDAT chunks, read
bit-equal by the port; what it does not read raises ValueError naming the
file."""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from posegen_tpu_torch.utils import png


def _img(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    # smooth ramps + noise, so that the adaptive filters pick every type
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    if len(shape) == 3:
        ramp = ramp[..., None]
    return ((ramp + rng.integers(0, hi, shape) * (rng.random(shape) < 0.3)) % hi).astype(dtype)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(raw: np.ndarray, bpp: int, ftypes) -> bytes:
    """(h, stride) uint8 rows -> the filtered stream, row y by ftypes[y % len]."""
    out = []
    prior = np.zeros(raw.shape[1], np.int64)
    for y, row in enumerate(raw.astype(np.int64)):
        t = ftypes[y % len(ftypes)]
        f = np.empty_like(row)
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[t]
            f[i] = (row[i] - pred) % 256
        out.append(bytes([t]) + f.astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _build(w, h, depth, ctype, stream: bytes, extra=(), n_idat=1, interlace=0,
           iend=True) -> bytes:
    data = zlib.compress(stream, 9)
    step = -(-len(data) // n_idat)
    parts = [png.SIGNATURE, png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, interlace))]
    parts += [png._chunk(tag, d) for tag, d in extra]
    parts += [png._chunk(b"IDAT", data[i:i + step]) for i in range(0, len(data), step)]
    if iend:
        parts.append(png._chunk(b"IEND", b""))
    return b"".join(parts)


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 2), (17, 23, 3), (9, 31, 4), (1, 1, 3)])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_port_file_reads_back_in_imageio(tmp_path, shape, level):
    img = _img(shape)
    path = png.write_png(str(tmp_path / "a.png"), img, compress_level=level)
    got = imageio.imread(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    assert np.array_equal(png.read_png(path), img)


@pytest.mark.parametrize("writer", ["imageio", "pil"])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", [(40, 37, 3), (33, 20, 4), (21, 18), (15, 16, 2)])
def test_imageio_and_pil_files_read_bit_equal(tmp_path, writer, level, shape):
    img = _img(shape, seed=level)
    path = str(tmp_path / "b.png")
    if writer == "imageio":
        imageio.imwrite(path, img, compress_level=level)
    else:
        mode = {(2,): "L", (3, 2): "LA", (3, 3): "RGB", (3, 4): "RGBA"}[
            (img.ndim,) if img.ndim == 2 else (img.ndim, img.shape[-1])]
        Image.fromarray(img, mode).save(path, compress_level=level)
    got = png.read_png(path)
    want = imageio.imread(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, img)


@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 2, 0)])
@pytest.mark.parametrize("ctype,bpp_ch", [(2, 3), (6, 4), (0, 1)])
def test_each_row_filter(tmp_path, ftypes, ctype, bpp_ch):
    shape = (11, 13, bpp_ch) if bpp_ch > 1 else (11, 13)
    img = _img(shape, seed=len(ftypes))
    stream = _filter_rows(img.reshape(11, -1), bpp_ch, ftypes)
    path = tmp_path / "f.png"
    path.write_bytes(_build(13, 11, 8, ctype, stream, n_idat=3))
    assert np.array_equal(png.read_png(str(path)), img)
    assert np.array_equal(imageio.imread(str(path)), img)


@pytest.mark.parametrize("ctype,ch", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_sixteen_bit(tmp_path, ctype, ch):
    shape = (7, 9, ch) if ch > 1 else (7, 9)
    img = _img(shape, np.uint16, seed=ch)
    raw = img.astype(">u2").reshape(7, -1).view(np.uint8)
    path = tmp_path / "s.png"
    path.write_bytes(_build(9, 7, 16, ctype, _filter_rows(raw, 2 * ch, (4, 1, 3, 2)),
                            n_idat=5))
    got = png.read_png(str(path))
    assert got.dtype == np.uint16 and np.array_equal(got, img)


@pytest.mark.parametrize("with_trns", [False, True])
def test_palette(tmp_path, with_trns):
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    idx = rng.integers(0, 7, (10, 12), dtype=np.uint8)
    extra = [(b"PLTE", pal.tobytes())]
    if with_trns:
        extra.append((b"tRNS", bytes([0, 128, 255, 7])))  # shorter than the palette
    extra.append((b"tEXt", b"Comment\x00ancillary chunks are skipped"))
    path = tmp_path / "p.png"
    path.write_bytes(_build(12, 10, 8, 3, _filter_rows(idx, 1, (1, 4)), extra=extra, n_idat=4))
    got = png.read_png(str(path))
    want = imageio.imread(str(path))
    # imageio's PIL plugin converts to the palette's mode, RGB: tRNS is dropped
    assert got.shape == want.shape == (10, 12, 3)
    assert np.array_equal(got, want) and np.array_equal(got, pal[idx])


def test_many_idat_chunks(tmp_path, monkeypatch):
    monkeypatch.setattr(png, "IDAT_BYTES", 7)
    img = _img((30, 30, 3))
    path = png.write_png(str(tmp_path / "m.png"), img, compress_level=9)
    blob = open(path, "rb").read()
    assert blob.count(b"IDAT") > 20
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(imageio.imread(path), img)


def _bad_crc(blob):
    i = blob.index(b"IDAT") + 4
    return blob[:i] + bytes([blob[i] ^ 1]) + blob[i + 1:]


def _unknown_critical(blob):
    i = blob.index(b"IDAT") - 4
    return blob[:i] + png._chunk(b"ZZZZ", b"x") + blob[i:]


@pytest.mark.parametrize("case,reason", [
    ("adam7", "Adam7 interlace"),
    ("depth1", "bit depth 1"),
    ("depth2", "bit depth 2"),
    ("depth4", "bit depth 4"),
    ("crc", "bad CRC"),
    ("no_iend", "no IEND"),
    ("critical", "unknown critical chunk"),
    ("jpeg", "a JPEG file"),
])
def test_refusals_name_the_file(tmp_path, case, reason):
    img = _img((6, 8))
    good = _build(8, 6, 8, 0, _filter_rows(img, 1, (0,)))
    blob = {
        "adam7": lambda: _build(8, 6, 8, 0, b"\x00" * 54, interlace=1),
        "depth1": lambda: _build(8, 6, 1, 0, b"\x00\x00" * 6),
        "depth2": lambda: _build(8, 6, 2, 0, b"\x00\x00\x00" * 6),
        "depth4": lambda: _build(8, 6, 4, 3, b"\x00" * 5 * 6, extra=[(b"PLTE", b"\x00" * 6)]),
        "crc": lambda: _bad_crc(good),
        "no_iend": lambda: _build(8, 6, 8, 0, _filter_rows(img, 1, (0,)), iend=False),
        "critical": lambda: _unknown_critical(good),
        "jpeg": lambda: b"\xff\xd8\xff\xe0" + b"\x00" * 40,
    }[case]()
    path = tmp_path / f"{case}.png"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=reason) as e:
        png.read_png(str(path))
    assert str(path) in str(e.value)


def test_writer_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "x.png"), np.zeros((2, 2), np.float32))
