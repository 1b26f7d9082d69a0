"""posegen_tpu_torch's image readers and resizes against the libraries the JAX
package calls: `utils/jpeg.read_jpeg` against `imageio.v2.imread` (PIL on
libjpeg-turbo) bit for bit, on files PIL and cv2 write here and on the
committed fixtures of tests/data/jpeg (whose manifest the card checks too);
`utils/images.read_image`; `data/imutils.resize_area_u8` against cv2 5.0's
INTER_AREA bit for bit; the flips and `rot_aa` against posegen_tpu's
(cv2.Rodrigues)."""

import hashlib
import io
import json
import os
import struct

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from posegen_tpu.data import imutils as jim
from posegen_tpu_torch.data import imutils as tim
from posegen_tpu_torch.utils import jpeg, png
from posegen_tpu_torch.utils.images import read_image

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = [(1, 1), (17, 33), (250, 333)]


def _img(h, w, seed=0):
    """Smooth content with noise: every block has AC terms, no block clips."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([y * 255 // max(h, 1), x * 255 // max(w, 1), (3 * x + 5 * y) % 256], -1)
    noise = np.random.default_rng(seed).normal(0, 30, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _pil(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


def _cv2(img, **kw) -> bytes:
    params = []
    for k, v in kw.items():
        params += [getattr(cv2, k), v]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _check(tmp_path, data: bytes, name="x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    want = np.asarray(imageio.imread(path))
    got = jpeg.read_jpeg(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("layout", ["444", "422", "420", "440"])
def test_colour_matches_imageio(tmp_path, layout, quality, size):
    img = _img(*size, seed=quality)
    if layout == "440":  # PIL writes no 4:4:0
        data = _cv2(img, IMWRITE_JPEG_QUALITY=quality,
                    IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    else:
        data = _pil(img, quality=quality, subsampling={"444": 0, "422": 1, "420": 2}[layout])
    _check(tmp_path, data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_grey_matches_imageio(tmp_path, writer, size):
    img = _img(*size, seed=7)[..., 0]
    data = _pil(img, quality=90) if writer == "pil" else _cv2(img, IMWRITE_JPEG_QUALITY=90)
    assert _check(tmp_path, data).ndim == 2


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_optimized_huffman_tables(tmp_path, size):
    """PIL's optimize=True writes image-specific Huffman tables (PIL writes
    them to a file; its in-memory buffer is too small for some)."""
    path = tmp_path / "opt.jpg"
    Image.fromarray(_img(*size, seed=3)).save(path, quality=85, optimize=True)
    _check(tmp_path, path.read_bytes())
    cv = _cv2(_img(*size, seed=4), IMWRITE_JPEG_QUALITY=85, IMWRITE_JPEG_OPTIMIZE=1)
    _check(tmp_path, cv)


@pytest.mark.parametrize("case", ["cv2_1", "cv2_3", "cv2_7_420", "pil_blocks_2", "pil_rows_1"])
def test_restart_intervals(tmp_path, case):
    img = _img(71, 53, seed=5)
    data = {
        "cv2_1": lambda: _cv2(img, IMWRITE_JPEG_RST_INTERVAL=1),
        "cv2_3": lambda: _cv2(img, IMWRITE_JPEG_RST_INTERVAL=3),
        "cv2_7_420": lambda: _cv2(img, IMWRITE_JPEG_RST_INTERVAL=7,
                                  IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "pil_blocks_2": lambda: _pil(img, quality=90, restart_marker_blocks=2),
        "pil_rows_1": lambda: _pil(img, quality=90, restart_marker_rows=1),
    }[case]()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0
    _check(tmp_path, data)


def _adobe(transform: int) -> bytes:
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


@pytest.mark.parametrize("case", ["no_marker", "adobe_1", "adobe_0", "adobe_2", "jfif_adobe_0",
                                  "ids_rgb", "keep_rgb", "comment_and_exif"])
def test_colour_space_rules(tmp_path, case):
    """libjpeg's choice of colour space for 3 components: JFIF, then the
    Adobe transform flag, then the component ids ('R', 'G', 'B')."""
    img = _img(20, 30, seed=6)
    data = _pil(img, quality=90)
    seg = struct.unpack(">H", data[4:6])[0]
    app0, rest = data[2:4 + seg], data[4 + seg:]
    if case == "ids_rgb":
        blob = bytearray(data[:2] + rest)
        sof, sos = blob.index(b"\xff\xc0"), blob.index(b"\xff\xda")
        for c in range(3):
            blob[sof + 10 + 3 * c] = blob[sos + 5 + 2 * c] = b"RGB"[c]
        data = bytes(blob)
    elif case == "keep_rgb":
        data = _pil(img, quality=90, keep_rgb=True)
    elif case == "comment_and_exif":
        data = _pil(img, quality=90, comment=b"a comment", exif=b"Exif\x00\x00" + b"\x00" * 20)
    else:
        data = data[:2] + {"no_marker": b"", "adobe_1": _adobe(1), "adobe_0": _adobe(0),
                           "adobe_2": _adobe(2), "jfif_adobe_0": app0 + _adobe(0)}[case] + rest
    _check(tmp_path, data)


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_fixture_set_is_small():
    names = sorted(os.listdir(FIXTURES))
    assert len(names) <= 12
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 1 << 20
    assert sorted(_manifest()) == [n for n in names if n.endswith(".jpg")]


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixture_manifest(name):
    """The manifest's shape and hash are imageio's, and read_jpeg's."""
    path = os.path.join(FIXTURES, name)
    entry = _manifest()[name]
    for a in (np.asarray(imageio.imread(path)), jpeg.read_jpeg(path)):
        assert list(a.shape) == entry["shape"] and a.dtype == np.uint8
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry["sha256"]


def _sof_patched(data: bytes, marker: int = None, precision: int = None) -> bytes:
    blob = bytearray(data)
    i = blob.index(b"\xff\xc0")
    if marker is not None:
        blob[i + 1] = marker
    if precision is not None:
        blob[i + 4] = precision
    return bytes(blob)


@pytest.mark.parametrize("case,reason", [
    ("progressive", "progressive"),
    ("arithmetic", "arithmetic"),
    ("lossless", "lossless"),
    ("twelve_bit", "12-bit"),
    ("cmyk", "4 components"),
    ("s411", "sampling factors 4x1"),
    ("truncated", "truncated"),
    ("no_eoi", "no EOI"),
    ("no_soi", "no SOI"),
    ("png", "no SOI"),
    ("unknown_marker", "unknown marker 0xF5"),
])
def test_refusals_name_the_file(tmp_path, case, reason):
    img = _img(40, 40, seed=8)
    good = _pil(img, quality=80)
    blob = {
        "progressive": lambda: _pil(img, quality=80, progressive=True),
        "arithmetic": lambda: _sof_patched(good, marker=0xC9),
        "lossless": lambda: _sof_patched(good, marker=0xC3),
        "twelve_bit": lambda: _sof_patched(good, precision=12),
        "cmyk": lambda: _cmyk(img),
        "s411": lambda: _cv2(img, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "truncated": lambda: good[:len(good) // 2],
        "no_eoi": lambda: good[:-2],
        "no_soi": lambda: good[2:],
        "png": lambda: cv2.imencode(".png", img)[1].tobytes(),
        "unknown_marker": lambda: good[:2] + b"\xff\xf5\x00\x04ab" + good[2:],
    }[case]()
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=reason) as e:
        jpeg.read_jpeg(str(path))
    assert str(path) in str(e.value)


def _cmyk(img) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(b, format="JPEG")
    return b.getvalue()


def test_read_image_picks_the_decoder_by_signature(tmp_path):
    img = _img(9, 13, seed=9)
    png.write_png(str(tmp_path / "a.jpg"), img)  # a PNG whatever its name says
    (tmp_path / "b.png").write_bytes(_pil(img, quality=90))  # and a JPEG
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.jpg")), img)
    np.testing.assert_array_equal(read_image(str(tmp_path / "b.png")),
                                  np.asarray(imageio.imread(tmp_path / "b.png")))
    (tmp_path / "c.gif").write_bytes(b"GIF89a" + b"\x00" * 20)
    with pytest.raises(ValueError, match="c.gif.*not a PNG or JPEG"):
        read_image(str(tmp_path / "c.gif"))


def test_failed_decoder_build_raises(tmp_path, monkeypatch):
    """No fallback: a build that fails raises with the compiler's output."""
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg.hostlib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "CXX_FLAGS", jpeg.CXX_FLAGS + ("--not-a-compiler-flag",))
    with pytest.raises(RuntimeError, match="JPEG decoder build failed"):
        jpeg.get_lib()


# ---------------------------------------------------------------------------
# cv2's INTER_AREA, and the flips
# ---------------------------------------------------------------------------

AREA_CASES = {
    # integer ratios (cv2's box sums; 2 x 2 on 1, 3, 4 channels its vector rule)
    "int_2x2": [(14, 18, 7, 9), (448, 448, 224, 224), (2, 2, 1, 1), (30, 98, 15, 49)],
    "int_3x3": [(21, 27, 7, 9), (672, 672, 224, 224)],
    "int_2x3": [(21, 18, 7, 9), (3, 4, 1, 2)],
    "int_4x1": [(7, 36, 7, 9)],
    # other downscales (the area table in float32)
    "fractional": [(256, 256, 224, 224), (1080, 1920, 224, 224), (48, 48, 32, 32),
                   (97, 61, 13, 60), (5, 7, 3, 4)],
    # an upscale on either axis (the two-tap pass with cv2's area taps)
    "upscale": [(48, 48, 64, 64), (1, 1, 5, 3), (13, 17, 224, 224), (7, 9, 14, 18)],
    "mixed": [(64, 20, 32, 40), (20, 64, 40, 32), (224, 100, 224, 224)],
}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(AREA_CASES))
def test_resize_area_u8_is_cv2s(kind, channels):
    rng = np.random.default_rng(len(kind) * 10 + channels)
    for H, W, h, w in AREA_CASES[kind]:
        img = rng.integers(0, 256, (H, W, channels), dtype=np.uint8)
        if channels == 1:
            img = img[..., 0]
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        got = tim.resize_area_u8(img, (w, h))
        assert got.shape == want.shape == (h, w) + img.shape[2:], (H, W, h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{(H, W)} -> {(h, w)}")


def test_resize_area_u8_same_size_and_refusals():
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    out = tim.resize_area_u8(img, (4, 2))
    assert np.array_equal(out, img) and out is not img
    with pytest.raises(ValueError, match="uint8"):
        tim.resize_area_u8(img.astype(np.float32), (2, 1))
    with pytest.raises(ValueError):
        tim.resize_area_u8(img, (0, 3))


def test_flips_match_jax():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tim.flip_img(img), jim.flip_img(img))
    kp = rng.standard_normal((2, 24, 3)).astype(np.float32)
    for width in (None, 224.0):
        np.testing.assert_array_equal(tim.flip_kp(kp, width=width), jim.flip_kp(kp, width=width))
    for shape in ((72,), (3, 72)):
        pose = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(tim.flip_pose(pose), jim.flip_pose(pose))
    assert tim.SMPL_JOINT_FLIP_PERM == jim.SMPL_JOINT_FLIP_PERM


def test_rot_aa_matches_cv2_rodrigues():
    """rot_aa against the JAX package's (cv2.Rodrigues both ways), with the
    zero rotation and the near-pi branch among the cases."""
    rng = np.random.default_rng(12)
    cases = [np.zeros(3), np.array([np.pi, 0, 0]), np.array([0, 0, np.pi - 1e-7]),
             np.array([0.0, 1e-9, 0.0])]
    cases += [rng.standard_normal(3) * s for s in (0.1, 1.0, 3.0) for _ in range(20)]
    for k, aa in enumerate(cases):
        aa = aa.astype(np.float32)
        rot = float(rng.uniform(-180, 180)) if k % 5 else 180.0
        got, want = tim.rot_aa(aa, rot), jim.rot_aa(aa, rot)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{aa} {rot}")


def test_corrupt_streams_raise(tmp_path):
    """Corrupt tables and data raise ValueError (no read past a table):
    an over-subscribed Huffman table, a zeroed scan, a restart marker out of
    order, a scan before the frame header."""
    img = _img(33, 47, seed=13)
    good = _cv2(img, IMWRITE_JPEG_RST_INTERVAL=1)
    dht = good.index(b"\xff\xc4")
    oversub = bytearray(good)
    oversub[dht + 5] = 5  # five codes of length 1
    sos = good.index(b"\xff\xda")
    seg = struct.unpack(">H", good[sos + 2:sos + 4])[0]
    start = sos + 2 + seg
    zeroed = good[:start] + b"\xff" * 64 + good[start + 64:]
    rst0 = good.index(b"\xff\xd0", start)
    swapped = good[:rst0 + 1] + b"\xd3" + good[rst0 + 2:]
    early = good[:2] + good[sos:]
    for name, blob, reason in [("oversub", bytes(oversub), "over-subscribed"),
                               ("zeroed", zeroed, "Huffman|marker|truncated|restart"),
                               ("swapped", swapped, "RST0 missing"),
                               ("early", early, "scan before the frame header")]:
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=reason):
            jpeg.read_jpeg(str(path))
