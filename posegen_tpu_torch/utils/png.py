"""A PNG reader and writer in numpy and the standard library (`zlib`), for
the images the port reads and writes where neither imageio nor PIL is
installed.

`read_png` reads non-interlaced PNGs of bit depth 8 or 16 in every colour
type (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA), every row filter
(0 none, 1 sub, 2 up, 3 average, 4 Paeth) with the spec's wrapping uint8
arithmetic, and image data split over any number of IDAT chunks; it checks
every chunk's CRC. It returns what imageio's PIL plugin returns for the
same file: (H, W) for gray, (H, W, 2) gray + alpha, (H, W, 3) RGB, (H, W, 4)
RGBA, uint8 or uint16; a palette image becomes RGB, its tRNS chunk
ignored, as that plugin ignores it. Anything else raises ValueError naming
the file and the reason: Adam7 interlace, bit depths 1, 2 and 4, a bad
CRC, a truncated file, a missing IEND, an unknown critical chunk, a file
that is not a PNG (a JPEG, for one).

`write_png` writes uint8 gray, gray + alpha, RGB or RGBA: non-interlaced,
filter 0 on every row, the zlib stream split into IDAT chunks of
IDAT_BYTES.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
IDAT_BYTES = 1 << 16  # the writer's IDAT chunk size
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type, for the writer


def _fail(path, reason: str):
    raise ValueError(f"{path}: cannot read PNG: {reason}")


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, compress_level: int = 6) -> str:
    """Write a uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4)
    image -> path."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"{path}: write_png takes uint8 images, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"{path}: write_png takes (H, W[, 1-4]) images, not {a.shape}")
    h, w, c = a.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type 0 on every row
    rows[:, 1:] = a.reshape(h, w * c)
    data = zlib.compress(rows.tobytes(), compress_level)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))]
    out += [_chunk(b"IDAT", data[i:i + IDAT_BYTES]) for i in range(0, len(data), IDAT_BYTES)]
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(path, raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < h * (stride + 1):
        _fail(path, f"{len(raw)} bytes of image data, {h * (stride + 1)} expected")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = cur
        elif ftype == 1:  # sub: a running sum per byte of the pixel, mod 256
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint64)
            lanes[:stride] = cur
            out[y] = (np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)[:stride]
                      & 0xFF).astype(np.uint8)
        elif ftype == 2:
            out[y] = cur + prior  # uint8 arithmetic wraps
        elif ftype in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            _fail(path, f"row {y} has filter type {ftype}")
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """-> the image as imageio reads it (see the module docstring)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        kind = "a JPEG file" if blob[:3] == b"\xff\xd8\xff" else "no PNG signature"
        _fail(path, kind)
    pos, ihdr, plte, idat, ended = len(SIGNATURE), None, None, [], False
    while pos < len(blob):
        if pos + 12 > len(blob):
            _fail(path, f"truncated chunk header at byte {pos}")
        (n,), tag = struct.unpack(">I", blob[pos:pos + 4]), blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(blob):
            _fail(path, f"truncated {tag!r} chunk")
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            _fail(path, f"bad CRC in the {tag!r} chunk at byte {pos}")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            ended = True
            break
        elif tag[0] & 0x20 == 0:  # an uppercase first letter: critical
            _fail(path, f"unknown critical chunk {tag!r}")
    if not ended:
        _fail(path, "no IEND chunk")
    if ihdr is None:
        _fail(path, "no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS:
        _fail(path, f"colour type {ctype}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        _fail(path, f"bit depth {depth} (8 and 16 are read)")
    if comp != 0 or filt != 0:
        _fail(path, f"compression method {comp}, filter method {filt}")
    if interlace != 0:
        _fail(path, "Adam7 interlace")
    if not idat:
        _fail(path, "no IDAT chunk")
    if ctype == 3 and plte is None:
        _fail(path, "a palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        _fail(path, f"image data: {e}")
    ch, nbytes = _CHANNELS[ctype], depth // 8
    rows = _unfilter(path, raw, h, w * ch * nbytes, ch * nbytes)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    if ctype == 3:
        idx = img[..., 0]
        if int(idx.max()) >= len(plte):
            _fail(path, f"palette index {int(idx.max())} past {len(plte)} entries")
        return plte[idx]
    return img[..., 0] if ch == 1 else img
