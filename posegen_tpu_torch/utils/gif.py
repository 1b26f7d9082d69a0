"""A GIF writer and reader in numpy and the standard library, for the
videos the port writes where imageio is not installed.

`write_gif(path, frames, fps, loop=0)` writes GIF89a: a NETSCAPE2.0
application extension with the loop count, then per frame a graphic
control extension (disposal 0, no transparency, a delay of
int(1000 / fps / 10) centiseconds: imageio v2's `mimwrite(..., fps=)` passes
1000 / fps ms to Pillow, which truncates it to centiseconds) and a
full-frame image with a local colour table of its own, LZW-compressed at
the smallest code size that holds the table (2 to 8 bits), with a clear
code whenever the 4096-entry table fills.

The palette (`quantize`): a frame with at most 256 distinct colours keeps
exactly those colours, sorted by their packed 0xRRGGBB value from the
largest down, so grey frames round-trip exactly (in that order no table is
the grey ramp i -> (i, i, i), which PIL opens in mode L and composes
wrongly once a later frame's table differs). Otherwise median cut over the frame's distinct
colours, weighted by their pixel counts: starting from one box of all
colours, split the box that holds the most pixels (of the boxes with more
than one colour; the first such box on a tie) across the channel of its
widest range, at the pixel-count median of the colours sorted stably along
that channel, until there are 256 boxes. Each box's colour is the
pixel-weighted mean of its colours rounded half to even, and each pixel
takes its box's colour. The result depends on nothing but the frame.

`read_gif(path)` returns (T, H, W, 3) uint8, the frames PIL composes for
the same file converted to RGB (imageio.v2.mimread returns them too, but
as (T, H, W) where PIL opens a grey-ramp palette as mode L). It reads
global and local colour tables, LZW code widths
2 to 12 with clear codes and a full table kept without one, frames on
sub-rectangles of the screen, a transparent index (pixels that keep the
canvas), disposal methods 0 and 1. It raises ValueError naming the file
and the reason for an interlaced frame, disposal method 2 (restore to the
background) or 3 (restore to the previous frame), transparent pixels or an
uncovered screen in the first frame, a frame outside the screen, a
truncated stream or an LZW code that is not in the table.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

MAX_CODES = 4096


def _fail(path, reason: str):
    raise ValueError(f"{path}: cannot read GIF: {reason}")


def gif_delay_cs(fps: float) -> int:
    """The frame delay in centiseconds that imageio v2 writes for `fps`."""
    return int(1000.0 / fps / 10)


def _as_rgb(frames) -> np.ndarray:
    a = np.asarray(frames)
    if a.dtype != np.uint8:
        raise ValueError(f"GIF frames must be uint8, not {a.dtype}")
    if a.ndim == 3:
        a = np.repeat(a[..., None], 3, axis=-1)
    if a.ndim != 4 or a.shape[-1] != 3 or min(a.shape[:3]) < 1:
        raise ValueError(f"GIF frames must be (T, H, W, 3) or (T, H, W), not {a.shape}")
    if max(a.shape[1:3]) > 0xFFFF:
        raise ValueError(f"GIF frames are at most 65535 pixels a side, not {a.shape[1:3]}")
    return a


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (palette (K, 3) uint8 with K <= 256, index (H, W)
    uint8); palette[index] is the frame the GIF holds (module docstring)."""
    f = np.asarray(frame, np.uint8)
    packed = ((f[..., 0].astype(np.int64) << 16) | (f[..., 1].astype(np.int64) << 8)
              | f[..., 2].astype(np.int64)).ravel()
    uniq, inv, counts = np.unique(packed, return_inverse=True, return_counts=True)
    cols = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], -1)
    if len(uniq) <= 256:
        last = len(uniq) - 1
        return cols[::-1].astype(np.uint8), (last - inv).reshape(f.shape[:2]).astype(np.uint8)
    boxes = [np.arange(len(uniq))]
    pixels = [int(counts.sum())]
    while len(boxes) < 256:
        # the box with the most pixels among those that hold two colours or more
        cand = [i for i, b in enumerate(boxes) if len(b) > 1]
        if not cand:
            break
        bi = max(cand, key=lambda i: (pixels[i], -i))
        ids = boxes[bi]
        c = cols[ids]
        ch = int(np.argmax(c.max(0) - c.min(0)))
        order = ids[np.argsort(c[:, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0) + 1, 1, len(order) - 1))
        boxes[bi:bi + 1] = [order[:cut], order[cut:]]
        pixels[bi:bi + 1] = [int(cum[cut - 1]), int(cum[-1] - cum[cut - 1])]
    box_of = np.empty(len(uniq), np.int64)
    palette = np.empty((len(boxes), 3), np.uint8)
    for i, ids in enumerate(boxes):
        box_of[ids] = i
        w = counts[ids].astype(np.float64)
        palette[i] = np.rint((cols[ids] * w[:, None]).sum(0) / w.sum())
    return palette, box_of[inv].reshape(f.shape[:2]).astype(np.uint8)


def quantized_frames(frames) -> np.ndarray:
    """The frames as write_gif stores them: each through `quantize`."""
    out = []
    for f in _as_rgb(frames):
        palette, index = quantize(f)
        out.append(palette[index])
    return np.stack(out)


def _lzw_encode(index: np.ndarray, min_size: int) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    width = min_size + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = index.ravel().tolist()
    table = {}
    next_code = eoi + 1
    emit(clear)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < MAX_CODES:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:  # the table is full: start afresh
            emit(clear)
            table.clear()
            next_code = eoi + 1
            width = min_size + 1
        prefix = k
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def write_gif(path: str, frames, fps: float = 10, loop: int = 0) -> str:
    """Write (T, H, W, 3) or grey (T, H, W) uint8 frames -> path (module
    docstring)."""
    a = _as_rgb(frames)
    _, h, w, _ = a.shape
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    delay = gif_delay_cs(fps)
    for f in a:
        palette, index = quantize(f)
        bits = max(1, int(np.ceil(np.log2(len(palette)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        min_size = max(2, bits)
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1)))
        out.append(table.tobytes())
        out.append(bytes([min_size]) + _sub_blocks(_lzw_encode(index, min_size)))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


def _lzw_decode(path, data: bytes, min_size: int, n_pixels: int) -> bytes:
    if not 2 <= min_size <= 8:
        _fail(path, f"LZW minimum code size {min_size}")
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width = min_size + 1
    out = bytearray()
    prev = None
    acc = nbits = pos = 0
    mask = (1 << width) - 1
    while len(out) < n_pixels:
        while nbits < width:
            if pos >= len(data):
                _fail(path, f"truncated LZW stream ({len(out)} of {n_pixels} pixels)")
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & mask
        acc >>= width
        nbits -= width
        if code == clear:
            table = list(base)
            width = min_size + 1
            mask = (1 << width) - 1
            prev = None
            continue
        if code == eoi:
            _fail(path, f"LZW stream ends at {len(out)} of {n_pixels} pixels")
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < MAX_CODES:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            if len(table) < MAX_CODES:
                table.append(entry)
        else:
            _fail(path, f"LZW code {code} not in the table of {len(table)}")
        out += entry
        prev = entry
        if len(table) == (1 << width) and width < 12:
            width += 1
            mask = (1 << width) - 1
    return bytes(out[:n_pixels])


def read_gif(path: str) -> np.ndarray:
    """-> (T, H, W, 3) uint8 frames as PIL composes them (module docstring)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:6] not in (b"GIF87a", b"GIF89a"):
        _fail(path, "no GIF signature")
    if len(blob) < 13:
        _fail(path, "truncated header")
    w, h, flags, _, _ = struct.unpack("<HHBBB", blob[6:13])
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(blob):
            _fail(path, "truncated global colour table")
        global_table = np.frombuffer(blob[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n

    def sub_blocks(p):
        parts = []
        while True:
            if p >= len(blob):
                _fail(path, f"truncated data sub-blocks at byte {p}")
            n = blob[p]
            if n == 0:
                return b"".join(parts), p + 1
            if p + 1 + n > len(blob):
                _fail(path, f"truncated data sub-block at byte {p}")
            parts.append(blob[p + 1:p + 1 + n])
            p += 1 + n

    canvas = None
    frames = []
    disposal, transparent = 0, None
    while True:
        if pos >= len(blob):
            _fail(path, "truncated: no trailer")
        tag = blob[pos]
        if tag == 0x3B:
            break
        if tag == 0x21:
            if pos + 2 > len(blob):
                _fail(path, "truncated extension")
            label = blob[pos + 1]
            body, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                if len(body) < 4:
                    _fail(path, "short graphic control extension")
                packed = body[0]
                disposal = (packed >> 2) & 7
                transparent = body[3] if packed & 1 else None
            continue
        if tag != 0x2C:
            _fail(path, f"unknown block 0x{tag:02x} at byte {pos}")
        if pos + 10 > len(blob):
            _fail(path, "truncated image descriptor")
        left, top, fw, fh_, iflags = struct.unpack("<HHHHB", blob[pos + 1:pos + 10])
        pos += 10
        table = global_table
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            if pos + n > len(blob):
                _fail(path, "truncated local colour table")
            table = np.frombuffer(blob[pos:pos + n], np.uint8).reshape(-1, 3)
            pos += n
        if table is None:
            _fail(path, f"frame {len(frames)} has no colour table")
        if iflags & 0x40:
            _fail(path, f"frame {len(frames)} is interlaced")
        if disposal in (2, 3):
            what = "the background" if disposal == 2 else "the previous frame"
            _fail(path, f"frame {len(frames)} has disposal method {disposal} "
                        f"(restore to {what})")
        if left + fw > w or top + fh_ > h:
            _fail(path, f"frame {len(frames)} ({left}, {top}, {fw}, {fh_}) lies outside "
                        f"the {w} x {h} screen")
        if pos >= len(blob):
            _fail(path, "truncated image data")
        min_size = blob[pos]
        data, pos = sub_blocks(pos + 1)
        idx = np.frombuffer(_lzw_decode(path, data, min_size, fw * fh_), np.uint8)
        idx = idx.reshape(fh_, fw)
        if int(idx.max(initial=0)) >= len(table):
            _fail(path, f"frame {len(frames)}: colour index {int(idx.max())} past "
                        f"{len(table)} entries")
        rgb = table[idx]
        if canvas is None:
            if (left, top, fw, fh_) != (0, 0, w, h):
                _fail(path, "the first frame does not cover the screen")
            if transparent is not None and (idx == transparent).any():
                _fail(path, "transparent pixels in the first frame")
            canvas = rgb.copy()
        else:
            region = canvas[top:top + fh_, left:left + fw]
            if transparent is None:
                region[...] = rgb
            else:
                keep = idx != transparent
                region[keep] = rgb[keep]
        frames.append(canvas.copy())
        disposal, transparent = 0, None
    if not frames:
        _fail(path, "no frames")
    return np.stack(frames)
