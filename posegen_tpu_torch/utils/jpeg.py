"""A baseline JPEG reader of the port's own (the card's machine promises
neither imageio nor PIL nor cv2): `utils/csrc/jpeg_decode.cpp`, a C ABI
bound with ctypes, built with g++ at first use into `build/posegen_tpu_torch/`
(`utils/hostlib.py`; a failed build raises with the compiler's output).

`read_jpeg(path)` returns what `imageio.v2.imread` returns for the same file
through PIL on libjpeg-turbo with its defaults, bit for bit: (H, W, 3)
uint8 for colour, (H, W) for grey, the EXIF orientation ignored as imageio
ignores it. It reads SOF0 / SOF1 frames of 8-bit samples with 1 or 3
components and sampling factors of 1 or 2 on each axis, any DQT / DHT
tables (the optimised ones too), restart intervals, and skips APP / COM
segments, reading JFIF and the Adobe transform flag for the colour space.
The decoder computes libjpeg-turbo's islow IDCT, its fancy upsampling and
its YCbCr -> RGB tables (the source's header says how). Anything else
raises ValueError naming the file and the reason: progressive, arithmetic,
lossless or hierarchical frames, 12-bit samples, 4 components, other
sampling factors, a truncated stream, a missing SOI or EOI, an unknown
marker where a segment is due.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from posegen_tpu_torch.utils import hostlib

SRC = Path(__file__).resolve().parent / "csrc" / "jpeg_decode.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SIGNATURE = b"\xff\xd8\xff"
_ERR_BYTES = 512
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the decoder unless the hashed library exists -> its path."""
    return hostlib.build(SRC, hostlib.BUILD_DIR, "libposegen_jpeg", CXX_FLAGS, "JPEG decoder")


def get_lib() -> ctypes.CDLL:
    """The decoder's library, built if needed and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.pg_jpeg_info.restype = ctypes.c_int
        lib.pg_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p, i32p,
                                     ctypes.c_char_p, ctypes.c_int]
        lib.pg_jpeg_decode.restype = ctypes.c_int
        lib.pg_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def read_jpeg(path: str) -> np.ndarray:
    """Read a baseline JPEG -> (H, W, 3) or (H, W) uint8."""
    data = Path(path).read_bytes()
    lib = get_lib()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.pg_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                        err, _ERR_BYTES):
        raise ValueError(f"{path}: cannot read JPEG: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value) + ((3,) if c.value == 3 else ()), np.uint8)
    if lib.pg_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.nbytes, err, _ERR_BYTES):
        raise ValueError(f"{path}: cannot read JPEG: {err.value.decode(errors='replace')}")
    return out
