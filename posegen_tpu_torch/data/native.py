"""ctypes bindings for the native host sampler (port of
posegen_tpu/data/native.py), built from the port's own copy of its source,
`data/csrc/host_sampler.cpp`, whose C ABI is the JAX package's.

The C++ library does the data loader's hot per-image loop (mask scan, pixel
draw, ray construction + pixel gather) in one pass. `get_lib()` compiles it
with g++ at first use into `build/posegen_tpu_torch/` at the repository root,
named by a hash of the source, the flags and the host CPU, so an edited
source (or another CPU) rebuilds. The
flags are the JAX package's (`-march=native` included: the compiler then
contracts the ray products into FMAs the same way in both builds, so both
packages draw bit-equal batches). A failed build raises with the compiler's
output; nothing falls back on its own. The numpy sampler of
`data/h5dataset.py` is the plain version, reached when `get_lib` is
substituted by one that returns None, as the tests do.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from posegen_tpu_torch.utils import hostlib

SRC = Path(__file__).resolve().parent / "csrc" / "host_sampler.cpp"
BUILD_DIR = hostlib.BUILD_DIR
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return hostlib.library_path(SRC, BUILD_DIR, "libposegen_host", CXX_FLAGS)


def build() -> Path:
    """Compile the sampler unless the hashed library exists -> its path."""
    return hostlib.build(SRC, BUILD_DIR, "libposegen_host", CXX_FLAGS, "native sampler")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pg_scan_mask.restype = ctypes.c_int64
    lib.pg_scan_mask.argtypes = [_U8P, ctypes.c_int64, _I64P]
    lib.pg_sample_pixels.restype = ctypes.c_int64
    lib.pg_sample_pixels.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _I64P, _I64P,
    ]
    lib.pg_gather_rays.restype = None
    lib.pg_gather_rays.argtypes = [
        _I64P, ctypes.c_int64, _U8P, _U8P, _U8P, _F32P, _F32P,
        ctypes.c_float, ctypes.c_float,
        _F32P, _F32P, _F32P, _F32P, _F32P,
    ]
    lib.pg_assemble_batch.restype = None
    lib.pg_assemble_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _U64P, _U64P, _U64P, _U64P, _U64P, _I64P,
        _F32P, _F32P, _F32P, _F32P,
        ctypes.c_uint64, _I64P,
        _F32P, _F32P, _F32P, _F32P, _F32P, _I64P,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The sampler's library, built if needed and loaded once; raises when
    it does not build or load."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _ptr(a: Optional[np.ndarray], typ):
    return None if a is None else a.ctypes.data_as(typ)


def _outputs(n: int) -> Dict[str, np.ndarray]:
    return {
        "idx": np.empty(n, np.int64), "rays_o": np.empty((n, 3), np.float32),
        "rays_d": np.empty((n, 3), np.float32), "target_s": np.empty((n, 3), np.float32),
        "fgs": np.empty((n, 1), np.float32), "bgs": np.empty((n, 3), np.float32),
    }


def sample_and_gather(
    smask: np.ndarray,  # (H*W,) uint8 sampling mask
    img: np.ndarray,  # (H*W, 3) uint8
    mask: np.ndarray,  # (H*W,) uint8 fg mask
    pix_dirs: np.ndarray,  # (H*W, 3) f32 pre-focal camera dirs
    c2w: np.ndarray,  # (4, 4) or (3, 4) f32
    fx: float,
    fy: float,
    n_rays: int,
    seed: int,
    bkgd: Optional[np.ndarray] = None,  # (H*W, 3) uint8
) -> Dict[str, np.ndarray]:
    """One image's native sample + gather."""
    lib = get_lib()
    n_pixels = smask.shape[0]
    smask = np.ascontiguousarray(smask, np.uint8)
    img = np.ascontiguousarray(img, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    pix_dirs = np.ascontiguousarray(pix_dirs, np.float32)
    c2w34 = np.ascontiguousarray(np.asarray(c2w, np.float32)[:3, :4])
    bk = None if bkgd is None else np.ascontiguousarray(bkgd, np.uint8)
    scratch = np.empty(n_pixels, np.int64)
    out = _outputs(n_rays)
    lib.pg_sample_pixels(
        _ptr(smask, _U8P), n_pixels, n_rays, np.uint64(seed),
        _ptr(scratch, _I64P), _ptr(out["idx"], _I64P),
    )
    lib.pg_gather_rays(
        _ptr(out["idx"], _I64P), n_rays,
        _ptr(img, _U8P), _ptr(mask, _U8P), _ptr(bk, _U8P),
        _ptr(pix_dirs, _F32P), _ptr(c2w34, _F32P),
        ctypes.c_float(fx), ctypes.c_float(fy),
        _ptr(out["rays_o"], _F32P), _ptr(out["rays_d"], _F32P),
        _ptr(out["target_s"], _F32P), _ptr(out["fgs"], _F32P), _ptr(out["bgs"], _F32P),
    )
    return out


def assemble_batch(
    img_addr: np.ndarray,  # (G,) uint64 per-image base pointers
    mask_addr: np.ndarray,  # (G,) uint64 fg masks
    smask_addr: np.ndarray,  # (G,) uint64 sampling masks
    bkgd_addr: Optional[np.ndarray],  # (G,) uint64 or None
    valid_addr: Optional[np.ndarray],  # (G,) uint64 int32 idx lists or None
    valid_cnt: Optional[np.ndarray],  # (G,) int64
    pix_dirs: np.ndarray,  # (H*W, 3) f32
    c2ws: np.ndarray,  # (G, 12) f32
    fx: np.ndarray,  # (G,) f32
    fy: np.ndarray,  # (G,) f32
    n_pixels: int,
    n_rays: int,
    seed: int,
) -> Dict[str, np.ndarray]:
    """Whole-batch sample + gather over mmapped images. The address arrays
    hold raw base pointers (np.memmap slices); the caller keeps the owning
    buffers alive across the call."""
    lib = get_lib()
    g = int(img_addr.shape[0])
    # every array passed by pointer stays bound to a local across the call
    img_addr = np.ascontiguousarray(img_addr, np.uint64)
    mask_addr = np.ascontiguousarray(mask_addr, np.uint64)
    smask_addr = np.ascontiguousarray(smask_addr, np.uint64)
    bk = None if bkgd_addr is None else np.ascontiguousarray(bkgd_addr, np.uint64)
    va = None if valid_addr is None else np.ascontiguousarray(valid_addr, np.uint64)
    vc = None if valid_cnt is None else np.ascontiguousarray(valid_cnt, np.int64)
    pix_dirs = np.ascontiguousarray(pix_dirs, np.float32)
    c2ws = np.ascontiguousarray(c2ws, np.float32)
    fx = np.ascontiguousarray(fx, np.float32)
    fy = np.ascontiguousarray(fy, np.float32)
    scratch = np.empty(n_pixels, np.int64)
    out = _outputs(g * n_rays)
    lib.pg_assemble_batch(
        g, n_rays, n_pixels,
        _ptr(img_addr, _U64P), _ptr(mask_addr, _U64P), _ptr(smask_addr, _U64P),
        _ptr(bk, _U64P), _ptr(va, _U64P), _ptr(vc, _I64P),
        _ptr(pix_dirs, _F32P), _ptr(c2ws, _F32P), _ptr(fx, _F32P), _ptr(fy, _F32P),
        np.uint64(seed), _ptr(scratch, _I64P),
        _ptr(out["rays_o"], _F32P), _ptr(out["rays_d"], _F32P),
        _ptr(out["target_s"], _F32P), _ptr(out["fgs"], _F32P), _ptr(out["bgs"], _F32P),
        _ptr(out["idx"], _I64P),
    )
    return out
