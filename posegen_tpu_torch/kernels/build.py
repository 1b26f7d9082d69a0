"""Build and bind the CUDA kernels: nvcc into a shared library with a plain C
interface, loaded with ctypes.

The library is built from this package's `csrc/` sources at first CUDA use
into `build/posegen_tpu_torch/` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Each source compiles in its own nvcc process, all started
together, and one link joins the objects. Nothing here runs at import: the
module imports on a host without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "posegen_tpu_torch"
SOURCES = ("field.cu", "field_grad.cu", "field_variants.cu")
HEADERS = ("field.cuh", "field_eval.cuh", "sm90.cuh", "sm90_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
# the build's seconds (None when the library was cached) and ptxas' report,
# which is kept beside the library
BUILD_LOG = {"seconds": None, "ptxas": ""}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the posegen_tpu_torch kernels build from source")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libposegen_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the hashed library exists -> its path."""
    out = library_path()
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        BUILD_LOG["ptxas"] = report.read_text() if report.exists() else ""
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    ptxas = "".join(err for _, err in outs)
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{so}{se}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}"
        )
    report.write_text(ptxas)
    os.replace(tmp, out)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = ptxas
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, declare the C signatures."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    IA = ctypes.POINTER(ctypes.c_int)
    LL = ctypes.c_longlong
    lib.posegen_field.argtypes = [P, P, I, I, P, IA, I, P, P, P, I, P, LL, P]
    lib.posegen_field.restype = I
    lib.posegen_dual.argtypes = [P, P, I, I, P, IA, I, P, P, P, P, P, P, P, LL, P]
    lib.posegen_dual.restype = I
    lib.posegen_field_grouped.argtypes = [P, P, I, I, P, I, I, IA, I, P, P, P, I, I, P, I, P,
                                          LL, P]
    lib.posegen_field_grouped.restype = I
    lib.posegen_field_ray_ladder.argtypes = [P, P, I, I, P, IA, I, P, P, P, P, LL, P, LL, P]
    lib.posegen_field_ray_ladder.restype = I
    for name in ("posegen_field_eval_smem", "posegen_field_eval_slot_bytes",
                 "posegen_field_stash_smem"):
        getattr(lib, name).argtypes = [IA, I]
        getattr(lib, name).restype = LL
    lib.posegen_field_eval_grid.argtypes = [I, I]
    lib.posegen_field_eval_grid.restype = I
    lib.posegen_field_stash.argtypes = [P, P, I, I, P, I, I, IA, I, P, P, P, I, I, P, P, P, P]
    lib.posegen_field_stash.restype = I
    lib.posegen_field_bwd_workspace.argtypes = [I, IA, I, I, I, I,
                                                ctypes.POINTER(ctypes.c_longlong)]
    lib.posegen_field_bwd_workspace.restype = ctypes.c_longlong
    lib.posegen_field_bwd.argtypes = [I, IA, I, P, P, P, I, I, P, P, P, P, ctypes.c_longlong,
                                      P, P, P, P, P, I, P, I, I, P, P, P, P]
    lib.posegen_field_bwd.restype = I
    lib.posegen_field_bwd_splits.argtypes = [I, IA]
    lib.posegen_field_bwd_splits.restype = I
    for name in ("posegen_field_bwd_smem", "posegen_field_bwd_input_smem"):
        getattr(lib, name).argtypes = [IA, I]
        getattr(lib, name).restype = LL
    lib.posegen_field_variant.argtypes = [P, P, I, P, I, I, IA, I, P, P, P, I, I, I, I, I, P,
                                          LL, P]
    lib.posegen_field_variant.restype = I
    lib.posegen_error_string.argtypes = [I]
    lib.posegen_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def ptxas_report() -> Dict[str, Tuple[int, int, int]]:
    """The loaded build's ptxas -v report -> {mangled kernel: (registers,
    spill store bytes, spill load bytes)}."""
    out: Dict[str, list] = {}
    cur = None
    for line in BUILD_LOG["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.posegen_error_string(rc).decode()
        raise RuntimeError(f"posegen_tpu_torch {name} kernel launch failed: {msg} ({rc})")
