"""Host C++ libraries of the port, built with g++ at first use.

`build(src, build_dir, stem, flags, what)` compiles one source into
`build_dir/<stem>_<hash>.so`, the hash over the source, the flags and, for
flags that tie the library to its CPU (`-march=native`), the host CPU's
model and feature flags, so an edited source, other flags or another CPU
rebuild. Each build writes a temporary file and renames it, so processes
that build at once do not see a partial library. A failed build raises
with the compiler's output; nothing falls back on its own.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "posegen_tpu_torch"


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags: a -march=native build runs
    only on the CPU it was built for, so they name the library too."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"".join(l for l in lines if l.startswith((b"model name", b"flags")))


def library_path(src: Path, build_dir: Path, stem: str, flags: Sequence[str]) -> Path:
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_host_cpu())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path, stem: str, flags: Sequence[str], what: str) -> Path:
    """Compile `src` unless the hashed library exists -> its path; raises
    RuntimeError("<what> build failed ...") with the compiler's output."""
    out = library_path(src, build_dir, stem, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{what} build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
