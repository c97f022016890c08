"""Builds the hand-written CUDA kernels of `csrc/` and loads them with ctypes.

All `.cu` sources are compiled by nvcc for sm_90a into one shared library
with a plain C interface. The build runs at first use, never at import, into
`build/kernels/` at the repository root, under a name derived from a hash of
the sources, so a changed source is rebuilt and an unchanged one is reused.
The compiler's report (`-Xptxas -v`: registers, shared memory, spills) is
kept beside the library as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libadaptersis_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists (or
    always, with `force`)."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asis_flash_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, p]
    lib.asis_flash_fwd.restype = i
    lib.asis_msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                  ctypes.POINTER(i), ctypes.POINTER(i), i, p]
    lib.asis_msda_fwd.restype = i
    lib.asis_error_string.argtypes = [i]
    lib.asis_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        msg = lib.asis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
