"""Builds the hand-written CUDA kernels of `csrc/` and loads them with ctypes.

Every `.cu` source is compiled by its own nvcc process for sm_90a, all of
them at once, and the objects are linked into one shared library with a
plain C interface. The build runs at first use, never at import, into
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
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                               "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [(src.name, p.communicate()[0], p.returncode) for src, p in zip(sources(), procs)]
    tmp = out.with_name(f"{tag}.tmp")
    if all(rc == 0 for _, _, rc in logs):
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(("link", res.stdout + res.stderr, res.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(f"== {name}\n{text}" for name, text, _ in logs))
    failed = [(name, text, rc) for name, text, rc in logs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        name, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{text[-4000:]}")
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
    lib.asis_msda_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                  ctypes.POINTER(i), ctypes.POINTER(i), i, p]
    lib.asis_msda_bwd.restype = i
    lib.asis_error_string.argtypes = [i]
    lib.asis_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        msg = lib.asis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
