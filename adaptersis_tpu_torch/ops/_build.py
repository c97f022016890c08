"""Builds the hand-written CUDA kernels of `csrc/` and loads them with ctypes;
the conventions every kernel wrapper shares: launch-error and forward-only
checks, the argument checks and parameter views of the row kernels and
GEMMs, the current stream, and running a plain version outside autocast.

Every `.cu` source is compiled by its own nvcc process for sm_90a, all of
them at once, and the objects are linked into one shared library with a
plain C interface. The build runs at first use, never at import, into
`build/kernels/` at the repository root, under a name derived from a hash of
the sources and the headers they share (`*.cuh`), so a changed file is
rebuilt and an unchanged set is reused.
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
from typing import Iterable, List, Tuple

import torch

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
    """The library's path, named by a hash of every source and header."""
    h = hashlib.sha256()
    for src in sorted([*sources(), *CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
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
    lib.asis_layernorm.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, i, p]
    lib.asis_layernorm.restype = i
    lib.asis_row_stats.argtypes = [p, p, i, i, ctypes.c_float, i, p]
    lib.asis_row_stats.restype = i
    lib.asis_ln_gemm.argtypes = [i, p, p, p, p, p, p, i, i, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.asis_ln_gemm.restype = i
    lib.asis_error_string.argtypes = [i]
    lib.asis_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        msg = lib.asis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def forbid_grad(name: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise where a forward-only kernel would cut a gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() "
                           "(the backbone walks are frozen) or on tensors that need no grad")


def stream() -> int:
    """The current CUDA stream, as the launchers take it."""
    return torch.cuda.current_stream().cuda_stream


def plain(fn):
    """Run a plain version outside autocast: its products are fp32 matmuls of
    operands already rounded to the kernel's input dtype."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kw):
        with torch.autocast(x.device.type, enabled=False):
            return fn(x, *args, **kw)
    return wrapper


def check_rows(name: str, x: torch.Tensor) -> None:
    """What the row kernels and the GEMMs take as x: a CUDA tensor, bf16 or
    fp32, contiguous, 16-byte aligned, with a last axis a multiple of 64."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype must be bf16 or fp32, got {x.dtype}")
    if x.shape[-1] % 64:
        raise ValueError(f"{name}: the feature width must be a multiple of 64, got {x.shape[-1]}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")


def _on(t: torch.Tensor, shape, name: str, x: torch.Tensor) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != x.device:
        raise ValueError(f"{name}: expected shape {tuple(shape)} on {x.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach()


def params(name: str, x: torch.Tensor,
           *specs: Tuple[str, torch.Tensor, int]) -> Tuple[List[torch.Tensor], int]:
    """(n,) parameters (LayerNorm scale and shift, biases, LayerScale), given
    as (label, tensor, n), as the kernels read them: on x's card, contiguous,
    16-byte aligned, all bf16 or all fp32. They are read as stored, so a
    frozen bf16 backbone's cost no cast; a set of mixed dtypes is cast to
    fp32. Returns them and 1 if they are bf16, else 0."""
    ts = [_on(t, (n,), f"{name} {label}", x) for label, t, n in specs]
    if len({t.dtype for t in ts}) > 1 or ts[0].dtype not in (torch.bfloat16, torch.float32):
        ts = [t.float() for t in ts]
    ts = [t.contiguous() for t in ts]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the parameters must be 16-byte aligned")
    return ts, int(ts[0].dtype == torch.bfloat16)


def mat(t: torch.Tensor, shape, name: str, x: torch.Tensor) -> torch.Tensor:
    """A Linear weight as the GEMMs read it: (N, K) contiguous in x's dtype,
    16-byte aligned, on x's card."""
    t = _on(t, shape, name, x).to(x.dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the weight must be 16-byte aligned")
    return t
