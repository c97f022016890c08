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
    lib.asis_flash_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i,
                                   ctypes.POINTER(i), p]
    lib.asis_flash_fwd.restype = i
    lib.asis_flash_attn_fwd.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float, i,
                                                  ctypes.POINTER(i), p]
    lib.asis_flash_attn_fwd.restype = i
    lib.asis_flash_attn_bwd.argtypes = [p] * 11 + [i, i, i, i, ctypes.c_float, i,
                                                   ctypes.POINTER(i), p]
    lib.asis_flash_attn_bwd.restype = i
    lib.asis_msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                  ctypes.POINTER(i), ctypes.POINTER(i), i, p]
    lib.asis_msda_fwd.restype = i
    lib.asis_msda_bwd.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_size_t, i, i, i, i, i, i, i,
                                  ctypes.POINTER(i), ctypes.POINTER(i), i, p]
    lib.asis_msda_bwd.restype = i
    lib.asis_msda_bwd_workspace.argtypes = [i] * 7
    lib.asis_msda_bwd_workspace.restype = ctypes.c_size_t
    lib.asis_layernorm.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, i, p]
    lib.asis_layernorm.restype = i
    lib.asis_ln_gemm.argtypes = [i, p, p, p, i, i, i, p, p, p, p, p, i, i, i, i, i, p, p]
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


def launch(t: torch.Tensor, fn, *args) -> int:
    """Call the launcher `fn(*args, stream)` on t's card and return its
    error code. The stream is the raw handle of that card's current stream
    (no `torch.cuda.Stream` is built; under CUDA graph capture, the
    capturing stream); a device guard is entered only when t's card is not
    the current one, never on a one-card host."""
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def plain(fn):
    """Run a plain version outside autocast: its products are fp32 matmuls of
    operands already rounded to the kernel's input dtype."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kw):
        with torch.autocast(x.device.type, enabled=False):
            return fn(x, *args, **kw)
    return wrapper


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_rows(name: str, x: torch.Tensor) -> None:
    """What the row kernels and the GEMMs take as x: bf16 or fp32, a last
    axis that is a multiple of 64 and at most 4096 (bf16) or 2048 (fp32)
    wide (a row of the statistics pass fits a warp's registers),
    contiguous, 16-byte aligned, on a CUDA card."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype must be bf16 or fp32, got {x.dtype}")
    C = x.shape[-1]
    if C % 64 or C * x.element_size() > 8192:
        raise ValueError(f"{name}: the feature width must be a multiple of 64 and at most "
                         f"4096 (bf16) or 2048 (fp32), got {C} in {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")


def params(name: str, x: torch.Tensor,
           *specs: Tuple[str, torch.Tensor, int]) -> Tuple[List[torch.Tensor], int]:
    """(n,) parameters (LayerNorm scale and shift, biases, LayerScale), given
    as (label, tensor, n), as the kernels read them: on x's device,
    contiguous, 16-byte aligned, all bf16 or all fp32. They are read in
    place when they already are, so a frozen bf16 backbone's cost no cast
    and no copy; a set of mixed dtypes is cast to fp32. Returns them and 1
    if they are bf16, else 0."""
    index = x.get_device()  # a card's index, or −1 off the cards (then compare devices)
    dtype = specs[0][1].dtype
    in_place = dtype in _KERNEL_DTYPES
    for label, t, n in specs:
        if t.shape != (n,) or t.get_device() != index or (index < 0 and t.device != x.device):
            raise ValueError(f"{name} {label}: expected shape ({n},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        in_place = in_place and t.dtype == dtype and t.is_contiguous() and not t.data_ptr() % 16
    if in_place:
        return [t for _, t, _ in specs], int(dtype == torch.bfloat16)
    cast = dtype not in _KERNEL_DTYPES or any(t.dtype != dtype for _, t, _ in specs)
    ts = [(t.float() if cast else t).contiguous() for _, t, _ in specs]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the parameters must be 16-byte aligned")
    return ts, int(ts[0].dtype == torch.bfloat16)


def gemm_workspace(x: torch.Tensor, n: int):
    """The fp32 GEMMs' scratch for the tf32 halves of an n-element weight
    (`csrc/ln_gemm.cu`: 2·n fp32 on x's card), or None in bf16."""
    if x.dtype == torch.bfloat16:
        return None
    return torch.empty(2 * n, dtype=torch.float32, device=x.device)


def mat(t: torch.Tensor, shape, name: str, x: torch.Tensor) -> torch.Tensor:
    """A Linear weight as the GEMMs read it: (N, K) contiguous in x's dtype,
    16-byte aligned, on x's device (read in place when it already is)."""
    if t.shape != tuple(shape) or t.device != x.device:
        raise ValueError(f"{name}: expected shape {tuple(shape)} on {x.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    t = t.to(x.dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the weight must be 16-byte aligned")
    return t
