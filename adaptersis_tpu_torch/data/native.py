"""ctypes bindings of the native image decode and resize
(`adaptersis_tpu_torch/runtime/image_io.cc`): libpng/libjpeg decode and
Pillow's BILINEAR and NEAREST resizes, bit for bit, with a thread pool for
whole batches.

The library is built with g++ at first use, never at import, into
`build/native/` at the repository root, under a name derived from a hash of
the source. Where it cannot be built (no g++, or no libpng/libjpeg headers)
`available()` is false and the datasets read through PIL, which gives the
same bits. `decoder()` names the path that reads the files.

    native.available()                       -> bool
    native.decoder()                         -> "native" | "pil" | "none"
    native.load_image(path, (H, W), "rgb")   -> uint8 (H, W, 3), or None
    native.load_batch(paths, (H, W))         -> uint8 (N, H, W, 3), or None
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "runtime" / "image_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDLIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return BUILD_DIR / f"libasn_io_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """g++ into a name of this process's own, then an atomic rename: builds
    racing in several processes each leave a whole library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(res.stderr.strip()[-2000:])
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        lib.asn_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.asn_decode_resize.restype = ctypes.c_int
        lib.asn_batch_load.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.asn_batch_load.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """"native" where the library builds, else "pil" where PIL is installed,
    else "none" (nothing can decode the datasets)."""
    if available():
        return "native"
    return "pil" if importlib.util.find_spec("PIL") is not None else "none"


def load_image(path: str, size: Tuple[int, int], mode: str = "rgb",
               resample: str = "bilinear") -> Optional[np.ndarray]:
    """Decode one file and resize it to size = (H, W). "gray" returns the
    stored values of a ≤ 8-bit gray or palette PNG (a label mask) and
    refuses any other format. None when the library is missing or the file
    is refused: the caller reads it with PIL."""
    lib = _load()
    if lib is None:
        return None
    c = 3 if mode == "rgb" else 1
    h, w = size
    out = np.empty((h, w, c), np.uint8)
    rc = lib.asn_decode_resize(str(path).encode(), h, w, c, int(resample == "bilinear"),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out[:, :, 0] if c == 1 else out


def load_batch(paths: Sequence[str], size: Tuple[int, int], mode: str = "rgb",
               resample: str = "bilinear", n_threads: int = 8) -> Optional[np.ndarray]:
    """`load_image` of every path into one (N, H, W, C) array, on n_threads
    native threads; None if any file fails."""
    lib = _load()
    if lib is None:
        return None
    c = 3 if mode == "rgb" else 1
    h, w = size
    n = len(paths)
    out = np.empty((n, h, w, c), np.uint8)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.asn_batch_load(arr, n, h, w, c, int(resample == "bilinear"),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return None if failures else out
