"""A minimal PNG writer on numpy and the standard library's zlib: 8-bit gray
(H, W) or RGB (H, W, 3), every row with filter 0, no interlace. It writes
image trees where PIL may be missing (the chip smoke test's datasets)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, a: np.ndarray, level: int = 1) -> None:
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    color = 0 if a.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
