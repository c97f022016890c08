"""Multi-scale deformable attention core: the counterpart of the JAX
package's `ops/msda_pallas.py`.

`msda_fwd` launches the hand-written CUDA kernel (`csrc/msda_fwd.cu`) on a
CUDA tensor and runs `msda_plain` on a CPU tensor. Both take value
(B, S, M, D), sampling locations (B, Lq, M, L, P, 2) in [0, 1] (points
outside contribute zero), attention weights (B, Lq, M, L, P) and the static
level shapes, and return (B, Lq, M·D) in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def msda_plain(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Gather form of the JAX `_msda_core_impl`: the four bilinear corners of
    every point gathered at once per level, in fp32."""
    B, S, M, D = value.shape
    Lq, P = loc.shape[1], loc.shape[4]
    v = value.float().permute(0, 2, 1, 3)              # (B, M, S, D)
    out = value.new_zeros((B, M, Lq, D), dtype=torch.float32)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + H * W]
        xy = loc[:, :, :, lvl].float()                 # (B, Lq, M, P, 2)
        a = aw[:, :, :, lvl].float()                   # (B, Lq, M, P)
        x = xy[..., 0] * W - 0.5
        y = xy[..., 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        idx, cw = [], []
        for xi, yi, w in ((x0i, y0i, (1 - tx) * (1 - ty)),
                          (x0i + 1, y0i, tx * (1 - ty)),
                          (x0i, y0i + 1, (1 - tx) * ty),
                          (x0i + 1, y0i + 1, tx * ty)):
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)   # (B, Lq, M, P)
            idx.append(flat.permute(0, 2, 1, 3))                 # (B, M, Lq, P)
            cw.append((w * valid * a).permute(0, 2, 1, 3))
        idx = torch.stack(idx, 2).reshape(B, M, 4 * Lq * P)     # (B, M, 4·Lq·P)
        cw = torch.stack(cw, 2)                                  # (B, M, 4, Lq, P)
        g = torch.gather(v_l, 2, idx[..., None].expand(-1, -1, -1, D))
        g = g.reshape(B, M, 4, Lq, P, D)
        out = out + torch.einsum("bmcqpd,bmcqp->bmqd", g, cw)
        start += H * W
    if start != S:
        raise ValueError(f"sum of level sizes {start} != value length {S}")
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D)


def msda_fwd(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Deformable-attention core; value bf16 or fp32, loc and aw fp32."""
    if value.device.type == "cpu":
        return msda_plain(value, loc, aw, spatial_shapes)
    if value.device.type != "cuda":
        raise ValueError(f"msda_fwd: unsupported device {value.device}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M or loc.shape[3] != L \
            or loc.shape[5] != 2:
        raise ValueError(f"msda_fwd: loc {tuple(loc.shape)} does not fit value "
                         f"{tuple(value.shape)} with {L} levels")
    Lq, P = loc.shape[1], loc.shape[4]
    if aw.shape != loc.shape[:5]:
        raise ValueError(f"msda_fwd: aw {tuple(aw.shape)} != {tuple(loc.shape[:5])}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"msda_fwd: level sizes {list(spatial_shapes)} do not sum to {S}")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"msda_fwd: value dtype must be bf16 or fp32, got {value.dtype}")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise ValueError("msda_fwd: loc and aw must be fp32")
    if not (L <= 4 and D <= 256):
        raise ValueError(f"msda_fwd: the kernel takes at most 4 levels and D <= 256, "
                         f"got {L} and {D}")
    for t in (loc, aw):
        if t.device != value.device:
            raise ValueError("msda_fwd: value, loc and aw must be on one device")
    if not (value.is_contiguous() and loc.is_contiguous() and aw.is_contiguous()):
        raise ValueError("msda_fwd: value, loc and aw must be contiguous")
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    starts, acc = [], 0
    for h, w in spatial_shapes:
        starts.append(acc)
        acc += h * w
    starts = (ctypes.c_int * L)(*starts)
    out = torch.empty((B, Lq, M * D), dtype=torch.float32, device=value.device)
    lib = _build.library()
    with torch.cuda.device(value.device):
        err = lib.asis_msda_fwd(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                                out.data_ptr(), B, S, M, D, Lq, L, P, shapes, starts,
                                int(value.dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "msda_fwd")
    global launches
    launches += 1
    return out
