"""Multi-scale deformable attention core: the counterpart of the JAX
package's `ops/msda_pallas.py`.

`msda_fwd` takes value (B, S, M, D), sampling locations (B, Lq, M, L, P, 2)
in [0, 1] (points outside contribute zero), attention weights
(B, Lq, M, L, P) and the static level shapes, and returns (B, Lq, M·D) in
fp32. On a CPU tensor it runs `msda_plain`, whose autograd is the plain
backward. On a CUDA tensor it runs `MSDAFunction`: the forward launches the
hand-written kernel `csrc/msda_fwd.cu` and the backward `csrc/msda_bwd.cu`,
which returns dvalue in value's dtype and dloc, daw in fp32, as the JAX
package's `_msda_bwd` does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them.
launches = 0
bwd_launches = 0


def msda_plain(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Gather form of the JAX `_msda_core_impl`: the four bilinear corners of
    every point gathered at once per level, in fp32 (fp64 for fp64 inputs).
    Its autograd is the plain backward."""
    B, S, M, D = value.shape
    Lq, P = loc.shape[1], loc.shape[4]
    ct = torch.promote_types(value.dtype, torch.float32)
    v = value.to(ct).permute(0, 2, 1, 3)               # (B, M, S, D)
    out = value.new_zeros((B, M, Lq, D), dtype=ct)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + H * W]
        xy = loc[:, :, :, lvl].to(ct)                  # (B, Lq, M, P, 2)
        a = aw[:, :, :, lvl].to(ct)                    # (B, Lq, M, P)
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


def _check(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
           spatial_shapes: Sequence[Tuple[int, int]], what: str):
    """Raise on what the kernels do not take; returns the level tables."""
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M or loc.shape[3] != L \
            or loc.shape[5] != 2:
        raise ValueError(f"{what}: loc {tuple(loc.shape)} does not fit value "
                         f"{tuple(value.shape)} with {L} levels")
    if aw.shape != loc.shape[:5]:
        raise ValueError(f"{what}: aw {tuple(aw.shape)} != {tuple(loc.shape[:5])}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"{what}: level sizes {list(spatial_shapes)} do not sum to {S}")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: value dtype must be bf16 or fp32, got {value.dtype}")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise ValueError(f"{what}: loc and aw must be fp32")
    if not (L <= 4 and D <= 256):
        raise ValueError(f"{what}: the kernels take at most 4 levels and D <= 256, "
                         f"got {L} and {D}")
    for t in (loc, aw):
        if t.device != value.device:
            raise ValueError(f"{what}: value, loc and aw must be on one device")
    if not (value.is_contiguous() and loc.is_contiguous() and aw.is_contiguous()):
        raise ValueError(f"{what}: value, loc and aw must be contiguous")
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    starts, acc = [], 0
    for h, w in spatial_shapes:
        starts.append(acc)
        acc += h * w
    return shapes, (ctypes.c_int * L)(*starts)


def _fwd_kernel(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    shapes, starts = _check(value, loc, aw, spatial_shapes, "msda_fwd")
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
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


def msda_bwd(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor, grad: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]]):
    """The backward kernel on CUDA tensors: grad (B, Lq, M·D) fp32 →
    (dvalue in value's dtype, dloc fp32, daw fp32). dvalue is summed with
    fp32 atomics in an order that changes from run to run."""
    if value.device.type != "cuda":
        raise ValueError(f"msda_bwd: the kernel needs CUDA tensors, got {value.device}")
    shapes, starts = _check(value, loc, aw, spatial_shapes, "msda_bwd")
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if grad.shape != (B, Lq, M * D) or grad.dtype != torch.float32 \
            or grad.device != value.device or not grad.is_contiguous():
        raise ValueError(f"msda_bwd: grad {tuple(grad.shape)} {grad.dtype} {grad.device} must "
                         f"be a contiguous fp32 ({B}, {Lq}, {M * D}) on {value.device}")
    dvalue = torch.zeros((B, S, M, D), dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    daw = torch.empty_like(aw)
    lib = _build.library()
    with torch.cuda.device(value.device):
        err = lib.asis_msda_bwd(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                                grad.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                                daw.data_ptr(), B, S, M, D, Lq, L, P, shapes, starts,
                                int(value.dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "msda_bwd")
    global bwd_launches
    bwd_launches += 1
    return dvalue.to(value.dtype), dloc, daw


class MSDAFunction(torch.autograd.Function):
    """The kernels as one differentiable op: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, value, loc, aw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        return _fwd_kernel(value, loc, aw, spatial_shapes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        value, loc, aw = ctx.saved_tensors
        dvalue, dloc, daw = msda_bwd(value, loc, aw, grad.float().contiguous(),
                                     ctx.spatial_shapes)
        return dvalue, dloc, daw, None


def msda_fwd(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Deformable-attention core; value bf16 or fp32, loc and aw fp32."""
    if value.device.type == "cpu":
        return msda_plain(value, loc, aw, spatial_shapes)
    if value.device.type != "cuda":
        raise ValueError(f"msda_fwd: unsupported device {value.device}")
    return MSDAFunction.apply(value, loc, aw, spatial_shapes)
