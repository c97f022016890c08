"""NHWC resizes with torch.nn.functional.interpolate semantics, the
counterparts of the JAX package's `ops/resize.py` (which builds them as
interpolation matrices for the TPU; here they are `F.interpolate` itself)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)      # a channels_last view, no copy


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize, F.interpolate(mode='bilinear')."""
    if tuple(size) == tuple(x.shape[1:3]):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode="bilinear",
                               align_corners=align_corners))


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int],
                   scales: Tuple[float, float]) -> torch.Tensor:
    """NHWC bicubic resize, F.interpolate(mode='bicubic', scale_factor=scales):
    the source coordinates follow scale_factor mode, src = (dst + 0.5)/s − 0.5,
    which DINOv2's "+0.1" pos-embed fudge relies on. `size` is the output
    size the scales must give."""
    # torch's CUDA bicubic kernel has one thread per output pixel looping over
    # channels: given a channels_last view, neighbouring threads read addresses
    # C apart (8 ms for the 1024-channel pos-embed grid on an H100); contiguous
    # NCHW keeps their reads adjacent
    y = F.interpolate(_nchw(x).contiguous(), scale_factor=tuple(scales), mode="bicubic",
                      align_corners=False)
    if tuple(y.shape[2:]) != tuple(size):
        raise ValueError(f"bicubic resize gave {tuple(y.shape[2:])}, wanted {tuple(size)}")
    return _nhwc(y)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize, F.interpolate(mode='nearest'): source index
    floor(dst · in/out)."""
    if tuple(size) == tuple(x.shape[1:3]):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode="nearest"))


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear') as the decoders use it."""
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners)


def center_pad(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad NHWC x to `size`, the extra row/column going last
    (F.pad with [dx//2, dx − dx//2, dy//2, dy − dy//2])."""
    dy = size[0] - x.shape[1]
    dx = size[1] - x.shape[2]
    return F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
