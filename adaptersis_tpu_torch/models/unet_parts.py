"""UNet bricks (counterpart of the JAX package's `models/unet_parts.py`, the
reference's `backbones/unet_parts.py`): DoubleConv, Down, Up (transposed
conv or bilinear 2× up, centre pad to the skip, concat, DoubleConv), UpWC
(no skip), OutConv, and the truncated feature-space UNet on ViT tokens.
NHWC in and out; each brick runs its convolutions on a channels_last view.

The transposed convolutions (`up`) hold torch's ConvTranspose2d weight
(in, out, kh, kw); flax's kernel (kh, kw, in, out) is that weight with
both spatial axes reversed (`train/convert.py`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import center_pad, upsample2x
from .encoders import BatchNorm2d


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DoubleConv(nn.Module):
    """(conv 3×3, no bias → BatchNorm (eps 1e-5) → ReLU) × 2."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.conv1 = nn.Conv2d(in_ch, mid, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, out_ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(nchw(x))))
        return nhwc(F.relu(self.bn2(self.conv2(x))))


class Down(nn.Module):
    """2×2 max-pool, then DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nhwc(F.max_pool2d(nchw(x), 2, 2)))


def _up_layer(in_ch: int, bilinear: bool) -> Optional[nn.ConvTranspose2d]:
    return None if bilinear else nn.ConvTranspose2d(in_ch, in_ch // 2, 2, 2)


def _up(layer: Optional[nn.ConvTranspose2d], x: torch.Tensor) -> torch.Tensor:
    if layer is None:
        return upsample2x(x, align_corners=True)
    return nhwc(layer(nchw(x)))


class Up(nn.Module):
    """2× up (transposed conv to in/2 channels, or bilinear), centre-padded
    to the skip's size, concat [skip, x], DoubleConv."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, bilinear: bool = False):
        super().__init__()
        self.up = _up_layer(in_ch, bilinear)
        if bilinear:
            self.conv = DoubleConv(skip_ch + in_ch, out_ch, mid_ch=in_ch // 2)
        else:
            self.conv = DoubleConv(skip_ch + in_ch // 2, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = center_pad(_up(self.up, x), skip.shape[1:3])
        return self.conv(torch.cat([skip, x], dim=-1))


class UpWC(nn.Module):
    """Up without the skip."""

    def __init__(self, in_ch: int, out_ch: int, bilinear: bool = False):
        super().__init__()
        self.up = _up_layer(in_ch, bilinear)
        self.conv = (DoubleConv(in_ch, out_ch, mid_ch=in_ch // 2) if bilinear
                     else DoubleConv(in_ch // 2, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_up(self.up, x))


class OutConv(nn.Module):
    """1×1 conv with bias."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(self.conv(nchw(x)))


class FeatureUNet(nn.Module):
    """The truncated UNet on a ViT token map of c channels (the reference's
    eval/eval_dinov2_unet.py): down3, down4, two ups with skips, two without,
    OutConv. The output is at 4× the input grid."""

    def __init__(self, n_classes: int = 2, in_channels: int = 384, bilinear: bool = False):
        super().__init__()
        f = 2 if bilinear else 1
        c = in_channels
        self.down3 = Down(c, 2 * c)
        self.down4 = Down(2 * c, 4 * c // f)
        self.up1 = Up(4 * c // f, 2 * c, 2 * c // f, bilinear)
        self.up2 = Up(2 * c // f, c, c // f, bilinear)
        self.up3 = UpWC(c // f, c // 2 // f, bilinear)
        self.up4 = UpWC(c // 2 // f, c // 4, bilinear)
        self.outc = OutConv(c // 4, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x4 = self.down3(x)
        x5 = self.down4(x4)
        h = self.up2(self.up1(x5, x4), x)
        return self.outc(self.up4(self.up3(h)))
