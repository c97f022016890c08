"""Segmentation decoder (counterpart of the JAX package's `models/decoders.py`,
FeatureDecoder only). NHWC between stages; each conv runs on a
channels_last view."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x
from .encoders import BatchNorm2d

DEFAULT_FEATURES = (1024, 512, 256, 128, 64)


class ConvBNReluUp(nn.Module):
    """conv 3×3 → BatchNorm (eps 1e-5) → ReLU → 2× bilinear up
    (align_corners=True). NHWC in and out."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return upsample2x(x.permute(0, 2, 3, 1), align_corners=True)


class FeatureDecoder(nn.Module):
    """Four ConvBNReluUp stages of widths features[1:], then a 3×3 logit conv.
    features[0] is the nominal input width; the real one is `in_ch`."""

    def __init__(self, in_ch: int, num_classes: int = 2,
                 features: Sequence[int] = DEFAULT_FEATURES):
        super().__init__()
        widths = [in_ch, *features[1:]]
        for i in range(1, len(widths)):
            self.add_module(f"decoder_{i}", ConvBNReluUp(widths[i - 1], widths[i]))
        self.n_stages = len(widths) - 1
        self.final_out = nn.Conv2d(widths[-1], num_classes, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"decoder_{i}")(x)
        return self.final_out(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
