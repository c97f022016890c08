"""CNN spatial-prior encoder (counterpart of the JAX package's
`models/encoders.py`). NHWC at the boundary; the convolutions run on
channels_last views of it."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvBNRelu(nn.Module):
    """conv (no bias) → BatchNorm (eps 1e-5) → ReLU, on NCHW tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class FeatureEncoder(nn.Module):
    """Stem to /4, three stride-2 stages to /8, /16, /32, and 1×1 projections
    to embed_dim. The paddings (conv2, conv3: 0; conv4: 1) give the 73/36/18
    grids at 588 px. Returns c1 (B, H/4, W/4, E) NHWC, the tokens of c2, c3
    and c4, each (B, h·w, E), and the three (h, w) grids."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 1024):
        super().__init__()
        p = inplanes
        self.stem1 = ConvBNRelu(3, p, 3, 2, 1)
        self.stem2 = ConvBNRelu(p, p, 3, 1, 1)
        self.stem3 = ConvBNRelu(p, p, 3, 1, 1)
        self.conv2 = ConvBNRelu(p, 2 * p, 3, 2, 0)
        self.conv3 = ConvBNRelu(2 * p, 4 * p, 3, 2, 0)
        self.conv4 = ConvBNRelu(4 * p, 8 * p, 3, 2, 1)
        self.fc1 = nn.Conv2d(p, embed_dim, 1)
        self.fc2 = nn.Conv2d(2 * p, embed_dim, 1)
        self.fc3 = nn.Conv2d(4 * p, embed_dim, 1)
        self.fc4 = nn.Conv2d(8 * p, embed_dim, 1)

    def forward(self, x: torch.Tensor):
        x = self.stem3(self.stem2(self.stem1(x.permute(0, 3, 1, 2))))
        c1 = F.max_pool2d(x, 3, 2, 1)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        c2p, c3p, c4p = self.fc2(c2), self.fc3(c3), self.fc4(c4)

        def tokens(y: torch.Tensor) -> torch.Tensor:
            return y.flatten(2).transpose(1, 2)

        shapes: Tuple[Tuple[int, int], ...] = tuple(
            (y.shape[2], y.shape[3]) for y in (c2p, c3p, c4p))
        return (self.fc1(c1).permute(0, 2, 3, 1), tokens(c2p), tokens(c3p),
                tokens(c4p), shapes)
