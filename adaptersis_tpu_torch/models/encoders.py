"""CNN spatial-prior encoder (counterpart of the JAX package's
`models/encoders.py`). NHWC at the boundary; the convolutions run on
channels_last views of it."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics (eps 1e-5 unless given, flax
    momentum 0.9):
    normalise with the batch mean and the biased batch variance, and update
    the running stats as 0.9·old + 0.1·batch with the BIASED variance, where
    torch's own update puts the unbiased one into running_var. Parameter and
    buffer names are torch's, so the weight bridge is unchanged."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        # torch's op updates copies (autograd keeps them, so the buffers may
        # change after it): mean 0.9·old + 0.1·batch, var 0.9·old + 0.1·unbiased
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            # (n−1)/n·var + 0.9/n·old = 0.9·old + 0.1·biased
            self.running_var.mul_((1 - self.momentum) / n).add_(var, alpha=(n - 1) / n)
        return y


class ConvBNRelu(nn.Module):
    """conv (no bias) → BatchNorm (eps 1e-5) → ReLU, on NCHW tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=False)
        self.bn = BatchNorm2d(out_ch)

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


class PreViT(nn.Module):
    """A feature map → patch tokens (the reference's `pre_vit`, the JAX
    package's `models/encoders.py:PreViT`): a p×p stride-p conv from
    `in_chans` planes to `embed_dim`, an optional LayerNorm (eps 1e-5),
    flattened to (B, H'·W', D) or kept (B, H', W', D). NHWC in. No entry
    point uses it."""

    def __init__(self, patch_size: int = 14, in_chans: int = 256, embed_dim: int = 384,
                 use_norm: bool = False, flatten_embedding: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.flatten_embedding = flatten_embedding
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"input size ({H}, {W}) is not a multiple of the patch size {p}")
        y = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)       # (B, H', W', D)
        Hp, Wp, D = y.shape[1:]
        y = y.reshape(B, Hp * Wp, D)
        if self.norm is not None:
            y = self.norm(y)
        return y if self.flatten_embedding else y.reshape(B, Hp, Wp, D)
