"""Linear and DPT decode heads for segmentation and depth probing
(counterpart of the JAX package's `models/heads.py`; DINOv2's
`eval/segmentation` and `eval/depth` heads). NHWC at the boundary, the
convolutions on NCHW views; module names are the flax ones, so the weight
bridge carries the JAX heads' variables across (`up4` and `up2` are
transposed convolutions).

  * BNHead: the taps' patch maps (each with its cls token broadcast beside
    it), resized to the first's grid and concatenated → BatchNorm → 1×1
    conv to classes or depth bins. The BatchNorm is `encoders.BatchNorm2d`
    (flax's momentum 0.9 and biased running variance; over the global
    batch with several ranks, DINOv2's SyncBN).
  * ReassembleBlocks, PreActResidualConvUnit, FeatureFusionBlock, DPTHead:
    the DPT depth decoder (readout projection with exact GELU, 4× / 2× up,
    identity, 2× down; top-down fusion with align_corners=True resizes;
    sigmoid depth in [min_depth, max_depth]).
  * sig_loss (scale-invariant log loss) and gradient_loss (multi-scale
    gradient matching) of depth maps (B, H, W).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .encoders import BatchNorm2d


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BNHead(nn.Module):
    """`in_channels`: the concatenated width (each tap's C, twice with its
    cls token)."""

    def __init__(self, in_channels: int, num_classes: int = 2, use_cls_token: bool = True):
        super().__init__()
        self.use_cls_token = use_cls_token
        self.bn = BatchNorm2d(in_channels)
        self.conv_seg = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, taps) -> torch.Tensor:
        """taps: ((B, H, W, C) patch maps, (B, C) cls) pairs, or maps only;
        (B, H, W, num_classes)."""
        maps = []
        for t in taps:
            if isinstance(t, (tuple, list)):
                patch, cls = t
                if self.use_cls_token:
                    patch = torch.cat([patch, cls[:, None, None, :].expand_as(patch)], dim=-1)
            else:
                patch = t
            maps.append(patch)
        hw = tuple(maps[0].shape[1:3])
        x = torch.cat([resize_bilinear(m, hw) for m in maps], dim=-1)
        return _nhwc(self.conv_seg(self.bn(_nchw(x))))


class ReassembleBlocks(nn.Module):
    """Four taps → a pyramid at 4×, 2×, 1× and ½× the patch grid."""

    def __init__(self, embed_dim: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = "project"):
        super().__init__()
        self.readout_type = readout_type
        ch = list(post_process_channels)
        for i, c in enumerate(ch):
            if readout_type == "project":
                self.add_module(f"readout_{i}", nn.Linear(2 * embed_dim, embed_dim))
            self.add_module(f"proj_{i}", nn.Conv2d(embed_dim, c, 1))
        self.up4 = nn.ConvTranspose2d(ch[0], ch[0], 4, 4)
        self.up2 = nn.ConvTranspose2d(ch[1], ch[1], 2, 2)
        self.down2 = nn.Conv2d(ch[3], ch[3], 3, 2, 1)

    def forward(self, taps) -> List[torch.Tensor]:
        outs = []
        for i, (patch, cls) in enumerate(taps):
            x = patch
            if self.readout_type == "project":
                x = torch.cat([x, cls[:, None, None, :].expand_as(x)], dim=-1)
                x = F.gelu(getattr(self, f"readout_{i}")(x))
            x = getattr(self, f"proj_{i}")(_nchw(x))
            if i == 0:
                x = self.up4(x)
            elif i == 1:
                x = self.up2(x)
            elif i == 3:
                x = self.down2(x)
            outs.append(x)
        return outs                                   # NCHW


class PreActResidualConvUnit(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:        # NCHW
        h = self.bn1(self.conv1(F.relu(x)))
        return x + self.bn2(self.conv2(F.relu(h)))


class FeatureFusionBlock(nn.Module):
    """x (+ res1(skip) when the block fuses a deeper stream) → res2 → 2×
    (align_corners) → 1×1 project; NCHW."""

    def __init__(self, channels: int, with_skip: bool = True):
        super().__init__()
        self.res1 = PreActResidualConvUnit(channels) if with_skip else None
        self.res2 = PreActResidualConvUnit(channels)
        self.project = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        x = F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2), mode="bilinear",
                          align_corners=True)
        return self.project(x)


class DPTHead(nn.Module):
    def __init__(self, embed_dim: int = 768, channels: int = 256,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 min_depth: float = 0.001, max_depth: float = 10.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.reassemble = ReassembleBlocks(embed_dim, post_process_channels)
        for i, c in enumerate(post_process_channels):
            self.add_module(f"conv_{i}", nn.Conv2d(c, channels, 3, 1, 1, bias=False))
        for i in range(4):
            self.add_module(f"fusion_{i}", FeatureFusionBlock(channels, with_skip=i != 3))
        self.project = nn.Conv2d(channels, channels, 3, 1, 1)
        self.conv_depth = nn.Conv2d(channels, 1, 1)

    def forward(self, taps) -> torch.Tensor:
        """taps: four ((B, h, w, C), (B, C)); depth (B, 8h', 8w', 1)."""
        feats = [getattr(self, f"conv_{i}")(f) for i, f in enumerate(self.reassemble(taps))]
        x = self.fusion_3(feats[3])
        for i in (2, 1, 0):
            if x.shape[2:] != feats[i].shape[2:]:
                x = F.interpolate(x, size=tuple(feats[i].shape[2:]), mode="bilinear",
                                  align_corners=True)
            x = getattr(self, f"fusion_{i}")(feats[i], x)
        x = self.conv_depth(F.relu(self.project(x)))
        return _nhwc(torch.sigmoid(x) * (self.max_depth - self.min_depth) + self.min_depth)


def sig_loss(pred: torch.Tensor, target: torch.Tensor, valid_mask=None,
             sigma: float = 0.85, eps: float = 0.001) -> torch.Tensor:
    """Scale-invariant log loss over the valid pixels (target > eps)."""
    if valid_mask is None:
        valid_mask = target > eps
    m = valid_mask.to(pred.dtype)
    g = (torch.log(pred.clamp(min=eps)) - torch.log(target.clamp(min=eps))) * m
    n = m.sum().clamp(min=1.0)
    return torch.sqrt(((g ** 2).sum() / n - sigma * (g.sum() / n) ** 2).clamp(min=0.0))


def gradient_loss(pred: torch.Tensor, target: torch.Tensor, scales: int = 4,
                  eps: float = 0.001) -> torch.Tensor:
    """Σ over 4 scales (every 2^s-th pixel) of |∂x| + |∂y| of the log-depth
    difference where both pixels are valid, over the valid count."""
    diff = torch.log(pred.clamp(min=eps)) - torch.log(target.clamp(min=eps))
    total = 0.0
    for s in range(scales):
        step = 2 ** s
        d = diff[:, ::step, ::step]
        m = (target[:, ::step, ::step] > eps).to(pred.dtype)
        gx = torch.abs(torch.diff(d, dim=2)) * m[:, :, 1:] * m[:, :, :-1]
        gy = torch.abs(torch.diff(d, dim=1)) * m[:, 1:, :] * m[:, :-1, :]
        total = total + (gx.sum() + gy.sum()) / m.sum().clamp(min=1.0)
    return total
