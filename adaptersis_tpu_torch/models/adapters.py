"""Deformable cross-attention adapters (counterpart of the JAX package's
`models/adapters.py`): CAViT lets the ViT tokens query the CNN pyramid,
CACNN lets the pyramid tokens query the ViT grid and refines them with a
ConvFFN."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ms_deform_attn import MSDeformAttn

Shapes = Sequence[Tuple[int, int]]


def get_reference_points(spatial_shapes: Shapes,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Normalised cell centres of every level, concatenated: (1, ΣHW, 1, 2)
    fp32, built on `device` (no host-to-device copy in the forward)."""
    pts = []
    for H, W in spatial_shapes:
        ys = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(pts, 0)[None, :, None, :]


def adapter_geometry(vit_hw: Tuple[int, int], cnn_shapes: Shapes,
                     device: torch.device | str = "cpu"):
    """((ref1, shapes1), (ref2, shapes2)): ViT-token queries → CNN pyramid
    levels, and CNN-token queries → the ViT grid."""
    cnn_shapes = [tuple(s) for s in cnn_shapes]
    return ((get_reference_points([tuple(vit_hw)], device), cnn_shapes),
            (get_reference_points(cnn_shapes, device), [tuple(vit_hw)]))


class DWConv(nn.Module):
    """Depthwise 3×3 conv applied to each level of a token sequence; the
    split [H0·W0, H1·W1, ...] comes from the level shapes."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, level_shapes: Shapes) -> torch.Tensor:
        B, N, C = x.shape
        if sum(h * w for h, w in level_shapes) != N:
            raise ValueError(f"level shapes {list(level_shapes)} do not cover {N} tokens")
        outs: List[torch.Tensor] = []
        start = 0
        for H, W in level_shapes:
            seg = x[:, start:start + H * W].reshape(B, H, W, C).permute(0, 3, 1, 2)
            outs.append(self.dwconv(seg).flatten(2).transpose(1, 2))
            start += H * W
        return torch.cat(outs, dim=1)


class ConvFFN(nn.Module):
    """fc1 → per-level DWConv → exact GELU → fc2."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor, level_shapes: Shapes) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), level_shapes)))


def _broadcast_ref(ref: torch.Tensor, query: torch.Tensor, n_levels: int) -> torch.Tensor:
    return ref.expand(query.shape[0], query.shape[1], n_levels, 2)


class CAViT(nn.Module):
    """ViT tokens query the CNN pyramid; residual gated by `gamma` (0 at init,
    so the adapter starts as the identity)."""

    def __init__(self, dim: int, num_heads: int = 8, n_points: int = 4, n_levels: int = 3,
                 init_values: float = 0.0):
        super().__init__()
        self.n_levels = n_levels
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points)
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                feat: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
        attn = self.attn(self.query_norm(query),
                         _broadcast_ref(reference_points, query, self.n_levels),
                         self.feat_norm(feat), spatial_shapes)
        return query + self.gamma.to(query.dtype) * attn


class CACNN(nn.Module):
    """CNN pyramid tokens query the ViT grid, then a ConvFFN refinement."""

    def __init__(self, dim: int, num_heads: int = 8, n_points: int = 4, n_levels: int = 1,
                 cffn_ratio: float = 0.25):
        super().__init__()
        self.n_levels = n_levels
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points)
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                feat: torch.Tensor, spatial_shapes: Shapes,
                query_level_shapes: Shapes) -> torch.Tensor:
        query = query + self.attn(self.query_norm(query),
                                  _broadcast_ref(reference_points, query, self.n_levels),
                                  self.feat_norm(feat), spatial_shapes)
        return query + self.ffn(self.ffn_norm(query), query_level_shapes)
