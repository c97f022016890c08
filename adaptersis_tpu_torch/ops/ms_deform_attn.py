"""Multi-scale deformable attention module (counterpart of the JAX package's
`ops/ms_deform_attn.py`; Deformable-DETR's MSDeformAttn). The sampling core
is `msda_fwd`: the CUDA kernel on the card, the plain gather form on the CPU."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .msda_cuda import msda_fwd


def _directional_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """sampling_offsets bias init: unit directions per head, scaled by the
    point index."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.value_proj.weight)
            nn.init.zeros_(self.value_proj.bias)
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _directional_offset_bias(n_heads, n_levels, n_points)))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)
            nn.init.xavier_uniform_(self.output_proj.weight)
            nn.init.zeros_(self.output_proj.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B, Lq, n_levels, 2) in [0, 1];
        input_flatten (B, S, C) with S = Σ H·W over `spatial_shapes`."""
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).reshape(B, S, M, -1)
        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        weights = self.attention_weights(query).reshape(B, Lq, M, L * P)
        weights = torch.softmax(weights.float(), dim=-1).reshape(B, Lq, M, L, P)
        # offsets are in pixels of each level: normalise by (W_l, H_l), as
        # Python scalars (a device tensor of them would cost a blocking copy)
        offsets = offsets.float()
        for lvl, (h, w) in enumerate(spatial_shapes):
            offsets[:, :, :, lvl, :, 0] /= w
            offsets[:, :, :, lvl, :, 1] /= h
        loc = reference_points[:, :, None, :, None, :].float() + offsets
        out = msda_fwd(value.contiguous(), loc.contiguous(), weights.contiguous(),
                       spatial_shapes)
        return self.output_proj(out.to(value.dtype))
