"""Exact 2-D Euclidean distance transform on the tensors' device
(counterpart of the JAX package's `ops/edt.py`, plain XLA there, so plain
torch here): scipy.ndimage.distance_transform_edt's values by the
separable squared-distance algorithm:
  pass 1, per row: the distance along x to the nearest background pixel,
          from two running maxima of the background's indices; g = d²;
  pass 2, per column: EDT²(y, x) = min_y' g(y', x) + (y − y')², a
          min-plus product taken in blocks of rows to bound its memory.
"""

from __future__ import annotations

import torch

_BIG = 1e10
# elements of one block of the min-plus product (B·rows·H·W): 64 M fp32
_BLOCK_ELEMENTS = 1 << 26


def _row_dist_to_bg(bg: torch.Tensor) -> torch.Tensor:
    """Per row, the distance along the last axis to the nearest True of
    `bg` (…, W) bool; _BIG where the row has none. float32."""
    W = bg.shape[-1]
    idx = torch.arange(W, dtype=torch.float32, device=bg.device)
    left = torch.where(bg, idx, -_BIG).cummax(-1).values
    right = -torch.where(bg, -idx, -_BIG).flip(-1).cummax(-1).values.flip(-1)
    return torch.minimum(idx - left, right - idx)


def edt(mask: torch.Tensor) -> torch.Tensor:
    """For each True pixel of `mask` (B, H, W) bool, the Euclidean distance
    to the nearest False pixel; 0 on False pixels. float32 (B, H, W)."""
    d1 = _row_dist_to_bg(~mask)
    g = torch.clamp(d1 * d1, max=_BIG)                       # (B, H, W)
    B, H, W = mask.shape
    ys = torch.arange(H, dtype=torch.float32, device=mask.device)
    rows = max(1, _BLOCK_ELEMENTS // max(1, B * H * W))
    out = torch.empty_like(g)
    for y0 in range(0, H, rows):
        yq = ys[y0:y0 + rows]
        dy2 = (yq[:, None] - ys[None, :]) ** 2               # (rows, H)
        out[:, y0:y0 + rows] = (g[:, None] + dy2[None, :, :, None]).amin(dim=2)
    out = torch.sqrt(torch.clamp(out, max=_BIG))
    return torch.where(mask, out, 0.0)


def edt_signed_pair(mask: torch.Tensor) -> torch.Tensor:
    """posdist + negdist: the Hausdorff-DT distance field."""
    return edt(mask) + edt(~mask)


def penalized_distance_map(gt: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Inverted, per-image max-normalised distance maps of the foreground
    and the background of `gt` (B, H, W) bool (SegLoss's
    compute_edts_forPenalizedLoss). The reference rebinds pos_edt before
    taking the normalising max, so it divides by the max of the inverted,
    masked map; kept."""
    pos, neg = edt(gt), edt(~gt)
    fg = gt.float()
    pos_i = (pos.amax(dim=(1, 2), keepdim=True) - pos) * fg
    neg_i = (neg.amax(dim=(1, 2), keepdim=True) - neg) * (1.0 - fg)
    return (pos_i / torch.clamp(pos_i.amax(dim=(1, 2), keepdim=True), min=eps)
            + neg_i / torch.clamp(neg_i.amax(dim=(1, 2), keepdim=True), min=eps))
