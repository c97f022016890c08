"""Boundary and distance-map losses (counterpart of the JAX package's
`losses/boundary.py`). The distance transforms run on the labels' device
(`ops/edt.py`); the reference ran scipy on the host inside the loss."""

from __future__ import annotations

import torch

from ..ops.edt import edt_signed_pair, penalized_distance_map
from .dice import soft_dice_loss
from .functional import one_hot_cl, softmax_cl


def bd_loss(logits: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """BDLoss: the mean of the foreground softmax probabilities times a
    precomputed boundary distance map. logits and bound (B, H, W, C)."""
    p = softmax_cl(logits).float()
    return (p[..., 1:] * bound[..., 1:].float()).mean()


def dc_and_bd_loss(logits, target, bound, soft_dice_kwargs=None) -> torch.Tensor:
    """DC_and_BD_loss."""
    sd = soft_dice_loss(logits, target, apply_nonlin=softmax_cl, **(soft_dice_kwargs or {}))
    return sd + bd_loss(logits, bound)


def compute_edts_forhdloss(mask: torch.Tensor) -> torch.Tensor:
    """posdist + negdist of a (B, H, W) bool mask."""
    return edt_signed_pair(mask)


def dist_binary_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                          smooth: float = 1e-5) -> torch.Tensor:
    """DistBinaryDiceLoss: a dice whose TP is weighted by 1 + the penalised
    distance map of the ground truth."""
    C = logits.shape[-1]
    p = softmax_cl(logits).float()
    y = one_hot_cl(target, C)
    dist = penalized_distance_map(target > 0) + 1.0
    tp = (p[..., 1] * y[..., 1] * dist).sum(dim=(1, 2))
    dc = (2 * tp + smooth) / (p[..., 1].sum(dim=(1, 2)) + y[..., 1].sum(dim=(1, 2)) + smooth)
    return -dc.mean()
