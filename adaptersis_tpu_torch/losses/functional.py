"""Shared loss plumbing (counterpart of the JAX package's
`losses/functional.py`, nnU-Net's helpers). Predictions are channel-last
(B, H, W, C), labels integer maps (B, H, W): per-(batch, class) reductions
sum over the spatial axes only; `batch_dice` sums over the batch too."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def softmax_cl(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the trailing class axis."""
    return torch.softmax(x, dim=-1)


def one_hot_cl(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int → (B, H, W, C) float32 one-hot."""
    return F.one_hot(labels.long(), num_classes).float()


def target_cl(gt: torch.Tensor, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """Labels as a one-hot of `like`'s class count (a one-hot passes
    through), in `dtype` (default `like`'s)."""
    y = gt if gt.dim() == like.dim() else one_hot_cl(gt, like.shape[-1])
    return y.to(dtype or like.dtype)


def get_tp_fp_fn(net_output: torch.Tensor, gt: torch.Tensor, batch_dice: bool = False,
                 mask: Optional[torch.Tensor] = None, square: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """nnU-Net's soft TP, FP and FN: (C,) with `batch_dice`, else (B, C).
    `mask` (B, H, W) leaves out the pixels where it is 0."""
    y = target_cl(gt, net_output)
    tp = net_output * y
    fp = net_output * (1 - y)
    fn = (1 - net_output) * y
    if mask is not None:
        m = mask.to(net_output.dtype)[..., None]
        tp, fp, fn = tp * m, fp * m, fn * m
    if square:
        tp, fp, fn = tp * tp, fp * fp, fn * fn
    axes = (0, 1, 2) if batch_dice else (1, 2)
    return tp.sum(axes), fp.sum(axes), fn.sum(axes)


def drop_bg(x: torch.Tensor, batch_dice: bool) -> torch.Tensor:
    """do_bg=False: drop class 0."""
    return x[1:] if batch_dice else x[:, 1:]
