"""Focal loss with label smoothing (counterpart of the JAX package's
`losses/focal.py`)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F


def focal_loss(probs: torch.Tensor, labels: torch.Tensor,
               alpha: Optional[Union[float, Sequence[float]]] = None, gamma: float = 2.0,
               balance_index: int = 0, smooth: float = 1e-5,
               size_average: bool = True) -> torch.Tensor:
    """probs (B, H, W, C) after a nonlinearity, labels (B, H, W): the mean
    (or sum) of −α_t·(1 − p_t)^γ·log p_t, the one-hot clamped to
    [smooth/(C − 1), 1 − smooth] and p_t + smooth."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C).float()
    lab = labels.reshape(-1).long()
    if alpha is None:
        a = torch.ones(C, device=p.device)
    elif isinstance(alpha, (list, tuple)):
        a = torch.tensor(alpha, dtype=torch.float32, device=p.device)
        a = a / a.sum()
    elif isinstance(alpha, float):
        a = torch.full((C,), 1 - alpha, device=p.device)
        a[balance_index] = alpha
    else:
        raise TypeError(f"unsupported alpha type {type(alpha)}")
    one_hot = F.one_hot(lab, C).float()
    if smooth:
        one_hot = one_hot.clamp(smooth / (C - 1), 1.0 - smooth)
    pt = (one_hot * p).sum(-1) + smooth
    loss = -a[lab] * torch.pow(1 - pt, gamma) * torch.log(pt)
    return loss.mean() if size_average else loss.sum()
