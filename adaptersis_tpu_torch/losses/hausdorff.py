"""Hausdorff losses (counterpart of the JAX package's `losses/hausdorff.py`).
The reference runs numpy and scipy on the host per step; here both run on
the tensors' device, and the erosion loss is differentiable."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.edt import edt

# the soft erosion's cross, 0.2 on the centre and its 4 neighbours
_CROSS = (0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0.0)


def _distance_field(img: torch.Tensor) -> torch.Tensor:
    """posdist + negdist of img > 0.5, per image; 0 where an image has no
    foreground."""
    fg = img > 0.5
    field = edt(fg) + edt(~fg)
    return torch.where(fg.any(dim=(1, 2), keepdim=True), field, 0.0)


def hausdorff_dt_loss(pred: torch.Tensor, target: torch.Tensor,
                      alpha: float = 2.0) -> torch.Tensor:
    """HausdorffDTLoss. pred and target (B, H, W): the foreground
    probabilities and labels."""
    pred, target = pred.float(), target.float()
    pred_dt = _distance_field(pred.detach())
    target_dt = _distance_field(target)
    distance = pred_dt ** alpha + target_dt ** alpha
    return ((pred - target) ** 2 * distance).mean()


def hausdorff_er_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 2.0,
                      erosions: int = 10) -> torch.Tensor:
    """HausdorffERLoss: the squared error soft-eroded `erosions` times by the
    cross (then max(· − 0.5, 0) and a per-image min-max rescale), each
    erosion weighted by (k + 1)^α."""
    x = ((pred - target) ** 2).float()                                  # (B, H, W)
    kernel = torch.tensor(_CROSS, device=x.device).reshape(1, 1, 3, 3) * 0.2
    eroded = torch.zeros_like(x)
    for k in range(erosions):
        d = F.conv2d(x[:, None], kernel, padding=1)[:, 0]
        erosion = torch.clamp(d - 0.5, min=0.0)
        lo = erosion.amin(dim=(1, 2), keepdim=True)
        ptp = erosion.amax(dim=(1, 2), keepdim=True) - lo
        norm = (erosion - lo) / torch.where(ptp == 0, 1.0, ptp)
        x = torch.where(ptp == 0, erosion, norm)
        eroded = eroded + x * (k + 1) ** alpha
    return eroded.mean()
