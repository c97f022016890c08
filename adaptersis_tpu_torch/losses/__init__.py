"""The loss zoo and its `--loss` registry (counterpart of the JAX package's
`losses/`): the dice family, cross-entropies, focal, Lovász, boundary and
Hausdorff losses, the soft IoU loss, and the validation metrics.
Channel-last predictions (B, H, W, C), integer labels (B, H, W).

`LOSSES` maps each `--loss` name of the JAX package's registry to a
loss(predictions, labels). The adapter trainer feeds it softmax(logits),
the eval-script models (`--model tap_*`) their raw logits, as the JAX
trainer does; `get_loss` exits on a name that is not in it."""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from .boundary import bd_loss, compute_edts_forhdloss, dc_and_bd_loss, dist_binary_dice_loss
from .cross_entropy import (
    crossentropy_nd, dist_penalized_ce, dist_penalized_ce_weighted, topk_loss, weighted_ce_pair,
    weighted_crossentropy)
from .dice import (
    asym_loss, dc_and_ce_loss, dc_and_topk_loss, dc_loss, explog_loss, focal_tversky_loss,
    gdice_loss, gdice_v2_loss, iou_nnunet_loss, penalty_gdice_loss, soft_dice_loss, ss_loss,
    tversky_loss)
from .focal import focal_loss
from .functional import get_tp_fp_fn, one_hot_cl, softmax_cl
from .hausdorff import hausdorff_dt_loss, hausdorff_er_loss
from .iou_multi import ch_iou, iou, iou_loss, isi_iou, pixel_accuracy
from .lovasz import lovasz_grad, lovasz_softmax

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def flat_dice_coefficient(output: torch.Tensor, target: torch.Tensor,
                          eps: float = 1e-7) -> torch.Tensor:
    """Flattened binary dice: (2·Σ o·t + eps) / (Σ o + Σ t + eps)."""
    o, t = output.reshape(-1).float(), target.reshape(-1).float()
    return (2.0 * (o * t).sum() + eps) / (o.sum() + t.sum() + eps)


def ce_dc_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE + DC on raw logits: the SETR, UNet and UNet-fuse eval scripts'
    training loss."""
    return crossentropy_nd(logits, labels) + dc_loss(logits, labels)


def masktrans_train_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Weighted CE [0.1, 10] + (1 − the flat dice of the argmax), the mask
    transformer script's loss. The dice term has no gradient (the
    reference's quirk, kept): the gradient is the CE's."""
    preds = logits.argmax(dim=-1)
    return weighted_ce_pair(logits, labels) + (1.0 - flat_dice_coefficient(preds, labels))


LOSSES: Dict[str, Loss] = {
    "dc": dc_loss,
    "soft_dice": lambda x, y: soft_dice_loss(x, y, apply_nonlin=softmax_cl),
    "dice_ce": dc_and_ce_loss,
    "dice_topk": dc_and_topk_loss,
    "gdice": lambda x, y: gdice_loss(x, y, apply_nonlin=softmax_cl),
    "tversky": lambda x, y: tversky_loss(x, y, apply_nonlin=softmax_cl),
    "focal_tversky": lambda x, y: focal_tversky_loss(x, y, apply_nonlin=softmax_cl),
    "asym": lambda x, y: asym_loss(x, y, apply_nonlin=softmax_cl),
    "iou_nnunet": lambda x, y: iou_nnunet_loss(x, y, apply_nonlin=softmax_cl),
    "iou_multi": iou_loss,
    "ce": crossentropy_nd,
    "topk": topk_loss,
    "focal": lambda x, y: focal_loss(softmax_cl(x), y),
    "lovasz": lambda x, y: lovasz_softmax(softmax_cl(x), y),
    "explog": explog_loss,
    "dist_dice": dist_binary_dice_loss,
    "hausdorff_dt": lambda x, y: hausdorff_dt_loss(softmax_cl(x)[..., 1], y),
    "hausdorff_er": lambda x, y: hausdorff_er_loss(softmax_cl(x)[..., 1], y),
    "ce_dc": ce_dc_loss,
    "masktrans": masktrans_train_loss,
    "dc_and_hausdorff": lambda x, y: dc_loss(x, y) + hausdorff_dt_loss(softmax_cl(x)[..., 1], y),
}


def get_loss(name: str) -> Loss:
    """The train loss `name`; exits on a name the registry does not have."""
    if name not in LOSSES:
        sys.exit(f"error: unknown --loss {name!r}; the registry has {sorted(LOSSES)}")
    return LOSSES[name]

