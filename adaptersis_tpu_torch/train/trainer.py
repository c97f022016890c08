"""The validation step of the main trainer (counterpart of the JAX package's
`train/trainer.py:Trainer.eval_step`), and casting a model for inference."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..data.augment import apply_input_norm, val_preprocess
from ..losses import dc_loss, pixel_accuracy, weighted_ce_pair


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter and buffer to `dtype`, except the backbone's
    pos_embed, which stays fp32: it is interpolated in fp32 and cast at use,
    as the JAX package keeps it."""
    model.to(dtype)
    backbone = getattr(model, "backbone", None)
    if backbone is not None:
        backbone.pos_embed.data = backbone.pos_embed.data.float()
    return model


@torch.no_grad()
def eval_step(model: nn.Module, images_u8: torch.Tensor, masks: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """images_u8 (B, H, W, 3) uint8, masks (B, H, W) int, valid (B,) bool marking
    real rows (padded duplicates are left out of the averages). Returns the
    per-sample-averaged loss (weighted CE for 2 classes, plain CE otherwise),
    dice and acc1, with the argmax `preds` and the fp32 `logits`."""
    model.eval()
    x = apply_input_norm(val_preprocess(images_u8), "none")
    logits = model(x)
    B, C = logits.shape[0], logits.shape[-1]
    if valid is None:
        valid = torch.ones(B, dtype=torch.bool, device=logits.device)
    v = valid.float()
    nv = v.sum().clamp(min=1.0)

    def wmean(per_sample):
        return (torch.stack(per_sample) * v).sum() / nv

    pairs = [(logits[i:i + 1], masks[i:i + 1]) for i in range(B)]
    if C == 2:
        loss = [weighted_ce_pair(l, m) for l, m in pairs]
    else:
        loss = [torch.nn.functional.cross_entropy(l.reshape(-1, C), m.reshape(-1).long())
                for l, m in pairs]
    return {
        "loss": wmean(loss),
        "dice": wmean([1.0 - dc_loss(l, m) for l, m in pairs]),
        "acc1": wmean([pixel_accuracy(l, m) for l, m in pairs]),
        "preds": logits.argmax(dim=-1),
        "logits": logits,
    }
