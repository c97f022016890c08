"""The main trainer's train and validation steps (counterpart of the JAX
package's `train/trainer.py:Trainer`), and casting a model for inference.

Precision: the trainables (encoder, adapters, level_embed, decoder) and the
SGD momentum stay fp32. Under bf16 the frozen backbone is stored in bf16,
except pos_embed, which stays fp32 (`TrainerConfig.precast_frozen` of the JAX
package), and the steps run under `torch.autocast(bf16)`: GEMMs and
convolutions compute in bf16 from fp32 weights, the adapters' LayerNorms
and softmax in fp32. The kernels' dtype contracts hold under it: the frozen
walks' kernels (LayerNorm, fused LN → qkv, attention, fused LN → MLP) take
and return the walk's bf16 tokens, and the MSDA value is bf16 with fp32
locations and weights (`ops/ms_deform_attn.py`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from ..data.augment import Draws, apply_input_norm, apply_train_augment, val_preprocess
from ..losses import dc_loss, pixel_accuracy, train_loss, weighted_ce_pair
from .schedules import cosine_annealing

# the reference recipe's SGD
MOMENTUM = 0.99
WEIGHT_DECAY = 3e-5


def _precast(module: nn.Module, backbone: nn.Module, dtype: torch.dtype) -> None:
    """Cast `module` to dtype, keeping the backbone's pos_embed fp32 (it is
    interpolated in fp32 and cast at use, as the JAX package keeps it)."""
    pos = backbone.pos_embed.data.float()
    module.to(dtype)
    backbone.pos_embed.data = pos


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter and buffer to `dtype`, except the backbone's
    pos_embed, which stays fp32."""
    backbone = getattr(model, "backbone", None)
    if backbone is None:
        return model.to(dtype)
    _precast(model, backbone, dtype)
    return model


class Trainer:
    """SGD on everything but the frozen backbone, with the reference recipe:
    momentum 0.99, weight decay 3e-5 (torch semantics: g += wd·p,
    buf = 0.99·buf + g, p −= lr·buf), cosine-annealed lr stepped per epoch,
    the double-softmax DC train loss, on-device augmentation."""

    def __init__(self, model: nn.Module, lr: float = 0.01, epochs: int = 100,
                 bf16: bool = False):
        self.model = model
        self.bf16 = bf16
        self.lr_fn = cosine_annealing(lr, epochs)
        model.backbone.requires_grad_(False)
        if bf16:
            _precast(model.backbone, model.backbone, torch.bfloat16)
        self.params = [p for name, p in model.named_parameters()
                       if not name.startswith("backbone.")]
        self.optimizer = torch.optim.SGD(self.params, lr=lr, momentum=MOMENTUM,
                                         weight_decay=WEIGHT_DECAY)

    def autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.model.level_embed.device.type, dtype=torch.bfloat16)

    def train_step(self, images_u8: torch.Tensor, masks: torch.Tensor, draws: Draws,
                   epoch: int) -> torch.Tensor:
        """augment → forward (BatchNorm in training mode) → loss → backward →
        SGD step. images_u8 (B, S, S, 3) uint8, masks (B, S, S), draws from
        `draw_train_augment` on the same device. Returns the loss as a device
        tensor; nothing in the step waits for the device."""
        return self.step(*apply_train_augment(images_u8, masks, draws), epoch)

    def step(self, x01: torch.Tensor, masks: torch.Tensor, epoch: int) -> torch.Tensor:
        """The step after augmentation: x01 (B, S, S, 3) float in [0, 1]. The
        gradients stay in the trainables' `.grad` until the next step."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(epoch)
        self.model.train()
        with self.autocast():
            logits = self.model(apply_input_norm(x01, "none"))
        loss = train_loss(logits.float(), masks)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:
            # a trainable that reaches no output (encoder.fc1: the decoder
            # reads no c1) still takes weight decay and momentum, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, images_u8: torch.Tensor, masks: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with self.autocast():
            return eval_step(self.model, images_u8, masks, valid)


@torch.no_grad()
def eval_step(model: nn.Module, images_u8: torch.Tensor, masks: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """images_u8 (B, H, W, 3) uint8, masks (B, H, W) int, valid (B,) bool marking
    real rows (padded duplicates are left out of the averages). Returns the
    per-sample-averaged loss (weighted CE for 2 classes, plain CE otherwise),
    dice and acc1, with the argmax `preds` and the fp32 `logits`."""
    model.eval()
    x = apply_input_norm(val_preprocess(images_u8), "none")
    logits = model(x).float()
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
