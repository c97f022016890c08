"""The main trainer's train and validation steps (counterpart of the JAX
package's `train/trainer.py:Trainer`), and casting a model for inference.

Precision: the trainables (encoder, adapters, level_embed, decoder; the
eval-script models' head; with `tap_setr_ete` the backbone too) and the SGD
momentum stay fp32. Under bf16 a frozen backbone is stored in bf16, except
pos_embed, which stays fp32 (`TrainerConfig.precast_frozen` of the JAX
package), and the steps run under `torch.autocast(bf16)`: GEMMs and
convolutions compute in bf16 from fp32 weights, the adapters' LayerNorms
and softmax in fp32. The kernels' dtype contracts hold under it: the frozen
walks' kernels (LayerNorm, fused LN → qkv, attention, fused LN → MLP) take
and return the walk's bf16 tokens, and the MSDA value is bf16 with fp32
locations and weights (`ops/ms_deform_attn.py`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..data.augment import Draws, apply_input_norm, apply_train_augment, val_preprocess
from ..losses import ch_iou, dc_loss, get_loss, isi_iou, pixel_accuracy, weighted_ce_pair
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
    """SGD on everything but a frozen backbone (on the backbone too when the
    model trains it, `model.train_backbone`), with the reference recipe:
    momentum 0.99, weight decay 3e-5 (torch semantics: g += wd·p,
    buf = 0.99·buf + g, p −= lr·buf), cosine-annealed lr stepped per epoch,
    on-device augmentation, then `input_norm` (`data/augment.py`). The train
    loss is `LOSSES[loss]` of softmax(logits) with `softmax`, as the JAX
    trainer feeds the adapter model: under "dc", which softmaxes again, the
    reference's double softmax (validation feeds raw logits to DC: one
    softmax); of the raw logits without it, as the eval-script models
    train. `epoch` (the next to train) and `best_acc` travel with the state
    (`state_dict`)."""

    def __init__(self, model: nn.Module, lr: float = 0.01, epochs: int = 100,
                 bf16: bool = False, loss: str = "dc", softmax: bool = True,
                 input_norm: str = "none"):
        self.model = model
        self.bf16 = bf16
        self.softmax = softmax
        self.input_norm = input_norm
        self.lr_fn = cosine_annealing(lr, epochs)
        self.loss_fn = get_loss(loss)
        self.epoch = 0
        self.best_acc = 0.0
        self.train_backbone = getattr(model, "train_backbone", False)
        if not self.train_backbone:
            model.backbone.requires_grad_(False)
            if bf16:
                _precast(model.backbone, model.backbone, torch.bfloat16)
        self.params = [p for name, p in model.named_parameters() if self._saved(name)]
        self.optimizer = torch.optim.SGD(self.params, lr=lr, momentum=MOMENTUM,
                                         weight_decay=WEIGHT_DECAY)

    def _saved(self, name: str) -> bool:
        """Whether a parameter or buffer is trained and checkpointed: all
        but a frozen backbone's."""
        return self.train_backbone or not name.startswith("backbone.")

    def autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.params[0].device.type, dtype=torch.bfloat16)

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
            logits = self.model(apply_input_norm(x01, self.input_norm)).float()
        loss = self.loss_fn(torch.softmax(logits, dim=-1) if self.softmax else logits, masks)
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
            return eval_step(self.model, images_u8, masks, valid, self.input_norm)

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run reads: the trainables and the BatchNorm
        statistics (the model's state less a frozen backbone, which comes
        from the pretrained weights or the seed again), the SGD momentum
        buffers, `epoch` and `best_acc`."""
        return {"model": {k: v for k, v in self.model.state_dict().items() if self._saved(k)},
                "optimizer": self.optimizer.state_dict(),
                "epoch": self.epoch, "best_acc": self.best_acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        missing, unexpected = self.model.load_state_dict(state["model"], strict=False)
        missing = [k for k in missing if self._saved(k)]
        if missing or unexpected:
            raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                           f"unexpected {unexpected}")
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["epoch"])
        self.best_acc = float(state["best_acc"])


@torch.no_grad()
def eval_step(model: nn.Module, images_u8: torch.Tensor, masks: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              input_norm: str = "none") -> Dict[str, torch.Tensor]:
    """images_u8 (B, H, W, 3) uint8, masks (B, H, W) int, valid (B,) bool marking
    real rows (padded duplicates are left out of the averages); the images
    are /255 and then `input_norm`ed. Returns the
    per-sample-averaged loss (weighted CE for 2 classes, plain CE otherwise),
    dice and acc1, for more than 2 classes also the EndoVis challenge
    metrics `ch_iou` and `isi_iou` per image, with the argmax `preds` and
    the fp32 `logits`."""
    model.eval()
    x = apply_input_norm(val_preprocess(images_u8), input_norm)
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
    preds = logits.argmax(dim=-1)
    out = {
        "loss": wmean(loss),
        "dice": wmean([1.0 - dc_loss(l, m) for l, m in pairs]),
        "acc1": wmean([pixel_accuracy(l, m) for l, m in pairs]),
    }
    if C > 2:
        out["ch_iou"] = wmean([ch_iou(masks[i], preds[i], num_classes=C) for i in range(B)])
        out["isi_iou"] = wmean([isi_iou(masks[i], preds[i]) for i in range(B)])
    return {**out, "preds": preds, "logits": logits}
