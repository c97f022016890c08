"""Dice-family losses (counterpart of the JAX package's `losses/dice.py`,
nnU-Net's and SegLoss's). Channel-last predictions (B, H, W, C), integer
labels (B, H, W).

`dc_loss` is the main trainer's loss. The trainer feeds it softmax(logits)
and it softmaxes again: the reference's double softmax, kept."""

from __future__ import annotations

import torch

from .cross_entropy import crossentropy_nd, topk_loss, weighted_crossentropy
from .functional import drop_bg, get_tp_fp_fn, softmax_cl, target_cl


def dc_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """DC loss: softmax → one-hot → per-(batch, class) dice over the spatial
    axes, 10e-20 in the denominator, 1 − mean."""
    p = softmax_cl(output)
    y = target_cl(target, p)
    intersect = (p * y).sum(dim=(1, 2))
    dice = 2 * intersect / (p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) + 10e-20)
    return 1.0 - dice.mean()


def _ratio_loss(num, den, do_bg: bool, batch_dice: bool) -> torch.Tensor:
    r = num / den
    if not do_bg:
        r = drop_bg(r, batch_dice)
    return -r.mean()


def soft_dice_loss(x, y, apply_nonlin=None, batch_dice=False, do_bg=True, smooth=1.0,
                   square=False, loss_mask=None) -> torch.Tensor:
    """SoftDiceLoss; returns −dice, as the reference does."""
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    tp, fp, fn = get_tp_fp_fn(x, y, batch_dice, loss_mask, square)
    return _ratio_loss(2 * tp + smooth, 2 * tp + fp + fn + smooth, do_bg, batch_dice)


def iou_nnunet_loss(x, y, apply_nonlin=None, batch_dice=False, do_bg=True, smooth=1.0,
                    square=False, loss_mask=None) -> torch.Tensor:
    """nnU-Net's IoULoss."""
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    tp, fp, fn = get_tp_fp_fn(x, y, batch_dice, loss_mask, square)
    return _ratio_loss(tp + smooth, tp + fp + fn + smooth, do_bg, batch_dice)


def tversky_loss(x, y, apply_nonlin=None, batch_dice=False, do_bg=True, smooth=1.0,
                 square=False, alpha=0.3, beta=0.7, loss_mask=None) -> torch.Tensor:
    """TverskyLoss, α = 0.3, β = 0.7."""
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    tp, fp, fn = get_tp_fp_fn(x, y, batch_dice, loss_mask, square)
    return _ratio_loss(tp + smooth, tp + alpha * fp + beta * fn + smooth, do_bg, batch_dice)


def focal_tversky_loss(x, y, gamma=0.75, **tversky_kwargs) -> torch.Tensor:
    """FocalTversky: (1 + tversky_loss)^γ."""
    return torch.pow(1.0 + tversky_loss(x, y, **tversky_kwargs), gamma)


def asym_loss(x, y, apply_nonlin=None, batch_dice=False, do_bg=True, smooth=1.0,
              square=False, beta=1.5, loss_mask=None) -> torch.Tensor:
    """AsymLoss, β = 1.5."""
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    tp, fp, fn = get_tp_fp_fn(x, y, batch_dice, loss_mask, square)
    w = (beta * beta) / (1 + beta * beta)
    return _ratio_loss(tp + smooth, tp + w * fn + (1 - w) * fp + smooth, do_bg, batch_dice)


def ss_loss(x, y, apply_nonlin=None, batch_dice=False, do_bg=True, smooth=1.0,
            r=0.1) -> torch.Tensor:
    """Sensitivity-specificity loss."""
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    yh = target_cl(y, x)
    bg = 1 - yh
    sq = (yh - x) ** 2
    axes = (0, 1, 2) if batch_dice else (1, 2)
    spec = (sq * yh).sum(axes) / (yh.sum(axes) + smooth)
    sens = (sq * bg).sum(axes) / (bg.sum(axes) + smooth)
    ss = r * spec + (1 - r) * sens
    if not do_bg:
        ss = drop_bg(ss, batch_dice)
    return ss.mean()


def gdice_loss(x, y, apply_nonlin=None, smooth=1e-5) -> torch.Tensor:
    """Generalized dice: w_c = 1/(Σ y_c)², the dice over classes summed per
    batch element; returns −mean."""
    yh = target_cl(y, x, torch.float32)
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    x = x.float()
    ysum = yh.sum(dim=(1, 2))                                   # (B, C)
    w = 1.0 / (ysum + 1e-10) ** 2
    inter = w * torch.einsum("bhwc,bhwc->bc", x, yh)
    union = w * (x.sum(dim=(1, 2)) + ysum)
    divided = -2 * (inter.sum(-1) + smooth) / (union.sum(-1) + smooth)
    return divided.mean()


def gdice_v2_loss(x, y, apply_nonlin=None, smooth=1e-5) -> torch.Tensor:
    """GDiceLossV2: the class-flattened variant with clamped weights."""
    C = x.shape[-1]
    yh = target_cl(y, x, torch.float32)
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    xf = x.float().reshape(-1, C).t()                            # (C, N)
    yf = yh.reshape(-1, C).t()
    tsum = yf.sum(-1)
    w = 1.0 / torch.clamp(tsum * tsum, min=smooth)
    inter = ((xf * yf).sum(-1) * w).sum()
    denom = torch.clamp(((xf + yf).sum(-1) * w).sum(), min=smooth)
    return -2.0 * inter / denom


def penalty_gdice_loss(x, y, k=2.5, **gdice_kwargs) -> torch.Tensor:
    """PenaltyGDiceLoss."""
    g = gdice_loss(x, y, apply_nonlin=softmax_cl, **gdice_kwargs)
    return g / (1 + k * (1 - g))


def dc_and_ce_loss(x, y) -> torch.Tensor:
    """DC_and_CE_loss: CrossentropyND + SoftDiceLoss, both on the raw
    logits (the reference's SoftDiceLoss here has no nonlinearity: logits
    go straight into the dice ratio; kept)."""
    return crossentropy_nd(x, y) + soft_dice_loss(x, y)


def dc_and_topk_loss(x, y, k=10, soft_dice_kwargs=None) -> torch.Tensor:
    """DC_and_topk_loss."""
    sd = soft_dice_loss(x, y, apply_nonlin=softmax_cl, **(soft_dice_kwargs or {}))
    return topk_loss(x, y, k=k) + sd


def explog_loss(x, y, gamma=0.3, soft_dice_kwargs=None) -> torch.Tensor:
    """ExpLog_loss: 0.8·(−log dice)^γ + 0.2·weighted CE."""
    dc = -soft_dice_loss(x, y, apply_nonlin=softmax_cl, **(soft_dice_kwargs or {}))
    wce = weighted_crossentropy(x, y)
    return 0.8 * torch.pow(-torch.log(torch.clamp(dc, min=1e-6)), gamma) + 0.2 * wce
