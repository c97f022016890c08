"""The soft IoU loss and the EndoVis / ISI IoU metrics of
`train_multi_class.py` (counterpart of the JAX package's
`losses/iou_multi.py`). Channel-last logits (B, H, W, C), integer labels
(B, H, W)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(argmax == label)."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def iou(y_true: torch.Tensor, y_pred: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Binary soft IoU of two maps: (∩ + eps) / (∪ + eps)."""
    y_true, y_pred = y_true.float(), y_pred.float()
    inter = (y_true * y_pred).sum()
    return (inter + eps) / (y_true.sum() + y_pred.sum() - inter + eps)


def iou_loss(preds: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-6,
             num_classes: Optional[int] = None) -> torch.Tensor:
    """Soft per-(image, class) IoU loss of `train_multi_class.py`: softmax
    → one-hot → 1 − mean((∩ + s) / (∪ + s))."""
    num_classes = num_classes if num_classes is not None else preds.shape[-1]
    p = torch.softmax(preds.float(), dim=-1)
    y = F.one_hot(labels.long(), num_classes).float()
    inter = (p * y).sum(dim=(1, 2))
    union = p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) - inter
    return (1.0 - (inter + smooth) / (union + smooth)).mean()


def _mean_present_iou(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int,
                      either: bool) -> torch.Tensor:
    """Mean IoU over the classes 1..n−1 present in y_true (or in either map);
    1 when both maps are empty, 0 when only the prediction has foreground."""
    y_true, y_pred = y_true.long(), y_pred.long()
    per_class, present = [], []
    for c in range(1, n_classes):
        t, p = y_true == c, y_pred == c
        present.append(t.any() | p.any() if either else t.any())
        per_class.append(iou(t, p))
    per_class = torch.stack(per_class)
    present = torch.stack(present).float()
    mean_present = (per_class * present).sum() / present.sum().clamp(min=1.0)
    both = torch.where(y_pred.sum() == 0, 1.0, 0.0).to(mean_present)
    return torch.where(y_true.sum() == 0, both, mean_present)


def ch_iou(y_true: torch.Tensor, y_pred: torch.Tensor, num_classes: int = 8) -> torch.Tensor:
    """The EndoVis challenge IoU of one image: the mean IoU over the
    non-background classes present in the ground truth."""
    return _mean_present_iou(y_true, y_pred, num_classes, either=False)


def isi_iou(y_true: torch.Tensor, y_pred: torch.Tensor,
            problem_type: str = "instruments") -> torch.Tensor:
    """The ISI IoU of one image: the mean IoU over the classes present in
    either map."""
    n = {"binary": 2, "parts": 4, "instruments": 8}[problem_type]
    return _mean_present_iou(y_true, y_pred, n, either=True)
