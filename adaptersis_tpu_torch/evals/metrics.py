"""Classification metrics (counterpart of the JAX package's
`evals/metrics.py`): top-k accuracy averaged over samples (micro), over the
classes present (macro) or per class (none), ImageNet-ReaL accuracy, a
streaming (correct, count) accumulator, and `build_metric`'s name → function
table. Plain tensor reductions on the logits' device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1,
                  average: str = "micro", num_classes: Optional[int] = None) -> torch.Tensor:
    """Top-k accuracy; `average` ∈ {micro, macro, none}. Ties keep the lower
    class first (a stable sort, as `jnp.argsort`)."""
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    hit = (topk == labels[:, None]).any(dim=-1).float()
    if average == "micro":
        return hit.mean()
    onehot = F.one_hot(labels.long(), num_classes or logits.shape[-1]).float()
    per_class = (hit[:, None] * onehot).sum(0) / onehot.sum(0).clamp(min=1.0)
    if average == "none":
        return per_class
    present = (onehot.sum(0) > 0).float()
    return (per_class * present).sum() / present.sum().clamp(min=1.0)


def real_accuracy(logits: torch.Tensor, multilabel_targets: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    """ImageNet-ReaL: a sample is right if its top-1 class is among its
    targets ((B, C) of 0/1); samples without targets are left out."""
    top1 = logits.argmax(dim=-1)
    hit = multilabel_targets.gather(-1, top1[:, None])[:, 0].float()
    valid = (multilabel_targets.sum(-1) > 0).float()
    return (hit * valid).sum() / valid.sum().clamp(min=1.0)


@dataclass
class MetricAccumulator:
    """Streaming (correct, count): `update(hits, n)` adds a batch's mean
    `hits` over its `n` samples."""

    correct: float = 0.0
    count: float = 0.0

    def update(self, hits, n: int) -> None:
        self.correct += float(hits) * n
        self.count += n

    @property
    def value(self) -> float:
        return self.correct / max(self.count, 1.0)


def build_metric(metric_type: str = "mean_accuracy", ks=(1, 5)):
    """{"top-k": fn(logits, labels)} for each k, averaged as `metric_type`
    says (mean_accuracy: micro, mean_per_class_accuracy: macro,
    per_class_accuracy: none; anything else micro)."""
    avg = {"mean_accuracy": "micro", "mean_per_class_accuracy": "macro",
           "per_class_accuracy": "none"}.get(metric_type, "micro")
    return {f"top-{k}": (lambda k=k: (lambda lg, y: topk_accuracy(lg, y, k=k, average=avg)))()
            for k in ks}
