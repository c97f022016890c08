"""Cross-entropy family (counterpart of the JAX package's
`losses/cross_entropy.py`, SegLoss's ND_Crossentropy). Channel-last logits
(B, H, W, C), integer labels (B, H, W)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.edt import penalized_distance_map


def _flat_nll(logits: torch.Tensor, labels: torch.Tensor):
    """Per-pixel −log softmax at the label, flattened, and the labels."""
    C = logits.shape[-1]
    lp = torch.log_softmax(logits.reshape(-1, C).float(), dim=-1)
    lab = labels.reshape(-1).long()
    return -lp.gather(1, lab[:, None])[:, 0], lab


def _flat_ce(logits: torch.Tensor, labels: torch.Tensor,
             weight: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-pixel CE, mean weighted by each pixel's target weight
    (Σ w_i·l_i / Σ w_i, torch's CrossEntropyLoss(weight=w), which also
    wants one weight per class)."""
    nll, lab = _flat_nll(logits, labels)
    if weight is None:
        return nll.mean()
    if len(weight) != logits.shape[-1]:
        raise ValueError(f"{len(weight)} class weights for {logits.shape[-1]} classes")
    w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)[lab]
    return (nll * w).sum() / w.sum()


def crossentropy_nd(logits: torch.Tensor, labels: torch.Tensor,
                    weight: Optional[Sequence[float]] = None) -> torch.Tensor:
    """CrossentropyND."""
    return _flat_ce(logits, labels, weight)


def weighted_crossentropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """WeightedCrossEntropyLossV2: the reference computes its class weights
    and then passes none, so this is the plain CE; kept."""
    return _flat_ce(logits, labels)


def topk_loss(logits: torch.Tensor, labels: torch.Tensor, k: float = 10) -> torch.Tensor:
    """TopKLoss: the mean of the largest k % of the per-pixel CE."""
    nll, _ = _flat_nll(logits, labels)
    return torch.topk(nll, int(nll.shape[0] * k / 100)).values.mean()


def dist_penalized_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """DisPenalizedCE: the reference computes the EDT weighting and returns
    the unweighted mean; kept (the weighted form is
    `dist_penalized_ce_weighted`)."""
    return _flat_ce(logits, labels)


def dist_penalized_ce_weighted(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The EDT-weighted form: each pixel's CE times 1 + the penalised
    distance map of the foreground."""
    dist = (penalized_distance_map(labels > 0) + 1.0).reshape(-1)
    nll, _ = _flat_nll(logits, labels)
    return (nll * dist).mean()


def weighted_ce_pair(logits: torch.Tensor, labels: torch.Tensor,
                     weight: Sequence[float] = (0.1, 10.0)) -> torch.Tensor:
    """The main trainer's validation loss: CE with class weights [0.1, 10]."""
    return _flat_ce(logits, labels, weight)
