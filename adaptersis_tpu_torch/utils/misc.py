"""Training and retrieval utilities (counterpart of the JAX package's
`utils/misc.py`; DINO's root `utils.py`).

  * LARS: the optimizer of DINO's linear evaluation (the JAX package's
    `lars` transformation) as a `torch.optim.Optimizer`; 1-D parameters
    (biases, norms) skip the weight decay and the trust ratio.
  * clip_gradients: per-parameter norm clipping of `.grad`, in place.
  * MultiCropWrapper: one backbone call per run of crops of the same
    resolution, then the head on all outputs.
  * PCA, compute_ap, compute_map: retrieval whitening and the revisited
    Oxford/Paris average precision (numpy, as in the JAX package).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn


class LARS(torch.optim.Optimizer):
    """g ← g + wd·p, then g ← g·η‖p‖/‖g‖ (where both norms are non-zero)
    for parameters of two or more dimensions; then momentum
    buf ← momentum·buf + g and p ← p − lr·buf (optax's `trace`, torch's SGD
    without dampening)."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 eta: float = 0.001):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      eta=eta))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if p.ndim > 1:
                    g = g + group["weight_decay"] * p
                    pn, gn = torch.linalg.norm(p), torch.linalg.norm(g)
                    trust = torch.where((pn > 0) & (gn > 0), group["eta"] * pn / gn,
                                        torch.ones_like(pn))
                    g = g * trust
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(group["momentum"]).add_(g)
                p.add_(buf, alpha=-group["lr"])
        return loss


def clip_gradients(params: Union[nn.Module, Iterable[torch.Tensor]], clip: float
                   ) -> List[float]:
    """Scale each parameter's `.grad` by min(clip / (‖g‖ + 1e-6), 1) in place;
    returns the norms before clipping."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    norms = []
    for p in params:
        if p.grad is None:
            continue
        n = torch.linalg.norm(p.grad)
        norms.append(n.item())
        p.grad.mul_(torch.clamp(clip / (n + 1e-6), max=1.0))
    return norms


class MultiCropWrapper(nn.Module):
    """crops: NHWC tensors (or one); consecutive crops of the same height go
    through the backbone as one batch; the head takes every output,
    concatenated in crop order."""

    def __init__(self, backbone: Callable, head: Callable):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, crops: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        if isinstance(crops, torch.Tensor):
            crops = [crops]
        outputs, i = [], 0
        while i < len(crops):
            j = i
            while j < len(crops) and crops[j].shape[1] == crops[i].shape[1]:
                j += 1
            outputs.append(self.backbone(torch.cat(list(crops[i:j]), dim=0)))
            i = j
        return self.head(torch.cat(outputs, dim=0))


class PCA:
    """PCA whitening: `train_pca(cov)` keeps the `dim` largest eigenvalues
    (floored at 1e-5 of the largest) and scales by eigenvalue^−whit."""

    def __init__(self, dim: int = 256, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: Optional[np.ndarray] = None
        self.dvt: Optional[np.ndarray] = None

    def train_pca(self, cov: np.ndarray) -> None:
        d, v = np.linalg.eigh(cov)
        eps = d.max() * 1e-5
        if (d < eps).sum() > 0:
            d[d < eps] = eps
        totenergy = d.sum()
        idx = np.argsort(d)[::-1][:self.dim]
        d, v = d[idx], v[:, idx]
        print(f"keeping {d.sum() / totenergy * 100.0:.2f} % of the energy")
        self.dvt = np.dot(np.diag(1.0 / d ** self.whit), v.T)

    def apply(self, x: np.ndarray) -> np.ndarray:
        if self.mean is not None:
            x = x - self.mean
        return np.dot(self.dvt, x.T).T


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision from the ranks of the positives (trapezoids)."""
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(ranks):
        precision_0 = 0.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(ranks: np.ndarray, gnd, kappas: Sequence[int] = ()) -> Tuple:
    """(mAP, per-query APs, mean precision@k, per-query precision@k) with the
    junk images skipped; queries without positives are left out (nan)."""
    mapv = 0.0
    nq = len(gnd)
    aps = np.zeros(nq)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    for i in range(nq):
        qgnd = np.array(gnd[i]["ok"])
        if qgnd.shape[0] == 0:
            aps[i] = float("nan")
            prs[i, :] = float("nan")
            nempty += 1
            continue
        qgndj = np.array(gnd[i].get("junk", np.empty(0)))
        pos = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgnd)]
        junk = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgndj)]
        k = ij = 0
        if len(junk):
            for ip in range(len(pos)):
                while ij < len(junk) and pos[ip] > junk[ij]:
                    k += 1
                    ij += 1
                pos[ip] = pos[ip] - k
        ap = compute_ap(pos, len(qgnd))
        mapv += ap
        aps[i] = ap
        for j, kappa in enumerate(kappas):
            kq = min(max(pos), kappa)
            prs[i, j] = (pos < kq).sum() / kq
        pr = pr + prs[i, :]
    return mapv / (nq - nempty), aps, pr / (nq - nempty), prs
