"""The linear-probe grid (counterpart of the JAX package's `evals/linear.py`,
DINOv2's `eval/linear.py`): one linear classifier for each (taps used ×
average pooling × learning rate) combination, 2 × 2 × 13 = 52 by default,
trained together on the summed cross-entropy of all heads, then the best
head picked on the validation set.

Each head is an `nn.Linear` (weights ~ N(0, 0.01²), bias 0, drawn from a
`torch.Generator`) under `heads[<name>]`, named as the JAX grid names it;
training is SGD with momentum 0.9 and no dampening (optax's `trace`), one
parameter group per head with its own learning rate. Evaluation stacks
the heads that share a feature layout and computes their logits in one
product."""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .features import linear_probe_features

LRS = (1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 0.1, 0.2, 0.3, 0.5)


@dataclass
class _Head:
    name: str
    n_blocks: int
    avgpool: bool
    lr: float


class LinearProbeGrid(nn.Module):
    def __init__(self, embed_dim: int, n_last_blocks: int, num_classes: int,
                 lrs: Sequence[float] = LRS, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__()
        self.specs: List[_Head] = []
        for n, avg, lr in itertools.product([1, n_last_blocks], [False, True], lrs):
            name = f"classifier_{n}_blocks_avgpool_{avg}_lr_{lr:.5f}".replace(".", "_")
            self.specs.append(_Head(name, n, avg, lr))
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.heads = nn.ModuleDict({h.name: nn.Linear(self._feat_dim(h), num_classes)
                                    for h in self.specs})
        self.optimizer = None

    def _feat_dim(self, h: _Head) -> int:
        d = h.n_blocks * self.embed_dim
        return d + self.embed_dim if h.avgpool else d

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """DINOv2's LinearClassifier init: weights ~ N(0, 0.01²), zero bias,
        head after head from `generator`; a fresh optimizer."""
        for h in self.specs:
            lin = self.heads[h.name]
            w = torch.randn(lin.weight.shape, generator=generator) * 0.01
            lin.weight.copy_(w)
            lin.bias.zero_()
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        self.optimizer = torch.optim.SGD(
            [{"params": self.heads[h.name].parameters(), "lr": h.lr} for h in self.specs],
            lr=self.specs[0].lr, momentum=self.momentum, dampening=0.0,
            weight_decay=self.weight_decay)

    def train_step(self, taps, labels: torch.Tensor) -> Dict[str, float]:
        """One SGD step of every head on the summed mean cross-entropies;
        returns each head's loss before the step."""
        if self.optimizer is None:
            self.reset_optimizer()
        labels = torch.as_tensor(labels).to(taps[-1][1].device).long()
        losses = {}
        with torch.enable_grad():
            for h in self.specs:
                f = linear_probe_features(taps, h.n_blocks, h.avgpool)
                losses[h.name] = F.cross_entropy(self.heads[h.name](f), labels)
            self.optimizer.zero_grad(set_to_none=True)
            sum(losses.values()).backward()
        self.optimizer.step()
        return {k: v.item() for k, v in losses.items()}

    @torch.no_grad()
    def evaluate(self, taps_batches, labels_batches) -> Tuple[str, Dict[str, float]]:
        """Accuracy of every head over the batches; (the best head's name,
        {name: accuracy}), the first of equal bests in grid order."""
        groups: Dict[Tuple[int, bool], List[str]] = {}
        for h in self.specs:
            groups.setdefault((h.n_blocks, h.avgpool), []).append(h.name)
        correct = {h.name: 0 for h in self.specs}
        total = 0
        for taps, labels in zip(taps_batches, labels_batches):
            labels = torch.as_tensor(labels).to(taps[-1][1].device)
            total += int(labels.shape[0])
            for (n, avg), names in groups.items():
                f = linear_probe_features(taps, n, avg)
                w = torch.stack([self.heads[nm].weight for nm in names])     # (K, C, d)
                b = torch.stack([self.heads[nm].bias for nm in names])       # (K, C)
                logits = torch.einsum("bd,kcd->kbc", f, w) + b[:, None]
                hits = (logits.argmax(-1) == labels[None]).sum(dim=1).tolist()
                for nm, c in zip(names, hits):
                    correct[nm] += c
        accs = {k: v / max(total, 1) for k, v in correct.items()}
        return max(accs, key=accs.get), accs
