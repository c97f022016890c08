"""Frozen-feature extraction (counterpart of the JAX package's
`evals/features.py`, DINOv2's `eval/utils.py`).

  * ModelWithIntermediateLayers: the backbone's last n blocks'
    `get_intermediate_layers(x, n, return_class_token=True)` taps under
    `torch.no_grad()`, in the backbone's precision (the deployed ViT in fp32
    runs the fp32 K3, K4 and K6 on the card).
  * linear_probe_features: the linear probe's input from the taps.
  * extract_features: the backbone over a loader of uint8 NHWC frames
    (scaled by 1/255, as the JAX package feeds them); with several ranks
    each rank extracts its loader's rows and every rank gets every rank's,
    in dataset-index order (DINOv2 all-gathers per batch and index-copies
    into a full-size tensor).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.dist import all_gather_rows, get_world_size


class ModelWithIntermediateLayers(nn.Module):
    def __init__(self, backbone: nn.Module, n_last_blocks: int = 4):
        super().__init__()
        self.backbone = backbone
        self.n = n_last_blocks

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> tuple:
        """((patch tokens (B, N, C), cls token (B, C)), ...) of the last n blocks."""
        return self.backbone.get_intermediate_layers(x, n=self.n, return_class_token=True)


def linear_probe_features(taps, use_n_blocks: int, use_avgpool: bool) -> torch.Tensor:
    """DINOv2's `create_linear_input`: the cls tokens of the last
    `use_n_blocks` taps, then with `use_avgpool` the mean patch token of the
    last one; fp32."""
    taps = taps[-use_n_blocks:]
    out = torch.cat([cls for _, cls in taps], dim=-1)
    if use_avgpool:
        out = torch.cat([out, taps[-1][0].mean(dim=1)], dim=-1)
        out = out.reshape(out.shape[0], -1)
    return out.float()


def _labels(ys, batch: int) -> torch.Tensor:
    """A batch's class ids: the targets, or the first entry of each row of
    a multi-entry target (as the JAX package takes them)."""
    ys = np.asarray(ys)
    return torch.from_numpy(np.ascontiguousarray(ys.reshape(batch, -1)[:, 0] if ys.ndim > 1
                                                 else ys).astype(np.int64))


def extract_features(model: ModelWithIntermediateLayers, loader,
                     pool: str = "cls") -> Tuple[torch.Tensor, torch.Tensor]:
    """(features (n, C) fp32, labels (n,) int64) on the backbone's device:
    the last tap's cls token (`pool` "cls") or its mean patch token. One
    rank: in the loader's order. Several ranks: every rank's rows on every
    rank, ordered by the loader's dataset indices, each index once (a
    sampler that pads a shard repeats some)."""
    device = next(model.parameters()).device
    feats, labels, index = [], [], []
    for imgs, ys, idx in loader:
        x = torch.as_tensor(imgs).to(device, non_blocking=True).float() / 255.0
        taps = model(x)
        feats.append(taps[-1][1] if pool == "cls" else taps[-1][0].mean(dim=1))
        labels.append(_labels(ys, len(imgs)))
        index.append(torch.as_tensor(np.asarray(idx), dtype=torch.int64))
    f = torch.cat(feats).float()
    y = torch.cat(labels).to(device)
    if get_world_size() == 1:
        return f, y
    idx = all_gather_rows(torch.cat(index).to(device))
    f, y = all_gather_rows(f), all_gather_rows(y)
    order = torch.argsort(idx, stable=True)
    idx, f, y = idx[order], f[order], y[order]
    first = torch.ones_like(idx, dtype=torch.bool)
    first[1:] = idx[1:] != idx[:-1]
    return f[first], y[first]
