"""Seeded weights, made on the device: the benchmark's own copy of the
program's `seeded_init_` scheme, drawn in two large calls.

Every parameter and BatchNorm statistic of the segmentor gets a draw from
the seed, so no fault hides behind an initialisation at or near zero:
matrices and kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), the
cls/pos/mask tokens N(0, 0.02²), every other vector (biases, LayerScale and
CAViT gates, level embeddings, BatchNorm running means) N(0, 0.1²), and
BatchNorm running variances U(0.5, 1.5). The normals come from one
`torch.randn` and the variances from one `torch.rand`, both with a
`torch.Generator` on the card, fp32; each tensor is a scaled slice. The
names and shapes are the reference model's (`reference/model.py`), which
are the program's: the same dict loads strictly into both.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .reference.model import Segmentor

TOKENS = ("cls_token", "pos_embed", "mask_token")


def spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the model's state dict, parameters
    first, then buffers, each in module order."""
    with torch.device("meta"):
        model = Segmentor(cfg)
    return [(n, tuple(t.shape)) for n, t in
            list(model.named_parameters()) + list(model.named_buffers())]


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict for `seed`, on `device`."""
    entries = spec(cfg)
    normal = [(n, s) for n, s in entries if n.rsplit(".", 1)[-1] not in
              ("running_var", "num_batches_tracked")]
    variances = [(n, s) for n, s in entries if n.endswith("running_var")]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    numel = lambda s: int(torch.Size(s).numel())  # noqa: E731
    flat = torch.randn(sum(numel(s) for _, s in normal), generator=gen, device=device)
    flat_var = torch.rand(sum(numel(s) for _, s in variances), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    with torch.no_grad():
        for name, shape in normal:
            t = flat[at:at + numel(shape)].view(shape)
            at += numel(shape)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and len(shape) >= 2:
                t.mul_(float(numel(shape[1:])) ** -0.5)
            elif leaf == "weight":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02 if leaf in TOKENS else 0.1)
            out[name] = t
        at = 0
        for name, shape in variances:
            out[name] = flat_var[at:at + numel(shape)].view(shape).add_(0.5)
            at += numel(shape)
    for name, shape in entries:
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out
