"""Where the port's parameters come from: the JAX package's flax variables
(`load_flax_variables`, the inverse of the JAX package's `train/convert.py`
name map), or a seeded numpy draw (`seeded_init_`).

  flax                                   torch
  Dense `kernel` (in, out)           →   `weight` (out, in)
  Conv `kernel` HWIO                 →   `weight` OIHW (depthwise too)
  LayerNorm / BatchNorm `scale`      →   `weight`
  batch_stats `mean` / `var`         →   `running_mean` / `running_var`
  `blocks_N`                         →   `blocks.N`
  anything else (`bias`, `gamma`, `cls_token`, `pos_embed`, `level_embed`, ...)
                                     →   its own name
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_path(path: tuple) -> list:
    return [re.sub(r"^blocks_(\d+)$", r"blocks.\1", p) for p in path]


def _param(path: tuple, a: np.ndarray):
    *mod, leaf = _module_path(path)
    if leaf == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {a.ndim}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mod + [leaf]), a


def _stat(path: tuple, a: np.ndarray):
    *mod, leaf = _module_path(path)
    names = {"mean": "running_mean", "var": "running_var"}
    if leaf not in names:
        raise ValueError(f"unexpected batch_stats entry {'/'.join(path)}")
    return ".".join(mod + [names[leaf]]), a


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {}
    for tree, fn in ((params, _param), (batch_stats, _stat)):
        for path, a in _flatten(tree).items():
            name, a = fn(path, a)
            if name in sd:
                raise ValueError(f"two flax entries map to {name}")
            sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_flax_variables(model: nn.Module, params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]) -> None:
    """Load flax variables (nested dicts of arrays) into `model`, strictly:
    every parameter and BN statistic of the model must be given, with its
    shape, and nothing else. BatchNorm's `num_batches_tracked`, which flax
    has no counterpart of, keeps its value."""
    sd = flax_to_state_dict(params, batch_stats)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"flax variables do not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=False)


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter and BN statistic with a numpy draw from
    `seed`, in `named_parameters` order. Nothing is left at an
    initialisation that would hide a fault: weights ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1²), gates and biases N(0, 0.1²) (the CAViT gate,
    the sampling-offset and attention-weight kernels and LayerScale start at
    or near zero otherwise), BN running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                continue
            shape = tuple(t.shape)
            if leaf == "running_var":
                a = rng.uniform(0.5, 1.5, shape)
            elif leaf == "weight" and t.dim() >= 2:
                a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif leaf == "weight":
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            elif leaf in ("cls_token", "pos_embed", "mask_token"):
                a = 0.02 * rng.standard_normal(shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model
