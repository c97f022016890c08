"""Where the port's parameters come from and go to: a DINOv2 `.pth`
checkpoint (`load_dinov2_backbone`), the JAX package's flax variables
(`load_flax_variables`, the inverse of the JAX package's `train/convert.py`
name map), a seeded numpy draw (`seeded_init_`), and back to flax variables
(`state_dict_to_flax`, `save_flax_variables`).

The port's backbone carries DINOv2's parameter names, so a `.pth` needs no
name map: `load_torch_state_dict` takes the `checkpoint_key` sub-dict
(default "teacher") or `state_dict` and strips the `module.` and
`backbone.` prefixes (DINOv2's `load_pretrained_weights`),
`flatten_chunked_block_keys` undoes FSDP's `blocks.<chunk>.<i>.` keys, and
the load is strict.

  flax                                   torch
  Dense `kernel` (in, out)           →   `weight` (out, in)
  Conv `kernel` HWIO                 →   `weight` OIHW (depthwise too)
  ConvTranspose `kernel` (kh, kw, in, out) of a module named `up`
                                     →   `weight` (in, out, kh, kw), both
                                         spatial axes reversed (flax applies
                                         it unflipped, torch as the conv's
                                         gradient)
  MultiHeadDotProductAttention's DenseGeneral `kernel` (C, H, Dh) of
  query/key/value and (H, Dh, C) of `out`, `bias` (H, Dh)
                                     →   Linear `weight` (H·Dh, C) and
                                         (C, H·Dh), `bias` (H·Dh,) (the
                                         DETR stack; no inverse)
  LayerNorm / BatchNorm `scale`      →   `weight`
  batch_stats `mean` / `var`         →   `running_mean` / `running_var`
  `blocks_N`                         →   `blocks.N`
  anything else (`bias`, `gamma`, `cls_token`, `pos_embed`, `level_embed`,
  `last_layer_v`, `dino_center`, ...)  →   its own name

The SSL state of the JAX package's `SSLMetaArch.init_state` ({student,
teacher} × {backbone, dino_head}, dino_center, ibot_center) loads into the
port's `SSLMetaArch` with `load_ssl_state`;
`state_dict_to_flax(arch)["params"]` gives the same tree back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


# the name of every transposed convolution (flax nn.ConvTranspose, torch
# nn.ConvTranspose2d) in both packages: `unet_parts.Up` and `UpWC`
TRANSPOSED = "up"


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
    if leaf == "kernel" and a.ndim == 3:            # flax attention's DenseGeneral
        a = a.reshape(-1, a.shape[-1]).T if mod[-1] == "out" else a.reshape(a.shape[0], -1).T
        leaf = "weight"
    elif leaf == "bias" and a.ndim == 2:
        a = a.reshape(-1)
    elif leaf == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4 and mod and mod[-1] == TRANSPOSED:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
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
            sd[name] = torch.from_numpy(np.array(a, order="C"))   # a copy: device_get arrays are read-only
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


def state_dict_to_flax(state) -> Dict[str, dict]:
    """The inverse of `flax_to_state_dict`: {"params": ..., "batch_stats": ...}
    as nested dicts of fp32 numpy arrays under flax paths. `state` is a module
    (its state dict) or any mapping of torch names to tensors, such as the
    gradients by parameter name. `num_batches_tracked` has no flax
    counterpart and is left out."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy().copy()   # not a view of the live tensor
        tree = "params"
        if leaf in ("running_mean", "running_var"):
            tree, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and a.ndim == 2:
            a, leaf = a.T, "kernel"
        elif leaf == "weight" and a.ndim == 4 and mod.rpartition(".")[2] == TRANSPOSED:
            a, leaf = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
        elif leaf == "weight" and a.ndim == 4:
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        node = out[tree]
        for k in re.sub(r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1blocks_\2", mod).split(".") \
                if mod else []:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


def save_flax_variables(path, model: nn.Module) -> None:
    """Write the model's variables as one .npz of flax paths ("params/...",
    "batch_stats/..."), the file `evaluate --flax_variables` reads."""
    flat = {"/".join(k): a for k, a in _flatten(state_dict_to_flax(model)).items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def m2f_variables(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX `segment_m2f` model's params or batch_stats ({backbone,
    adapter, head}: flax puts the shared backbone at the top) as the
    port's `Mask2FormerSegmentor` holds them: the backbone inside the
    adapter."""
    out = {k: v for k, v in tree.items() if k != "backbone"}
    if "backbone" in tree:
        out["adapter"] = {**out.get("adapter", {}), "backbone": tree["backbone"]}
    return out


def load_ssl_state(arch: nn.Module, state: Mapping[str, Any]) -> None:
    """Load a JAX SSL state tree into the port's `SSLMetaArch`: the student,
    the teacher and both centres, strictly. The Adam state is not read: the
    tree of `init_state` holds zero moments, as a new `SSLMetaArch` does."""
    load_flax_variables(arch, {k: state[k] for k in ("student", "teacher", "dino_center",
                                                     "ibot_center")}, {})


def load_torch_state_dict(path, checkpoint_key: str = "teacher") -> Dict[str, torch.Tensor]:
    """torch.load a `.pth` on the CPU and normalise its keys: the
    `checkpoint_key` sub-dict if present, then `state_dict` if present,
    with every `module.` and `backbone.` removed from the names."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and checkpoint_key in blob:
        blob = blob[checkpoint_key]
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k.replace("module.", "").replace("backbone.", ""): v for k, v in blob.items()}


def flatten_chunked_block_keys(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """FSDP's chunked blocks name a block `blocks.<chunk>.<i>.`: keep the
    inner index, `blocks.<i>.`. Any key with two index levels is chunked."""
    pat = re.compile(r"^blocks\.(\d+)\.(\d+)\.(.*)$")
    out = {}
    for k, v in sd.items():
        m = pat.match(k)
        out[f"blocks.{m.group(2)}.{m.group(3)}" if m else k] = v
    return out


# a DINOv2 training checkpoint's teacher holds its heads beside the backbone
HEAD_PREFIXES = ("dino_head.", "ibot_head.")


def load_dinov2_backbone(backbone: nn.Module, path, checkpoint_key: str = "teacher") -> None:
    """Load a DINOv2 `.pth` into the port's ViT, strictly: every parameter
    with its shape, and no key but the SSL heads' left over. The ViT must
    be built to match the checkpoint: register tokens (`register_tokens`),
    SwiGLU FFNs (`mlp.w12`, `mlp.w3`: `vit_giant2`) and blocks without
    LayerScale (DINO-v1's) load as their names say."""
    sd = flatten_chunked_block_keys(load_torch_state_dict(path, checkpoint_key))
    sd = {k: v for k, v in sd.items() if not k.startswith(HEAD_PREFIXES)}
    backbone.load_state_dict(sd, strict=True)


def seeded_init_(model: nn.Module, seed: int, skip: Tuple[str, ...] = ()) -> nn.Module:
    """Overwrite every parameter and BN statistic with a numpy draw from
    `seed`, in `named_parameters` order, but those whose names start with
    a prefix in `skip` (left as they are, drawing nothing). Nothing is left at an
    initialisation that would hide a fault: weights ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1²), gates and biases N(0, 0.1²) (the CAViT gate,
    the sampling-offset and attention-weight kernels and LayerScale start at
    or near zero otherwise), BN running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked" or name.startswith(skip):
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
