"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: seeded parameter draws for flax variables, the weight bridge, and
interpret mode for the JAX package's Pallas kernels."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas.tpu as pltpu

import adaptersis_tpu.ops.flash_fwd as jax_flash
import adaptersis_tpu.ops.fused_mlp as jax_fused_mlp
import adaptersis_tpu.ops.fused_qkv as jax_fused_qkv
import adaptersis_tpu.ops.layernorm as jax_layernorm
import adaptersis_tpu.ops.msda_pallas as jax_msda
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import load_flax_variables


@contextlib.contextmanager
def interpret_pallas():
    """Run the JAX package's Pallas kernels in interpret mode, as its own
    tests do on the CPU."""
    mods = (jax_flash, jax_msda, jax_fused_qkv, jax_fused_mlp, jax_layernorm)
    saved = [m._FORCE_INTERPRET for m in mods]
    for m in mods:
        m._FORCE_INTERPRET = True
    try:
        yield
    finally:
        for m, v in zip(mods, saved):
            m._FORCE_INTERPRET = v


@pytest.fixture
def pallas_interpret():
    with interpret_pallas():
        yield


def interpret_library_flash():
    """Run the library's Pallas TPU flash attention (K7), which the JAX
    package calls without an interpret switch of its own, in the TPU
    interpreter. Kept apart from `interpret_pallas`: under the TPU
    interpreter the package's own MSDA training step does not finish on the
    CPU."""
    return pltpu.force_tpu_interpret_mode()


@pytest.fixture
def library_flash_interpret():
    with interpret_library_flash():
        yield


def init_perturbed(module, seed: int, *args) -> dict:
    """Flax variables of `module` for inputs `args`, every leaf drawn by
    `perturb`. Only the shapes of the module's own init are used."""
    return perturb(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)), seed)


def perturb(variables, seed: int) -> dict:
    """Replace every leaf of flax variables by a seeded numpy draw. Zero or
    near-zero initialisations (the CAViT gate, the sampling-offset and
    attention-weight kernels, LayerScale, level_embed) would otherwise make a
    comparison vacuous: kernels ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.1²),
    BN running variances in [0.5, 1.5], everything else N(0, 0.1²)
    (pos_embed and the tokens N(0, 0.02²))."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        keys = [getattr(p, "key", None) for p in path]
        name, shape = keys[-1], tuple(a.shape)
        if keys[0] == "batch_stats" and name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("pos_embed", "cls_token", "mask_token"):
            v = 0.02 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(variables))


def load(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load flax variables into a torch module through the weight bridge."""
    load_flax_variables(model, variables["params"], variables.get("batch_stats", {}))
    return model.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def n(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def msda_points(loc: np.ndarray, shapes, kind: str, seed: int) -> np.ndarray:
    """Deformable-attention sample locations of a harder kind, in place of
    uniform ones: "hot token", every point of head 0 on one pixel centre of
    each level, so that one token takes every corner of the head (the dV
    sum's largest bucket); "pixel edges", each coordinate within one fp32
    rounding (0 or ±1 ulp) of a pixel edge k/W or a pixel centre (k + ½)/W,
    where a point's corners and its location gradient change."""
    loc = loc.copy()
    rng = np.random.default_rng(seed)
    for lvl, (h, w) in enumerate(shapes):
        if kind == "hot token":
            loc[:, :, 0, lvl, :, 0] = np.float32((w // 2 + 0.5) / w)
            loc[:, :, 0, lvl, :, 1] = np.float32((h // 2 + 0.5) / h)
            continue
        if kind != "pixel edges":
            raise ValueError(kind)
        for axis, size in ((0, w), (1, h)):
            shape = loc[:, :, :, lvl, :, axis].shape
            k = rng.integers(-1, size + 2, shape) + 0.5 * (rng.uniform(size=shape) < 0.5)
            at = (k / size).astype(np.float32)
            step = rng.integers(-1, 2, shape)
            at = np.where(step < 0, np.nextafter(at, np.float32(-np.inf)),
                          np.where(step > 0, np.nextafter(at, np.float32(np.inf)), at))
            loc[:, :, :, lvl, :, axis] = at
    return loc.astype(np.float32)


def dinov2_state_dict(vit: dict, seed: int = 0) -> dict:
    """A seeded fp32 state dict with the names and shapes of a DINOv2 ViT
    (`vit`: DinoVisionTransformer's arguments), LayerScale γ ~ N(0, 0.1²) so
    that every block is live."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in DinoVisionTransformer(**vit).state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("gamma"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight") and len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("cls_token", "pos_embed", "mask_token"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out
