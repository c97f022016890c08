"""The port's windowed attention, windowed blocks and backbones, and
ViTAdapter (`models/layers.py`, `models/vit.py`, `models/vit_adapter.py`)
against the JAX package at vit_test-like width, every parameter drawn from
a seed; and, on the JAX package alone, the behaviour of its frozen walk
that the port's trainer follows or departs from on purpose."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import Block as JaxBlock, windowed_sdpa as jax_windowed_sdpa
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.models.vit import _quarter_global_windows
from adaptersis_tpu.models.vit_adapter import ViTAdapter as JaxViTAdapter
from adaptersis_tpu_torch.models.layers import Block, windowed_sdpa
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer, quarter_global_windows
from adaptersis_tpu_torch.models.vit_adapter import ViTAdapter, interaction_ranges
from torch_parity import (init_perturbed, interpret_pallas, load, n, perturb,  # noqa: F401
                          single_thread, t, with_backbone_norm)

pytestmark = pytest.mark.usefixtures("single_thread")

DEPLOYED = dict(attn_impl="flash_fwd", qkv_impl="pallas", mlp_impl="pallas", ln_impl="pallas")
# fp32 on both sides, both LayerNorms of the walk in the fast-variance form
ATOL = 2e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got), want, atol=atol * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("hw,window", [((7, 5), 4), ((4, 4), 4), ((3, 3), 14)])
def test_windowed_sdpa(hw, window):
    """Padded windows (7×5 → 8×8 in 4² windows; 3×3 → one 14² window: the
    padded positions take part in the softmax with score 0) and exact ones."""
    q, k, v = (_rand((2, hw[0] * hw[1], 3, 8), s) for s in (0, 1, 2))
    want = jax_windowed_sdpa(*(jnp.asarray(a) for a in (q, k, v)), 0.35, hw, window,
                             jnp.float32)
    _close(windowed_sdpa(t(q), t(k), t(v), 0.35, hw, window), want, 1e-6)


TRAINED = dict(attn_impl="flash", qkv_impl="xla", mlp_impl="xla", ln_impl="xla")


@pytest.mark.parametrize("gelu_approx,cls,impls", [(True, True, DEPLOYED),
                                                   (False, True, DEPLOYED),
                                                   (True, False, DEPLOYED),
                                                   (False, True, TRAINED)])
def test_windowed_block(gelu_approx, cls, impls):
    """A windowed block of the deployed configuration (K6 before the
    windowed attention, K5 or K6 + MLP after) and of the trained one (the
    LayerNorms and MLP in plain torch) on a 7×7 grid in 4² windows, with
    and without a leading cls token (which passes its own v)."""
    hw = (7, 7)
    x = _rand((2, 49 + int(cls), 64), 3)
    jblk = JaxBlock(64, 4, gelu_approx=gelu_approx, windowed=True, window_size=4, **impls)
    with interpret_pallas():
        variables = perturb(jax.eval_shape(
            lambda: jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), hw=hw)), 4)
        want = jblk.apply(variables, jnp.asarray(x), hw=hw)
    blk = load(Block(64, 4, gelu_approx=gelu_approx, windowed=True, window_size=4, **impls),
               variables)
    with torch.no_grad():
        _close(blk(t(x), hw=hw), want)


def test_windowed_schedule_and_backbone():
    """The quarter-global schedule equals the JAX one; a windowed backbone
    (8 blocks, 4² windows on a 7×7 grid) gives the JAX backbone's tokens."""
    for depth in (12, 24, 40):
        assert quarter_global_windows(depth) == _quarter_global_windows(depth)
    kw = dict(img_size=56, patch_size=14, embed_dim=64, depth=8, num_heads=4, window_size=4,
              window_attn=quarter_global_windows(8))
    x = np.random.default_rng(5).uniform(0, 1, (2, 98, 98, 3)).astype(np.float32)
    jvit = JaxViT(gelu_approx=True, **kw)
    variables = init_perturbed(jvit, 6, jnp.asarray(x))
    want = jax.jit(jvit.apply)(variables, jnp.asarray(x))
    vit = load(DinoVisionTransformer(gelu_approx=True, **kw), variables)
    with torch.no_grad():
        got = vit(t(x))
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "x_prenorm"):
        _close(got[key], want[key], 1e-4)


VIT = dict(img_size=56, patch_size=14, embed_dim=64, num_heads=4)


@pytest.mark.parametrize("windowed", [False, True])
def test_vit_adapter_pyramid(windowed):
    """The pyramid [f1 .. f4] in eval mode, then in training mode (batch
    statistics) and the BatchNorms' new running statistics: 8 blocks in 4
    interaction ranges, 6 extractors, on a windowed backbone too."""
    depth = 8
    kw = dict(VIT, depth=depth)
    if windowed:
        kw.update(window_size=4, window_attn=quarter_global_windows(depth))
    x = np.random.default_rng(7).uniform(0, 1, (2, 98, 98, 3)).astype(np.float32)
    jad = JaxViTAdapter(backbone=JaxViT(gelu_approx=True, **kw), freeze_vit=True)
    variables = init_perturbed(jad, 8, jnp.asarray(x))
    want, stats = jax.jit(lambda v, a: jad.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want_eval = jax.jit(jad.apply)(variables, jnp.asarray(x))
    ad = load(ViTAdapter(DinoVisionTransformer(gelu_approx=True, **kw)),
              {**variables, "params": with_backbone_norm(variables["params"], 64)})
    assert ad.ranges == interaction_ranges(depth) == [(0, 1), (2, 3), (4, 5), (6, 7)]
    with torch.no_grad():
        got_eval = ad.eval()(t(x))
        got = ad.train()(t(x))
    assert [tuple(f.shape) for f in got] == [(2, 25, 25, 64), (2, 12, 12, 64), (2, 5, 5, 64),
                                             (2, 3, 3, 64)]
    for g, w in zip(got + got_eval, list(want) + list(want_eval)):
        _close(g, w, 1e-4)
    for i in range(1, 5):
        bn = getattr(ad, f"norm{i}")
        _close(bn.running_mean, stats["batch_stats"][f"norm{i}"]["mean"], 1e-5)
        _close(bn.running_var, stats["batch_stats"][f"norm{i}"]["var"], 1e-5)
