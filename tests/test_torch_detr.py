"""The port's DETR stack and DynamicConv (`models/detr.py`) against the
JAX package's, every parameter drawn from a seed: the DETR transformer
with and without a padding mask, the deformable decoder (MSDA
cross-attention) with and without a refinement branch, DynamicConv with
and without its projection, and inverse_sigmoid."""

import numpy as np
import pytest
import torch
from flax import linen as fnn

import jax
import jax.numpy as jnp

from adaptersis_tpu.models import detr as jax_detr
from adaptersis_tpu_torch.models import detr
from torch_parity import init_perturbed, load, n, perturb, single_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

# fp32 on both sides; flax's LayerNorm takes E[x²] − E[x]², torch two passes
ATOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got), want, atol=atol * max(1.0, np.abs(want).max()), rtol=0)


def test_inverse_sigmoid():
    x = np.asarray([0.0, 1e-7, 0.1, 0.5, 0.9, 1.0, 1.3], np.float32)
    _close(detr.inverse_sigmoid(t(x)), jax_detr.inverse_sigmoid(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_detr_transformer(masked):
    B, H, W, C, nq = 2, 6, 5, 32, 7
    x, pos, qe = _rand((B, H, W, C), 0), _rand((B, H, W, C), 1), _rand((nq, C), 2)
    mask = np.zeros((B, H, W), bool)
    mask[:, -2:] = True
    jm = jnp.asarray(mask) if masked else None
    jmod = jax_detr.DetrTransformer(embed_dim=C, num_encoder_layers=2, num_decoder_layers=2,
                                    heads=4, ffn_dim=64)
    args = (jnp.asarray(x), jm, jnp.asarray(qe), jnp.asarray(pos))
    variables = init_perturbed(jmod, 3, *args)
    want_out, want_mem = jax.jit(jmod.apply)(variables, *args)
    mod = load(detr.DetrTransformer(C, 2, 2, 4, 64), variables)
    with torch.no_grad():
        out, mem = mod(t(x), torch.from_numpy(mask) if masked else None, t(qe), t(pos))
    assert tuple(out.shape) == (2, B, nq, C)
    _close(out, want_out)
    _close(mem, want_mem)


@pytest.mark.parametrize("refine", [False, True])
def test_deformable_decoder(refine):
    B, nq, C, L = 2, 5, 32, 2
    shapes = ((8, 8), (4, 4))
    S = sum(h * w for h, w in shapes)
    q, mem, qpos = _rand((B, nq, C), 4), _rand((B, S, C), 5), _rand((B, nq, C), 6)
    refs = np.random.default_rng(7).uniform(0.2, 0.8, (B, nq, L, 2)).astype(np.float32)
    jdec = jax_detr.DeformableDetrTransformerDecoder(num_layers=2, heads=4, ffn_dim=64,
                                                     n_points=2, n_levels=L)
    reg_jax = reg = None
    if refine:
        dense = fnn.Dense(2)
        reg_vars = perturb(jax.eval_shape(lambda: dense.init(jax.random.PRNGKey(0),
                                                             jnp.asarray(q))), 8)

        def reg_jax(y):
            return dense.apply(reg_vars, y)

        reg = load(torch.nn.Linear(C, 2), reg_vars)
    args = (jnp.asarray(q), jnp.asarray(mem), jnp.asarray(refs), shapes, jnp.asarray(qpos))
    variables = perturb(jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), *args,
                                                         reg_branch=reg_jax)), 9)
    want, want_refs = jdec.apply(variables, *args, reg_branch=reg_jax)
    dec = load(detr.DeformableDetrTransformerDecoder(C, 2, 4, 64, 2, L), variables)
    with torch.no_grad():
        out, out_refs = dec(t(q), t(mem), t(refs), shapes, t(qpos), reg_branch=reg)
    _close(out, want)
    _close(out_refs, want_refs, 1e-5)
    if not refine:
        np.testing.assert_array_equal(n(out_refs[-1]), refs)


@pytest.mark.parametrize("with_proj", [True, False])
def test_dynamic_conv(with_proj):
    N, HW, cin, cf = 3, 49, 16, 8
    pf, feat = _rand((N, cin), 10), _rand((N, HW, cin), 11)
    jdc = jax_detr.DynamicConv(in_channels=cin, feat_channels=cf, input_feat_shape=7,
                               with_proj=with_proj)
    args = (jnp.asarray(pf), jnp.asarray(feat))
    variables = init_perturbed(jdc, 12, *args)
    want = jdc.apply(variables, *args)
    dc = load(detr.DynamicConv(cin, cf, input_feat_shape=7, with_proj=with_proj), variables)
    with torch.no_grad():
        got = dc(t(pf), t(feat))
    assert tuple(got.shape) == ((N, cin) if with_proj else (N, HW, cin))
    _close(got, want)
