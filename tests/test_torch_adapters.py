"""Port's CAViT, CACNN, FeatureEncoder and FeatureDecoder against the JAX
package (MSDA through Pallas in interpret mode), every parameter and BN
running statistic drawn from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.adapters import CACNN as JaxCACNN, CAViT as JaxCAViT
from adaptersis_tpu.models.decoders import FeatureDecoder as JaxFeatureDecoder
from adaptersis_tpu.models.encoders import FeatureEncoder as JaxFeatureEncoder
from adaptersis_tpu_torch.models.adapters import CACNN, CAViT, get_reference_points
from adaptersis_tpu_torch.models.decoders import FeatureDecoder
from adaptersis_tpu_torch.models.encoders import FeatureEncoder
from torch_parity import init_perturbed, load, n, pallas_interpret, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("pallas_interpret")

# fp32 on both sides; LayerNorm variance forms and summation orders differ
ATOL = 2e-5

PYRAMID = [(8, 8), (4, 4), (2, 2)]   # CNN levels (73/36/18 at 588 px)
VIT_GRID = [(6, 6)]                  # ViT patch grid (42×42 at 588 px)
C, HEADS, POINTS = 32, 2, 2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(jmod, tmod, args, targs, seed, atol=ATOL):
    variables = init_perturbed(jmod, seed, *args)
    expect = jax.tree_util.tree_map(np.asarray, jmod.apply(variables, *args))
    with torch.no_grad():
        got = load(tmod, variables)(*targs)
    for e, g in zip(jax.tree_util.tree_leaves(expect),
                    [n(x) if isinstance(x, torch.Tensor) else np.asarray(x)
                     for x in jax.tree_util.tree_leaves(got)]):
        np.testing.assert_allclose(g, e, atol=atol * max(1.0, np.abs(e).max()), rtol=0)


def test_cavit():
    q, feat = _rand((2, 36, C), 0), _rand((2, 84, C), 1)
    ref = get_reference_points(VIT_GRID)
    _compare(JaxCAViT(C, HEADS, POINTS, n_levels=3, msda_impl="pallas"),
             CAViT(C, HEADS, POINTS, n_levels=3),
             (jnp.asarray(q), jnp.asarray(ref.numpy()), jnp.asarray(feat), PYRAMID),
             (t(q), ref, t(feat), PYRAMID), seed=2)


def test_cacnn():
    q, feat = _rand((2, 84, C), 3), _rand((2, 36, C), 4)
    ref = get_reference_points(PYRAMID)
    _compare(JaxCACNN(C, HEADS, POINTS, n_levels=1, msda_impl="pallas"),
             CACNN(C, HEADS, POINTS, n_levels=1),
             (jnp.asarray(q), jnp.asarray(ref.numpy()), jnp.asarray(feat), VIT_GRID, PYRAMID),
             (t(q), ref, t(feat), VIT_GRID, PYRAMID), seed=5)


def test_reference_points_match_jax():
    from adaptersis_tpu.models.adapters import get_reference_points as jax_ref_points
    np.testing.assert_array_equal(n(get_reference_points(PYRAMID)),
                                  jax_ref_points(PYRAMID))


def test_feature_encoder():
    x = np.random.default_rng(6).uniform(0, 1, (2, 112, 112, 3)).astype(np.float32)
    _compare(JaxFeatureEncoder(inplanes=8, embed_dim=C), FeatureEncoder(8, C),
             (jnp.asarray(x),), (t(x),), seed=7)


def test_feature_decoder():
    x = _rand((2, 6, 6, 3 * C), 8)
    feats = (3 * C, 32, 16, 16, 8)
    _compare(JaxFeatureDecoder(num_classes=2, features=feats),
             FeatureDecoder(3 * C, 2, feats), (jnp.asarray(x),), (t(x),), seed=9)
