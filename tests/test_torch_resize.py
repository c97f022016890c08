"""Port's NHWC resizes (F.interpolate) against the JAX package's matrix-form
resizes."""

import numpy as np
import pytest

import jax.numpy as jnp

import adaptersis_tpu.ops.resize as jr
import adaptersis_tpu_torch.ops.resize as tr
from torch_parity import n, t

# fp32 interpolation weights on both sides; only summation order differs
ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(13, 17), (40, 24), (7, 7)])
def test_bilinear(size, align_corners):
    x = _img((2, 9, 11, 3))
    np.testing.assert_allclose(n(tr.resize_bilinear(t(x), size, align_corners)),
                               np.asarray(jr.resize_bilinear(jnp.asarray(x), size,
                                                             align_corners)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("m,h,w", [(37, 42, 42), (4, 6, 6), (5, 3, 3), (6, 9, 8)])
def test_bicubic_scale_factor_mapping(m, h, w):
    """The pos-embed resize: scale_factor (h + 0.1)/m, as at 588 px (37 → 42),
    and for a non-square image. torch maps dst → src as (dst + 0.5)·(1/s) − 0.5,
    JAX as (dst + 0.5)/s − 0.5: at src ≈ 40 the two differ by a few fp32 ulps
    (~4e-6), and the cubic weights (slope ≤ 1.5, four taps of |x| ≤ 4) carry
    that to ≤ 1e-4."""
    x = _img((1, m, m, 8), seed=m)
    s = ((h + 0.1) / m, (w + 0.1) / m)
    np.testing.assert_allclose(n(tr.resize_bicubic(t(x), (h, w), scales=s)),
                               np.asarray(jr.resize_bicubic(jnp.asarray(x), (h, w),
                                                            scales=s)),
                               atol=1e-4, rtol=0)


def test_upsample2x_and_center_pad():
    x = _img((2, 5, 6, 3))
    np.testing.assert_allclose(n(tr.upsample2x(t(x))),
                               np.asarray(jr.upsample2x(jnp.asarray(x))), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(n(tr.center_pad(t(x), (8, 9))),
                                  np.asarray(jr.center_pad(jnp.asarray(x), (8, 9))))
