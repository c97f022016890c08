"""The port's plain deformable-attention backward (autograd of `msda_plain`,
the version the CUDA backward kernel is held against on the card) against
the JAX package's gradients: `jax.vjp` of `msda_pallas` (its custom backward
`_msda_bwd`, Pallas in interpret mode) and of the gather core
`ms_deform_attn_core`, on uniform points and on the hot-token and pixel-edge
geometries the CUDA kernels sort and round at (`torch_parity.msda_points`).
Also `torch.autograd.gradcheck` in float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaptersis_tpu.ops.msda_pallas as jax_msda
from adaptersis_tpu.ops.ms_deform_attn import ms_deform_attn_core
import adaptersis_tpu_torch.ops.msda_cuda as mc
from torch_parity import msda_points, n, pallas_interpret, t  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("pallas_interpret")


def _inputs(shapes, Lq, B=2, M=2, D=8, P=4, spread=0.1, seed=0):
    rng = np.random.default_rng(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    v = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(-spread, 1 + spread, (B, Lq, M, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, (B, Lq, M, L, P)).astype(np.float32)
    g = rng.standard_normal((B, Lq, M * D)).astype(np.float32)
    return v, loc, aw, g


def _plain_grads(v, loc, aw, g, shapes):
    v, loc, aw = (t(a).requires_grad_() for a in (v, loc, aw))
    out = mc.msda_plain(v, loc, aw, shapes)
    return [n(x) for x in torch.autograd.grad(out, (v, loc, aw), t(g))]


def _jax_grads(fn, v, loc, aw, g):
    _, vjp = jax.vjp(fn, jnp.asarray(v), jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shapes,Lq,D,spread,points", [
    # three levels, like CAViT's pyramid
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, 0.1, "uniform", id="shapes0-9-8-0.1"),
    # one non-square level, like CACNN's grid
    pytest.param([(6, 5)], 12, 16, 0.1, "uniform", id="shapes1-12-16-0.1"),
    # a third of the points outside the levels
    pytest.param([(8, 8), (4, 4)], 9, 32, 0.5, "uniform", id="shapes2-9-32-0.5"),
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, 0.1, "hot token", id="hot-token-3-levels"),
    pytest.param([(6, 5)], 12, 16, 0.1, "hot token", id="hot-token-1-level"),
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, 0.1, "pixel edges", id="pixel-edges-3-levels"),
    pytest.param([(6, 5)], 12, 16, 0.1, "pixel edges", id="pixel-edges-1-level"),
])
def test_plain_backward_matches_jax(shapes, Lq, D, spread, points):
    v, loc, aw, g = _inputs(shapes, Lq, D=D, spread=spread, seed=D)
    if points != "uniform":
        loc = msda_points(loc, shapes, points, seed=D)
    got = _plain_grads(v, loc, aw, g, shapes)
    pallas = _jax_grads(lambda a, b, c: jax_msda.msda_pallas(a, b, c, tuple(shapes)),
                        v, loc, aw, g)
    gather = _jax_grads(lambda a, b, c: ms_deform_attn_core(a, shapes, b, c), v, loc, aw, g)
    # fp32 on every side; the sums run in other orders. dV and daw add at
    # most a few dozen products of O(1) terms (1e-5); dloc is scaled by the
    # level's width, up to 8 here, and sums 4 corners × D channels (1e-4)
    for (name, atol), mine, p, gt in zip((("dvalue", 1e-5), ("dloc", 1e-4), ("daw", 1e-5)),
                                         got, pallas, gather):
        np.testing.assert_allclose(mine, p, atol=atol, rtol=0, err_msg=f"{name} vs pallas")
        np.testing.assert_allclose(mine, gt, atol=atol, rtol=0, err_msg=f"{name} vs gather")


def test_plain_backward_gradcheck_float64():
    """Finite differences in float64, with every sample point a fixed
    fraction (0.15–0.85) away from the pixel grid, where the bilinear weights
    are smooth; some points lie outside the levels."""
    shapes = [(4, 5), (2, 3)]
    B, Lq, M, D, P = 1, 3, 2, 4, 2
    rng = np.random.default_rng(7)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    v = torch.from_numpy(rng.standard_normal((B, S, M, D)))
    loc = np.empty((B, Lq, M, L, P, 2))
    for lvl, (H, W) in enumerate(shapes):
        for k, size in ((0, W), (1, H)):
            cell = rng.integers(-1, size + 1, (B, Lq, M, P))
            frac = rng.uniform(0.15, 0.85, (B, Lq, M, P))
            loc[:, :, :, lvl, :, k] = (cell + frac + 0.5) / size
    loc = torch.from_numpy(loc)
    aw = torch.from_numpy(rng.uniform(0, 1, (B, Lq, M, L, P)))
    inputs = tuple(x.requires_grad_() for x in (v, loc, aw))
    assert torch.autograd.gradcheck(lambda a, b, c: mc.msda_plain(a, b, c, shapes), inputs,
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_cpu_tensors_never_reach_the_backward_kernel():
    shapes = [(4, 4)]
    v, loc, aw, g = (t(a) for a in _inputs(shapes, 5))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mc.msda_bwd(v, loc, aw, g, shapes)
    before = mc.bwd_launches
    v.requires_grad_()
    mc.msda_fwd(v, loc, aw, shapes).sum().backward()
    assert mc.bwd_launches == before and v.grad is not None
