"""Port's deformable-attention core and module against the JAX package:
`msda_plain` against `msda_pallas` (interpret mode) and the gather core
`ms_deform_attn_core`, and `MSDeformAttn` against the flax module through
the weight bridge. Locations reach outside [0, 1], so zero padding at the
level borders is exercised; the hot-token and pixel-edge cases
(`torch_parity.msda_points`) hold the geometries the CUDA kernels sort and
round at."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adaptersis_tpu.ops.msda_pallas as jax_msda
from adaptersis_tpu.ops.ms_deform_attn import MSDeformAttn as JaxMSDeformAttn
from adaptersis_tpu.ops.ms_deform_attn import ms_deform_attn_core
import adaptersis_tpu_torch.ops.msda_cuda as mc
from adaptersis_tpu_torch.ops.ms_deform_attn import MSDeformAttn
from adaptersis_tpu_torch.train.convert import load_flax_variables
from torch_parity import init_perturbed, load, msda_points, n, pallas_interpret, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("pallas_interpret")

# fp32 on both sides: bilinear weights and sums differ only in order
ATOL = 1e-5


def _inputs(shapes, Lq, B=2, M=2, D=8, P=4, seed=0):
    rng = np.random.default_rng(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    v = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, (B, Lq, M, L, P)).astype(np.float32)
    return v, loc, aw


@pytest.mark.parametrize("shapes,Lq,D,points", [
    # three levels, like CAViT's pyramid
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, "uniform", id="shapes0-9-8"),
    # one non-square level, like CACNN's grid
    pytest.param([(6, 5)], 12, 16, "uniform", id="shapes1-12-16"),
    # the main path's head width
    pytest.param([(8, 8), (4, 4)], 9, 128, "uniform", id="shapes2-9-128"),
    # ViT-g's: 1536 wide, 8 adapter heads
    pytest.param([(8, 8), (4, 4)], 9, 192, "uniform", id="shapes2-9-192"),
    # vit_tiny's: 192 wide, 8 adapter heads of 24, a 4² grid's queries
    pytest.param([(8, 8), (4, 4), (2, 2)], 16, 24, "uniform", id="shapes0-16-24"),
    pytest.param([(8, 8), (4, 4), (2, 2)], 16, 24, "hot token", id="hot-token-d24"),
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, "hot token", id="hot-token-3-levels"),
    pytest.param([(6, 5)], 12, 16, "hot token", id="hot-token-1-level"),
    pytest.param([(8, 8), (4, 4), (2, 2)], 9, 8, "pixel edges", id="pixel-edges-3-levels"),
    pytest.param([(6, 5)], 12, 16, "pixel edges", id="pixel-edges-1-level"),
])
def test_plain_matches_jax(shapes, Lq, D, points):
    v, loc, aw = _inputs(shapes, Lq, D=D)
    if points != "uniform":
        loc = msda_points(loc, shapes, points, seed=D)
    out = n(mc.msda_plain(t(v), t(loc), t(aw), shapes))
    pallas = np.asarray(jax_msda.msda_pallas(jnp.asarray(v), jnp.asarray(loc),
                                             jnp.asarray(aw), tuple(shapes)))
    gather = np.asarray(ms_deform_attn_core(jnp.asarray(v), shapes, jnp.asarray(loc),
                                            jnp.asarray(aw)))
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, gather, atol=ATOL, rtol=0)


def test_cpu_dispatch_and_device_check():
    shapes = [(4, 4), (2, 2)]
    v, loc, aw = (t(a) for a in _inputs(shapes, 5))
    before = mc.launches
    torch.testing.assert_close(mc.msda_fwd(v, loc, aw, shapes),
                               mc.msda_plain(v, loc, aw, shapes), rtol=0, atol=0)
    assert mc.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        mc.msda_fwd(v.to("meta"), loc.to("meta"), aw.to("meta"), shapes)


def test_kernels_refuse_a_misaligned_loc():
    # the kernels read each point's (x, y) as one 8-byte load: a loc view at
    # an odd 4-byte offset is refused before any launch
    shapes = [(4, 4)]
    v, loc, aw = (t(a) for a in _inputs(shapes, 5))
    odd = torch.empty(loc.numel() + 1)[1:].view(loc.shape).copy_(loc)
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    mc._check(v, loc, aw, shapes, "msda_fwd")
    with pytest.raises(ValueError, match="loc 8-byte aligned"):
        mc._check(v, odd, aw, shapes, "msda_fwd")


def _module_case(seed=3):
    shapes = [(6, 6), (3, 3)]
    C, M, L, P, Lq = 32, 2, 2, 2, 10
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Lq, C)).astype(np.float32)
    ref = rng.uniform(0, 1, (2, Lq, L, 2)).astype(np.float32)
    feat = rng.standard_normal((2, 45, C)).astype(np.float32)
    jmod = JaxMSDeformAttn(d_model=C, n_levels=L, n_heads=M, n_points=P, impl="pallas")
    variables = init_perturbed(jmod, seed, jnp.asarray(q), jnp.asarray(ref),
                               jnp.asarray(feat), shapes)
    return jmod, variables, (q, ref, feat), shapes, (C, L, M, P)


def test_module_matches_flax():
    jmod, variables, (q, ref, feat), shapes, (C, L, M, P) = _module_case()
    expect = np.asarray(jmod.apply(variables, jnp.asarray(q), jnp.asarray(ref),
                                   jnp.asarray(feat), shapes))
    mod = load(MSDeformAttn(C, L, M, P), variables)
    with torch.no_grad():
        out = mod(t(q), t(ref), t(feat), shapes)
    # through the projections on both sides: fp32 sums of 32 terms
    np.testing.assert_allclose(n(out), expect, atol=2e-5, rtol=0)


def test_weight_bridge_is_strict():
    _, variables, _, _, (C, L, M, P) = _module_case()
    params = {k: dict(v) for k, v in variables["params"].items()}
    mod = MSDeformAttn(C, L, M, P)
    extra = dict(params, stray={"bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_variables(mod, extra, {})
    missing = {k: v for k, v in params.items() if k != "output_proj"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(mod, missing, {})
    params["value_proj"]["kernel"] = params["value_proj"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="value_proj.weight"):
        load_flax_variables(mod, params, {})
