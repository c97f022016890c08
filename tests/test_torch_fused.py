"""The plain versions of the port's K6 LayerNorm, K4 fused LN → qkv → head
split and K5 fused LN → MLP → LayerScale → residual (the paths a CPU tensor
takes, and what chip_smoke.py holds the CUDA kernels against) against the
JAX package's Pallas kernels in interpret mode; the wrappers' CPU path,
device checks and forward-only rule.

The rows have non-zero means and unequal scales, so the fast variance
E[x²] − E[x]² is exercised; N = 37 is ragged (the JAX kernels pad it to
their row tile)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adaptersis_tpu.ops.fused_mlp as jax_fm
import adaptersis_tpu.ops.fused_qkv as jax_fq
import adaptersis_tpu.ops.layernorm as jax_ln
from adaptersis_tpu_torch.ops import _build, fused_mlp as fm, fused_qkv as fq, layernorm as ln
from torch_parity import n, pallas_interpret, t  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("pallas_interpret")

# tokens, width, heads; the last at ViT-L's width and head count (hidden
# 4096): the k-loop lengths the bf16 kernels run on the main path
CASES = [(37, 128, 2), (150, 256, 4), (37, 1024, 16)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(N, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, N, C)) * rng.uniform(0.5, 2.0, (2, N, 1))
         + rng.standard_normal((2, N, 1)))
    p = {"ln_w": 1 + 0.1 * rng.standard_normal(C), "ln_b": 0.1 * rng.standard_normal(C),
         "w": rng.standard_normal((C, 3 * C)) / np.sqrt(C),       # flax kernels: (in, out)
         "b": 0.1 * rng.standard_normal(3 * C),
         "w1": rng.standard_normal((C, 4 * C)) / np.sqrt(C), "b1": 0.1 * rng.standard_normal(4 * C),
         "w2": rng.standard_normal((4 * C, C)) / np.sqrt(4 * C), "b2": 0.1 * rng.standard_normal(C),
         "gamma": 0.1 * rng.standard_normal(C)}
    return x.astype(np.float32), {k: v.astype(np.float32) for k, v in p.items()}


def _check(got, want, dt):
    """fp32: the same formula, other summation orders: 1e-5 of the output's
    scale. bf16: both round the same fp32 values once to bf16, and where the
    two fp32 values straddle a rounding point they differ by one ulp, at most
    2⁻⁷ of the largest output."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = n(got.float())
    assert got.shape == want.shape
    scale = np.abs(want).max()
    rel = 1e-5 if dt == "fp32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N,C,H", CASES)
def test_layernorm_plain_matches_jax(N, C, H, dt):
    jdt, tdt = DTYPES[dt]
    x, p = _inputs(N, C, seed=N)
    want = jax_ln.fused_layernorm(jnp.asarray(x, jdt), jnp.asarray(p["ln_w"]),
                                  jnp.asarray(p["ln_b"]))
    got = ln.layernorm_plain(t(x).to(tdt), t(p["ln_w"]), t(p["ln_b"]))
    assert got.dtype == tdt
    _check(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N,C,H", CASES)
def test_fused_ln_qkv_plain_matches_jax(N, C, H, dt):
    jdt, tdt = DTYPES[dt]
    x, p = _inputs(N, C, seed=N + 1)
    want = jax_fq.fused_ln_qkv(jnp.asarray(x, jdt), *(jnp.asarray(p[k]) for k in
                                                       ("ln_w", "ln_b", "w", "b")), H)
    got = fq.fused_ln_qkv_plain(t(x).to(tdt), t(p["ln_w"]), t(p["ln_b"]), t(p["w"].T),
                                t(p["b"]), H)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.is_contiguous() and tuple(g.shape) == (2, H, N, C // H)
        _check(g, w, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("N,C,H", CASES)
def test_fused_ln_mlp_plain_matches_jax(N, C, H, dt):
    jdt, tdt = DTYPES[dt]
    x, p = _inputs(N, C, seed=N + 2)
    keys = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")
    want = jax_fm.fused_ln_mlp(jnp.asarray(x, jdt), *(jnp.asarray(p[k]) for k in keys))
    got = fm.fused_ln_mlp_plain(t(x).to(tdt), t(p["ln_w"]), t(p["ln_b"]), t(p["w1"].T),
                                t(p["b1"]), t(p["w2"].T), t(p["b2"]), t(p["gamma"]))
    assert got.dtype == tdt
    _check(got, want, dt)


def _calls(x, p):
    """Each wrapper with its plain version, on torch tensors."""
    qkv = (p["ln_w"], p["ln_b"], p["w"].t(), p["b"])
    mlp = (p["ln_w"], p["ln_b"], p["w1"].t(), p["b1"], p["w2"].t(), p["b2"], p["gamma"])
    return [(ln, lambda f: f(x, p["ln_w"], p["ln_b"]), ln.layernorm, ln.layernorm_plain),
            (fq, lambda f: f(x, *qkv, 2), fq.fused_ln_qkv, fq.fused_ln_qkv_plain),
            (fm, lambda f: f(x, *mlp), fm.fused_ln_mlp, fm.fused_ln_mlp_plain)]


def test_cpu_tensors_take_plain_path_without_launch():
    x, p = _inputs(37, 128, seed=5)
    x, p = t(x), {k: t(v) for k, v in p.items()}
    for mod, call, wrapper, plain in _calls(x, p):
        before = mod.launches
        got, want = call(wrapper), call(plain)
        assert mod.launches == before
        for g, w in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(2, 37, 128, device="meta")
    p = {k: torch.empty(v.shape, device="meta") for k, v in _inputs(37, 128, seed=6)[1].items()}
    for _, call, wrapper, _ in _calls(x, p):
        with pytest.raises(ValueError, match="unsupported device"):
            call(wrapper)


def test_refuse_to_drop_a_gradient():
    """No backward, like the JAX kernels on the frozen walks: an input that
    needs a gradient raises on any device (meta stands in for CUDA: the check
    comes first); under no_grad, as the frozen walks run, the call goes
    through."""
    x, p = _inputs(37, 128, seed=7)
    x, p = t(x), {k: t(v) for k, v in p.items()}
    p["ln_w"].requires_grad_()
    xm = torch.empty(2, 37, 128, device="meta", requires_grad=True)
    pm = {k: torch.empty(v.shape, device="meta") for k, v in p.items()}
    for (_, call, wrapper, _), (_, call_m, _, _) in zip(_calls(x, p), _calls(xm, pm)):
        with pytest.raises(RuntimeError, match="no backward"):
            call(wrapper)
        with torch.no_grad():
            call(wrapper)
        with pytest.raises(RuntimeError, match="no backward"):
            call_m(wrapper)


def test_parameters_are_read_as_stored():
    """The kernels read a frozen bf16 backbone's LayerNorm, bias and
    LayerScale vectors in place (no cast per call); fp32 ones likewise; a
    set of mixed dtypes goes to the kernel as fp32; a wrong shape raises."""
    x = torch.zeros(2, 37, 128, dtype=torch.bfloat16)
    w, b = torch.randn(128).to(torch.bfloat16), torch.randn(384).to(torch.bfloat16)
    (wd, bd), pbf = _build.params("f", x, ("w", w, 128), ("b", b, 384))
    assert pbf == 1 and wd.data_ptr() == w.data_ptr() and bd.data_ptr() == b.data_ptr()
    (wd, bd), pbf = _build.params("f", x, ("w", w.float(), 128), ("b", b.float(), 384))
    assert pbf == 0 and wd.dtype == bd.dtype == torch.float32
    (wd, bd), pbf = _build.params("f", x, ("w", w, 128), ("b", b.float(), 384))
    assert pbf == 0 and wd.dtype == bd.dtype == torch.float32
    torch.testing.assert_close(wd, w.float(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="f b: expected shape"):
        _build.params("f", x, ("w", w, 128), ("b", b, 128))
