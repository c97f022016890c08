"""The port's tf32 arithmetic (adaptersis_tpu_torch/ops/tf32.py): the fp32
kernels' operand split x = hi + lo and their 3×TF32 products.

`round_tf32` against an independent numpy model of `cvt.rna.tf32.f32`, bit
for bit, on ties, values next to powers of two, subnormals and the ends of
the range; the split's reconstruction; and the emulated fp32 K3 and K4
against the JAX package's Pallas kernels (interpret mode), on the same
numpy-seeded inputs, within the per-element fp32 bounds that chip_smoke.py
holds the CUDA kernels to: three passes inside them, one pass (operands
rounded to tf32, what a kernel without the split computes) outside."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adaptersis_tpu.ops.flash_fwd as jax_flash
import adaptersis_tpu.ops.fused_qkv as jax_fq
from adaptersis_tpu_torch.ops import _build, flash_fwd as ff, tf32
from adaptersis_tpu_torch.ops.layernorm import ln_rows
from torch_parity import n, pallas_interpret, single_thread, t  # noqa: F401  (fixtures)

pytestmark = pytest.mark.usefixtures("pallas_interpret", "single_thread")


def rna_model(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 from the definition: |x| to the nearest multiple of
    its tf32 spacing 2^(e − 10) (e = floor(log2|x|), at least −126, where
    fp32's and tf32's subnormals start), ties away from zero, in float64;
    past the largest finite tf32 value, infinity."""
    x = np.asarray(x, np.float32)
    a = np.abs(x.astype(np.float64))
    _, e = np.frexp(a)                       # a = m·2^e, m in [0.5, 1)
    q = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    r = np.floor(a / q + 0.5) * q
    r = np.where(r >= 2.0 ** 128, np.inf, r)
    out = np.copysign(r, x.astype(np.float64)).astype(np.float32)
    return np.where(np.isfinite(x), out, x)


def _bits(pattern) -> np.ndarray:
    return np.asarray(pattern, np.uint32).view(np.float32)


def _cases() -> dict:
    rng = np.random.default_rng(0)
    high = rng.integers(0, 1 << 19, 4000, dtype=np.uint64) << 13
    high = high[(high & 0x7F800000) != 0x7F800000]  # finite patterns only
    return {
        "normal": (rng.standard_normal(4000) * 10.0 ** rng.uniform(-30, 30, 4000)),
        # exactly half a tf32 step above a tf32 value, and one bit either side
        "ties": _bits(np.concatenate([high | 0x1000, high | 0x0FFF, high | 0x1001])),
        # the largest patterns below each power of two round up into it
        "near powers of two": _bits([(e << 23) | m for e in range(1, 255)
                                     for m in (0x7FEFFF, 0x7FF000, 0x7FF001, 0x7FFFFF, 0)]),
        "subnormals": _bits(np.concatenate([rng.integers(1, 1 << 23, 2000, dtype=np.uint64),
                                            np.array([1, 0xFFF, 0x1000, 0x1FFF, 0x7FFFFF])])),
        "range ends": np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38, -3.4028235e38,
                                _bits(0x7F7FEFFF), _bits(0x7F7FF000), 1.1754944e-38],
                               np.float32),
    }


@pytest.mark.parametrize("kind", list(_cases()))
def test_round_tf32_matches_cvt_rna_model(kind):
    x = np.asarray(_cases()[kind], np.float32)
    x = np.concatenate([x, -x])
    got = n(tf32.round_tf32(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.view(np.uint32), rna_model(x).view(np.uint32))
    assert not (got[np.isfinite(got)].view(np.uint32) & 0x1FFF).any()


def test_round_tf32_keeps_nan_and_takes_fp32_only():
    x = torch.tensor([float("nan"), 1.0])
    assert torch.isnan(tf32.round_tf32(x)[0])
    with pytest.raises(ValueError, match="float32"):
        tf32.round_tf32(x.double())


def test_split_reconstructs_to_2_pow_minus_22():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.uniform(-20, 20, 20000))
                         .astype(np.float32))
    hi, lo = tf32.split_tf32(x)
    assert torch.equal(hi, tf32.round_tf32(x)) and torch.equal(lo, tf32.round_tf32(x - hi))
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22


def _share(got, ref, allow) -> float:
    return float((np.abs(n(got) - ref) / allow).max())


def _ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 23)


@pytest.mark.parametrize("N", [117, 200])
def test_flash_fwd_3xtf32_within_k3_bound_and_1xtf32_outside(N):
    """K3's fp32 bound (chip_smoke.py `k3_allowance`): ulp(|ref| + ε) + ε,
    ε = 2⁻¹⁵·Σ_j p_ij·|v_j|, against the JAX kernel's fp32 output; the inputs
    as chip_smoke.py's `flash_inputs` scales them (scores of std ≈ 2.25)."""
    B, H, Dh = 2, 2, 64
    rng = np.random.default_rng(N)
    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype(np.float32) * s
               for s in (1.5, 1.5, 1.0))
    Np = -(-N // 128) * 128
    pad = ((0, 0), (0, 0), (0, Np - N), (0, 0))
    valid = np.broadcast_to((np.arange(Np) < N).astype(np.int32)[None], (B, Np))
    ref = np.asarray(jax_flash.flash_fwd(*(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)),
                                         jnp.asarray(valid), 0.125))[:, :, :N]
    s = (q.astype(np.float64) * 0.125) @ k.astype(np.float64).transpose(0, 1, 3, 2)
    p = np.exp(s - s.max(-1, keepdims=True))
    eps = 2.0 ** -15 * ((p / p.sum(-1, keepdims=True)) @ np.abs(v.astype(np.float64)))
    allow = _ulp(np.abs(ref) + eps) + eps
    three = _share(tf32.flash_fwd_tf32(t(q), t(k), t(v), 0.125, 3), ref, allow)
    one = _share(tf32.flash_fwd_tf32(t(q), t(k), t(v), 0.125, 1), ref, allow)
    assert three <= 0.25, three
    assert one > 1.0, one


@pytest.mark.parametrize("N,C,H", [(37, 128, 2), (37, 1024, 16)])
def test_fused_qkv_3xtf32_within_k4_bound_and_1xtf32_outside(N, C, H):
    """K4's fp32 bound (chip_smoke.py `qkv_allowance`): ulp(|ref|) +
    2⁻¹⁷·Σ_k |xn_k|·|w_jk| per element, against the JAX kernel's fp32
    output, on rows with non-zero means and unequal scales."""
    rng = np.random.default_rng(N + C)
    x = (rng.standard_normal((2, N, C)) * rng.uniform(0.5, 2.0, (2, N, 1))
         + 0.5 * rng.standard_normal((2, N, 1))).astype(np.float32)
    ln_w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)  # flax: (in, out)
    b = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    ref = jax_fq.fused_ln_qkv(*(jnp.asarray(a) for a in (x, ln_w, ln_b, w, b)), H)
    xn = n(ln_rows(t(x), t(ln_w), t(ln_b), 1e-6)).astype(np.float64)
    asum = (np.abs(xn) @ np.abs(w.astype(np.float64))).reshape(2, N, 3, H, C // H)
    asum = asum.transpose(2, 0, 3, 1, 4)
    for passes, want_inside in ((3, True), (1, False)):
        got = tf32.fused_ln_qkv_tf32(t(x), t(ln_w), t(ln_b), t(w.T), t(b), H, passes)
        share = max(_share(g, np.asarray(r), _ulp(np.asarray(r)) + 2.0 ** -17 * a)
                    for g, r, a in zip(got, ref, asum))
        assert (share <= 0.25) if want_inside else (share > 1.0), (passes, share)


@pytest.mark.parametrize("dtype,Dh,kernel", [(torch.float32, 64, "tf32x3"),
                                             (torch.bfloat16, 64, "wgmma"),
                                             (torch.float32, 32, "cuda_cores"),
                                             (torch.bfloat16, 16, "cuda_cores")])
def test_k3_names_the_kernel_a_card_call_runs(dtype, Dh, kernel):
    """The wrapper counts a card call under the name of the FlashKernel code
    that `asis_flash_fwd` reports (`KERNELS` follows the launcher's enum).
    A CPU call counts nothing."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    enum = re.search(r"enum FlashKernel \{([^}]*)\}", src).group(1)
    codes = {name: int(code) for name, code in re.findall(r"(\w+) = (\d+)", enum)}
    constant = {"wgmma": "kWgmmaKernel", "tf32x3": "kTf32x3Kernel",
                "cuda_cores": "kCudaCoresKernel"}[kernel]
    assert ff.KERNELS[codes[constant]] == kernel
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 9, Dh),
                                                                   np.float32)).to(dtype)
    before = dict(ff.path_launches)
    ff.flash_fwd(q, q, q, 0.125)
    assert ff.path_launches == before


def test_fp32_gemm_workspace_holds_both_tf32_halves():
    """K4's and K5's fp32 GEMMs get 2·N·K fp32 of scratch on x's device for
    W_hi and W_lo; the bf16 GEMM none."""
    ws = _build.gemm_workspace(torch.zeros(2, 64), 3 * 64 * 64)
    assert ws.dtype == torch.float32 and ws.numel() == 2 * 3 * 64 * 64
    assert _build.gemm_workspace(torch.zeros(2, 64, dtype=torch.bfloat16), 64) is None
