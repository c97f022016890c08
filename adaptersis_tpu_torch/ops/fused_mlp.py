"""Fused LayerNorm → fc1 → GELU → fc2 → LayerScale → residual (K5) of the
frozen ViT block's MLP half, with the tanh GELU or the exact (erf) one.

`fused_ln_mlp` launches the hand-written CUDA kernels on a CUDA tensor
(`csrc/layernorm.cu`'s LayerNorm, then two GEMMs of `csrc/ln_gemm.cu`: fc1
with a bias + GELU epilogue of the flavour asked for, fc2 with a bias +
LayerScale + residual epilogue; bf16 in one pass on the tensor cores, fp32
in three TF32 passes that keep fp32 accuracy, `ops/tf32.py`) and runs
`fused_ln_mlp_plain` on a CPU tensor. Both compute the JAX package's
`reference_ln_mlp` of `ops/fused_mlp.py` (with `approximate=True`, what its
`_kernel` computes): xn = LN(x) rounded to x's dtype; h = gelu(xn·W1ᵀ + b1)
in fp32, rounded once; y = h·W2ᵀ + b2 in fp32; out = (x + γ·y) in fp32,
rounded to x's dtype. The TPU kernel kept the hidden in VMEM; here it makes
one round trip through device memory in x's dtype, the value the TPU kernel
rounds it to. The JAX package's blocks with exact GELU run the MLP unfused
(LN, Linear, GELU, Linear, LayerScale, residual); fused, the same formula
rounds the hidden once and the output once instead of after each step,
which in fp32 changes only the order of the sums.

Forward only: a call that would need a gradient raises on either device.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._build import check_rows, gemm_workspace, launch, mat, params, plain
from .layernorm import ln_pass, ln_rows

# Kernel launches since the last reset (one per call: the LayerNorm pass,
# fc1, fc2); chip_smoke.py reads it.
launches = 0

GELU, RESID, GELU_ERF = 1, 2, 3  # asis_ln_gemm's epilogues


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), term by term."""
    return h * (0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (h + 0.044715 * (h * h * h)))))


def gelu_erf(h: torch.Tensor) -> torch.Tensor:
    """The exact GELU as F.gelu(approximate="none") computes it: 0.5·h·(1 +
    erf(h·√½))."""
    return 0.5 * h * (1.0 + torch.erf(h * math.sqrt(0.5)))


def gelu(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    return gelu_tanh(h) if approximate else gelu_erf(h)


@plain
def fused_ln_mlp_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, eps: float = 1e-6,
                       approximate: bool = True) -> torch.Tensor:
    dt = x.dtype
    xn = ln_rows(x, ln_w, ln_b, eps).to(dt).float()
    h = gelu(xn @ w1.to(dt).float().t() + b1.float(), approximate).to(dt).float()
    y = h @ w2.to(dt).float().t() + b2.float()
    return (x.float() + gamma.float() * y).to(dt)


def fused_ln_mlp(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6, approximate: bool = True) -> torch.Tensor:
    """x (..., C) bf16 or fp32; ln_w, ln_b, b2, gamma (C,); w1 (Hd, C), b1
    (Hd,) and w2 (C, Hd) as torch's Linear stores them; `approximate`: the
    tanh GELU, else the exact one. Returns x's shape and dtype."""
    _build.forbid_grad("fused_ln_mlp", (x, ln_w, ln_b, w1, b1, w2, b2, gamma))
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate)
    check_rows("fused_ln_mlp", x)
    C = x.shape[-1]
    Hd = w1.shape[0]
    if Hd % 64:
        raise ValueError(f"fused_ln_mlp: the hidden width must be a multiple of 64, got {Hd}")
    x2 = x.view(-1, C)
    R = x2.shape[0]
    w1d, w2d = mat(w1, (Hd, C), "fused_ln_mlp w1", x), mat(w2, (C, Hd), "fused_ln_mlp w2", x)
    (lw, lb, b1d, b2d, g), pbf = params("fused_ln_mlp", x, ("ln_w", ln_w, C), ("ln_b", ln_b, C),
                                        ("b1", b1, Hd), ("b2", b2, C), ("gamma", gamma, C))
    hidden = x.new_empty((R, Hd))
    out = torch.empty_like(x)
    bf16 = x.dtype == torch.bfloat16
    ws = gemm_workspace(x, Hd * C)  # fc1's, then fc2's (stream order)
    wsp = None if ws is None else ws.data_ptr()
    lib = _build.library()
    a = ln_pass(x2, lw, lb, pbf, eps)
    epi = GELU if approximate else GELU_ERF
    err = launch(x, lib.asis_ln_gemm, epi, a.data_ptr(), w1d.data_ptr(), b1d.data_ptr(), R, Hd,
                 C, hidden.data_ptr(), None, None, None, None, 0, 0, 0, int(bf16), pbf, wsp)
    _build.check(lib, err, "fused_ln_mlp fc1")
    err = launch(x, lib.asis_ln_gemm, RESID, hidden.data_ptr(), w2d.data_ptr(), b2d.data_ptr(),
                 R, C, Hd, out.data_ptr(), None, None, x2.data_ptr(), g.data_ptr(), 0, 0, 0,
                 int(bf16), pbf, wsp)
    _build.check(lib, err, "fused_ln_mlp fc2")
    global launches
    launches += 1
    return out
