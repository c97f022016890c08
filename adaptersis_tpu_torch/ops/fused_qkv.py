"""Fused LayerNorm → qkv projection → head split (K4) of the frozen ViT
block's attention half.

`fused_ln_qkv` launches the hand-written CUDA kernels (`csrc/layernorm.cu`
for xn, then `csrc/ln_gemm.cu`'s GEMM: bf16 in one pass on the tensor
cores, fp32 in three TF32 passes that keep fp32 accuracy, `ops/tf32.py`)
on a CUDA tensor and runs `fused_ln_qkv_plain` on a CPU tensor. Both compute
the JAX package's `_kernel` of `ops/fused_qkv.py`: xn = LN(x) in fp32
rounded to x's dtype, y = xn·Wᵀ accumulated in fp32, plus the fp32 bias,
rounded once to x's dtype (not twice, as its `reference_ln_qkv` does), and
q, k, v stored in (B, H, N, Dh) — the layout the attention kernel (K3)
reads, with no relayout and no ones column.

Forward only: a call that would need a gradient raises on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import check_rows, gemm_workspace, launch, mat, params, plain
from .layernorm import ln_pass, ln_rows

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0

QKV = 0  # asis_ln_gemm's epilogue


@plain
def fused_ln_qkv_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, num_heads: int,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, N, C = x.shape
    dt = x.dtype
    xn = ln_rows(x, ln_w, ln_b, eps).to(dt).float()
    y = (xn @ w.to(dt).float().t() + b.float()).to(dt)
    y = y.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
    return y[0].contiguous(), y[1].contiguous(), y[2].contiguous()


def fused_ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, num_heads: int,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, N, C) bf16 or fp32; ln_w, ln_b (C,); w (3C, C) and b (3C,) as
    torch's Linear stores them. Returns q, k, v, each a contiguous
    (B, H, N, C/H) tensor in x's dtype."""
    _build.forbid_grad("fused_ln_qkv", (x, ln_w, ln_b, w, b))
    if x.device.type == "cpu":
        return fused_ln_qkv_plain(x, ln_w, ln_b, w, b, num_heads, eps)
    check_rows("fused_ln_qkv", x)
    B, N, C = x.shape
    if C % num_heads or (C // num_heads) % 8:
        raise ValueError(f"fused_ln_qkv: width {C} does not split into {num_heads} heads "
                         "of a width that is a multiple of 8")
    Dh = C // num_heads
    wd = mat(w, (3 * C, C), "fused_ln_qkv w", x)
    (lw, lb, bias), pbf = params("fused_ln_qkv", x, ("ln_w", ln_w, C), ("ln_b", ln_b, C),
                                 ("b", b, 3 * C))
    q, k, v = (x.new_empty((B, num_heads, N, Dh)) for _ in range(3))
    bf16 = x.dtype == torch.bfloat16
    ws = gemm_workspace(x, 3 * C * C)
    lib = _build.library()
    a = ln_pass(x.view(B * N, C), lw, lb, pbf, eps)
    err = launch(x, lib.asis_ln_gemm, QKV, a.data_ptr(), wd.data_ptr(), bias.data_ptr(), B * N,
                 3 * C, C, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, N, num_heads,
                 Dh, int(bf16), pbf, None if ws is None else ws.data_ptr())
    _build.check(lib, err, "fused_ln_qkv")
    global launches
    launches += 1
    return q, k, v
