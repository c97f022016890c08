"""The tf32 arithmetic of the fp32 kernels' products, as plain torch.

The fp32 paths of K3 (`csrc/flash_fwd.cu`), K4/K5 (`csrc/ln_gemm.cu`) and
K7 (`csrc/flash_attn_{fwd,bwd}.cu`) run on the tensor cores in TF32, whose
products read 10 explicit mantissa bits of each operand. To keep fp32
accuracy they split every operand x = hi + lo into two tf32 values and sum
three products, lo·hi + hi·lo + hi·hi, in fp32 (3×TF32); lo·lo and lo's own
rounding, ≈ 2⁻²² of a product, are dropped.

`round_tf32` is the card's `cvt.rna.tf32.f32`: round to the nearest tf32
value, ties away from zero (the low 13 bits of the fp32 pattern cleared
after adding half of them), NaN kept. `split_tf32` is the kernels' split.
`matmul_tf32` computes a product from tf32 operands as the kernels do, with
`passes` 3 (their arithmetic) or 1 (one TF32 pass on rounded operands, what
a kernel without the split would compute): each product of two tf32 values
is exact in fp32, so the emulation differs from the kernels only in the
order of the fp32 sums. The emulated K3, K4, K5 and K7 are what
`chip_smoke.py` holds the fp32 bounds against (one pass must break them,
three must not), and `tests/test_torch_tf32_split.py` and
`tests/test_torch_flash_attn_tf32.py` do the same on the CPU against the
JAX package's kernels."""

from __future__ import annotations

from typing import Tuple

import torch

from .flash_attn import MASK_VALUE
from .fused_mlp import gelu
from .layernorm import ln_rows


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 (`cvt.rna.tf32.f32`), as fp32 values."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32: float32 only, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # two's-complement addition is the magnitude's: + half of the 13 bits
    # rounds ties away from zero, a carry moves into the exponent
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo, hi = round_tf32(x), lo = round_tf32(x − hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b from tf32 operands in fp32: 3 passes lo·hi + hi·lo + hi·hi (the
    fp32 kernels' products), 1 pass round(a)·round(b)."""
    if passes == 1:
        return round_tf32(a) @ round_tf32(b)
    if passes != 3:
        raise ValueError(f"matmul_tf32: passes must be 1 or 3, got {passes}")
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_fwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   passes: int = 3) -> torch.Tensor:
    """K3 in fp32 with TF32 products: softmax(q·kᵀ·scale)·v."""
    s = matmul_tf32(q * scale, k.transpose(-1, -2), passes)
    return matmul_tf32(torch.softmax(s, dim=-1), v, passes)


def fused_ln_qkv_tf32(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor, num_heads: int, passes: int = 3,
                      eps: float = 1e-6):
    """K4 in fp32 with TF32 products (`fused_ln_qkv_plain`'s arithmetic)."""
    B, N, C = x.shape
    y = matmul_tf32(ln_rows(x, ln_w, ln_b, eps), w.float().t(), passes) + b.float()
    y = y.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
    return y[0].contiguous(), y[1].contiguous(), y[2].contiguous()


def fused_ln_mlp_tf32(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      gamma: torch.Tensor, passes: int = 3, eps: float = 1e-6,
                      approximate: bool = True) -> torch.Tensor:
    """K5 in fp32 with TF32 products (`fused_ln_mlp_plain`'s arithmetic)."""
    h = gelu(matmul_tf32(ln_rows(x, ln_w, ln_b, eps), w1.float().t(), passes) + b1.float(),
             approximate)
    return x + gamma.float() * (matmul_tf32(h, w2.float().t(), passes) + b2.float())


def _scores_tf32(q, k, scale, segment_ids, passes):
    s = matmul_tf32(q.float(), k.float().transpose(-1, -2), passes) * scale
    if segment_ids is None:
        return s
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    return s + torch.where(same, 0.0, MASK_VALUE)


def flash_attn_fwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        segment_ids=None, passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's forward in fp32 with TF32 products, as the kernel computes it
    (the scale after q·kᵀ, p unrounded, o = (p·v) / l): (o, lse)."""
    s = _scores_tf32(q, k, scale, segment_ids, passes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return matmul_tf32(p, v.float(), passes) / l, (m + torch.log(l)).squeeze(-1)


def flash_attn_bwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, scale: float, segment_ids=None,
                        passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's backward in fp32 with TF32 products (`flash_attn_bwd_plain`'s
    formulas, p and ds unrounded): (dq, dk, dv)."""
    q, k, v, do = (x.float() for x in (q, k, v, do))
    di = (o.float() * do).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores_tf32(q, k, scale, segment_ids, passes) - lse.unsqueeze(-1))
    dv = matmul_tf32(p.transpose(-1, -2), do, passes)
    ds = (matmul_tf32(do, v.transpose(-1, -2), passes) - di) * p * scale
    return (matmul_tf32(ds, k, passes), matmul_tf32(ds.transpose(-1, -2), q, passes), dv)
