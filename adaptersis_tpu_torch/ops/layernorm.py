"""Row LayerNorm (K6), also the LayerNorm pass before K4's and K5's GEMMs.

`layernorm` launches the hand-written CUDA kernel (`csrc/layernorm.cu`) on a
CUDA tensor and runs `layernorm_plain` on a CPU tensor. Both compute the JAX
package's `_ln_kernel`: fp32 statistics in the fast-variance form
var = E[x²] − E[x]² (flax's, not torch's two-pass form), then
(x − mean)·(rstd·w) + b, rounded to x's dtype.

Forward only, like the JAX kernel on the frozen walks: a call that would need
a gradient raises on either device rather than cut the gradient silently.
K4 and K5 (`ops/fused_qkv.py`, `ops/fused_mlp.py`) take their GEMM's input
from the same kernel (`ln_pass`), in both dtypes.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import check_rows, launch, params, plain

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def ln_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm of the last axis as the TPU kernels compute it."""
    xf = x.float()
    inv_c = 1.0 / x.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv_c
    var = (xf * xf).sum(-1, keepdim=True) * inv_c - mean * mean
    return (xf - mean) * (torch.rsqrt(var + eps) * w.float()) + b.float()


@plain
def layernorm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    return ln_rows(x, w, b, eps).to(x.dtype)


def ln_pass(x2: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, pbf: int,
            eps: float) -> torch.Tensor:
    """The LayerNorm kernel on a checked (R, C) CUDA tensor with parameters
    from `params`: K4's and K5's normalised input. Not counted as a launch
    of K6: it is part of theirs."""
    R, C = x2.shape
    out = torch.empty_like(x2)
    lib = _build.library()
    err = launch(x2, lib.asis_layernorm, x2.data_ptr(), wd.data_ptr(), bd.data_ptr(),
                 out.data_ptr(), R, C, float(eps), int(x2.dtype == torch.bfloat16), pbf)
    _build.check(lib, err, "layernorm")
    return out


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of the last axis of x (..., C), bf16 or fp32; w, b (C,) in
    any float dtype. Returns x's shape and dtype."""
    _build.forbid_grad("layernorm", (x, w, b))
    if x.is_cpu:
        return layernorm_plain(x, w, b, eps)
    check_rows("layernorm", x)
    C = x.shape[-1]
    (wd, bd), pbf = params("layernorm", x, ("w", w, C), ("b", b, C))
    out = ln_pass(x.view(-1, C), wd, bd, pbf, eps).view(x.shape)
    global launches
    launches += 1
    return out
