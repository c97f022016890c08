"""Transformer layers of the DINOv2 backbone (counterpart of the JAX package's
`models/layers.py`). Submodule and parameter names follow DINOv2 so that its
state dicts load without remapping. Tokens are (B, N, C); images are NHWC.

`Block` runs the JAX package's deployed configuration of the frozen walks
(attn_impl "flash_fwd", qkv_impl, mlp_impl and ln_impl "pallas"): fused
LN → qkv → head split (K4), attention (K3), then fused LN → MLP →
LayerScale → residual (K5) with tanh GELU, or LayerNorm (K6) and the plain
`Mlp` with exact GELU. The modules hold the parameters under their unfused
names; the kernels read them there."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_fwd import flash_fwd
from ..ops.fused_mlp import fused_ln_mlp
from ..ops.fused_qkv import fused_ln_qkv
from ..ops.layernorm import layernorm


class PatchEmbed(nn.Module):
    """Image → tokens by a stride-p conv. NHWC in, (B, Hp·Wp, C) out."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 768, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        B, H, W, _ = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size ({H},{W}) not divisible by patch size {p}")
        y = self.proj(x.permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2), (H // p, W // p)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_approx: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    """The attention's parameters: qkv and proj Linears. `Block` runs them."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale, forward only (the walks
    are frozen): the kernels raise when an input needs a gradient."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5, gelu_approx: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx)
        self.ls2 = LayerScale(dim, init_values)
        self.gelu_approx = gelu_approx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        attn, H = self.attn, self.attn.num_heads
        q, k, v = fused_ln_qkv(x, self.norm1.weight, self.norm1.bias, attn.qkv.weight,
                               attn.qkv.bias, H, self.norm1.eps)       # (B, H, N, Dh)
        out = flash_fwd(q, k, v, 1.0 / math.sqrt(C // H))
        x = x + self.ls1(attn.proj(out.transpose(1, 2).reshape(B, N, C)))
        if self.gelu_approx:
            mlp = self.mlp
            return fused_ln_mlp(x, self.norm2.weight, self.norm2.bias, mlp.fc1.weight,
                                mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias, self.ls2.gamma,
                                self.norm2.eps)
        h = layernorm(x, self.norm2.weight, self.norm2.bias, self.norm2.eps)
        return x + self.ls2(self.mlp(h))
