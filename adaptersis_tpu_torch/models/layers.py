"""Transformer layers of the DINOv2 backbone (counterpart of the JAX package's
`models/layers.py`). Submodule and parameter names follow DINOv2 so that its
state dicts load without remapping. Tokens are (B, N, C); images are NHWC.

`Block` runs one of the two configurations that the JAX package's entry
points run, named by the JAX fields (attn_impl, ln_impl, qkv_impl,
mlp_impl):
  * the deployed configuration of the frozen walks ("flash_fwd" and three
    "pallas", the default): fused LN → qkv → head split (K4), forward-only
    attention (K3), then fused LN → MLP → LayerScale → residual (K5) where
    the FFN is the "mlp" with tanh GELU and the block has LayerScale, else
    LayerNorm (K6) and the plain FFN (`Mlp` with exact GELU, or
    `SwiGLUFFNFused`);
  * the SSL step's trained configuration ("flash" and three "xla"):
    `nn.LayerNorm`, the qkv Linear, flash attention with segment ids (K7,
    forward and backward), proj, the plain FFN, LayerScale, all
    differentiable.
A block built with `init_values=None` has no LayerScale (DINO-v1's). The
modules hold the parameters under their unfused names; the kernels read
them there. `Block(..., return_attention=True)` returns the attention
probabilities instead (the DINO attention-map hook)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attn import flash_attn
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


class SwiGLUFFNFused(nn.Module):
    """DINOv2's SwiGLU FFN (vit_giant2): w12 → silu(x1)·x2 → w3, with the
    hidden width (int(dim·4·2/3) + 7) // 8 · 8. Plain torch: the JAX package
    computes it in plain XLA too."""

    def __init__(self, dim: int):
        super().__init__()
        hidden = (int(dim * 4 * 2 / 3) + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


FFN_LAYERS = ("mlp", "swiglufused")


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


# (attn_impl, ln_impl, qkv_impl, mlp_impl) of the two configurations
DEPLOYED = ("flash_fwd", "pallas", "pallas", "pallas")
TRAINED = ("flash", "xla", "xla", "xla")


def check_impls(attn_impl: str, ln_impl: str, qkv_impl: str, mlp_impl: str) -> None:
    impls = (attn_impl, ln_impl, qkv_impl, mlp_impl)
    if impls not in (DEPLOYED, TRAINED):
        raise ValueError(f"(attn_impl, ln_impl, qkv_impl, mlp_impl) = {impls} is not ported: "
                         f"the port runs {DEPLOYED} (the frozen walks) or {TRAINED} (SSL)")


class Block(nn.Module):
    """Pre-norm transformer block, with LayerScale unless `init_values` is
    None. The deployed configuration is forward only (the walks are
    frozen): its kernels raise when an input needs a gradient. The trained
    one takes `segment_ids` (B, N) int32: a token attends only to tokens of
    its own segment."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 1e-5, gelu_approx: bool = False,
                 ffn_layer: str = "mlp", attn_impl: str = "flash_fwd", ln_impl: str = "pallas",
                 qkv_impl: str = "pallas", mlp_impl: str = "pallas"):
        super().__init__()
        check_impls(attn_impl, ln_impl, qkv_impl, mlp_impl)
        if ffn_layer not in FFN_LAYERS:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}; choose from {FFN_LAYERS}")

        def ls():
            return nn.Identity() if init_values is None else LayerScale(dim, init_values)

        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = ls()
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = (Mlp(dim, int(dim * mlp_ratio), gelu_approx) if ffn_layer == "mlp"
                    else SwiGLUFFNFused(dim))
        self.ls2 = ls()
        # K5 computes an "mlp" FFN with tanh GELU and LayerScale, and only that
        self.fused_mlp = ffn_layer == "mlp" and gelu_approx and init_values is not None
        self.attn_impl = attn_impl

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor = None,
                return_attention: bool = False) -> torch.Tensor:
        if return_attention:
            return self._attention_probs(x)
        if self.attn_impl == "flash":
            return self._trained(x, segment_ids)
        if segment_ids is not None:
            raise ValueError("the deployed configuration takes no segment ids")
        B, N, C = x.shape
        q, k, v = self._qkv(x)                                      # (B, H, N, Dh)
        out = flash_fwd(q, k, v, 1.0 / math.sqrt(C // self.attn.num_heads))
        x = x + self.ls1(self.attn.proj(out.transpose(1, 2).reshape(B, N, C)))
        if self.fused_mlp:
            mlp = self.mlp
            return fused_ln_mlp(x, self.norm2.weight, self.norm2.bias, mlp.fc1.weight,
                                mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias, self.ls2.gamma,
                                self.norm2.eps)
        h = layernorm(x, self.norm2.weight, self.norm2.bias, self.norm2.eps)
        return x + self.ls2(self.mlp(h))

    def _qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v (B, H, N, Dh): K4 in the deployed configuration, the
        LayerNorm and the qkv Linear in the trained one."""
        attn, H = self.attn, self.attn.num_heads
        if self.attn_impl == "flash":
            B, N, C = x.shape
            qkv = attn.qkv(self.norm1(x)).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
            return tuple(t.contiguous() for t in qkv)
        return fused_ln_qkv(x, self.norm1.weight, self.norm1.bias, attn.qkv.weight,
                            attn.qkv.bias, H, self.norm1.eps)

    def _attention_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The block's attention probabilities (B, H, N, N) in fp32: the
        softmax of (q·scale)·kᵀ over the q and k that the block's attention
        reads, in plain torch (the JAX package's hook is a plain einsum)."""
        q, k, _ = self._qkv(x)
        s = (q.float() * (1.0 / math.sqrt(q.shape[-1]))) @ k.float().transpose(-1, -2)
        return torch.softmax(s, dim=-1)

    def _trained(self, x: torch.Tensor, segment_ids) -> torch.Tensor:
        B, N, C = x.shape
        q, k, v = self._qkv(x)                                      # (B, H, N, Dh)
        out = flash_attn(q, k, v, 1.0 / math.sqrt(C // self.attn.num_heads), segment_ids)
        x = x + self.ls1(self.attn.proj(out.transpose(1, 2).reshape(B, N, C)))
        return x + self.ls2(self.mlp(self.norm2(x)))
