"""Transformer layers of the DINOv2 backbone (counterpart of the JAX package's
`models/layers.py`). Submodule and parameter names follow DINOv2 so that its
state dicts load without remapping. Tokens are (B, N, C); images are NHWC.

`Block` runs one of the two configurations that the JAX package's entry
points run, named by the JAX fields (attn_impl, ln_impl, qkv_impl,
mlp_impl):
  * the deployed configuration of the frozen walks ("flash_fwd" and three
    "pallas", the default): fused LN → qkv → head split (K4), forward-only
    attention (K3), then fused LN → MLP → LayerScale → residual (K5) where
    the FFN is the "mlp" and the block has LayerScale, with the GELU the
    `Mlp` declares (tanh or exact), else LayerNorm (K6) and the plain FFN
    (`Mlp` without LayerScale, or `SwiGLUFFNFused`);
  * the SSL step's trained configuration ("flash" and three "xla"):
    `nn.LayerNorm`, the qkv Linear, flash attention with segment ids (K7,
    forward and backward), proj, the plain FFN, LayerScale, all
    differentiable.
A block built with `init_values=None` has no LayerScale (DINO-v1's). The
modules hold the parameters under their unfused names; the kernels read
them there. `Block(..., return_attention=True)` returns the attention
probabilities instead (the DINO attention-map hook).

A windowed block (`windowed=True`, the Mask2Former windowed backbones)
attends within non-overlapping window_size² windows of the token grid
(`windowed_sdpa`, plain torch, as the JAX package's is plain XLA): its
LayerNorm before the attention is K6 in the deployed configuration, its
qkv and proj are the Linears, and its MLP half is K5 as in a global block;
K4 and K3 run only in the global blocks."""

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


def windowed_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  hw: Tuple[int, int], window: int) -> torch.Tensor:
    """Attention within non-overlapping window² windows of the (h, w) token
    grid (the JAX package's `layers.py:windowed_sdpa`): q, k, v (B, h·w, H,
    Dh) are zero-padded to a multiple of the window, and the padded
    positions take part in the softmax with score 0 (they are not masked),
    as the reference pads the projected maps. The scores are rounded to
    q's dtype, the softmax runs in fp32 (at least) and its probabilities
    are rounded to q's dtype before the product with v."""
    B, N, H, Dh = q.shape
    h, w = hw
    ph, pw = (-h) % window, (-w) % window
    hp, wp = h + ph, w + pw

    def to_windows(t):
        t = F.pad(t.reshape(B, h, w, H, Dh), (0, 0, 0, 0, 0, pw, 0, ph))
        t = t.reshape(B, hp // window, window, wp // window, window, H, Dh)
        return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, H, window * window, Dh)

    qw, kw, vw = to_windows(q * scale), to_windows(k), to_windows(v)
    s = qw @ kw.transpose(-1, -2)
    a = torch.softmax(s, dim=-1, dtype=torch.promote_types(s.dtype, torch.float32))
    out = a.to(q.dtype) @ vw                                # (B·nw, H, win², Dh)
    out = out.reshape(B, hp // window, wp // window, H, window, window, Dh)
    out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, hp, wp, H, Dh)
    return out[:, :h, :w].reshape(B, N, H, Dh)


class Block(nn.Module):
    """Pre-norm transformer block, with LayerScale unless `init_values` is
    None. The deployed configuration is forward only (the walks are
    frozen): its kernels raise when an input needs a gradient. The trained
    one takes `segment_ids` (B, N) int32: a token attends only to tokens of
    its own segment. A windowed block takes the token grid `hw`; a leading
    cls token passes its attention as its own v."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 1e-5, gelu_approx: bool = False,
                 ffn_layer: str = "mlp", attn_impl: str = "flash_fwd", ln_impl: str = "pallas",
                 qkv_impl: str = "pallas", mlp_impl: str = "pallas", windowed: bool = False,
                 window_size: int = 14):
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
        # K5 computes an "mlp" FFN (either GELU) with LayerScale, and only that
        self.fused_mlp = ffn_layer == "mlp" and init_values is not None
        self.attn_impl = attn_impl
        self.windowed = windowed
        self.window_size = window_size

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor = None,
                return_attention: bool = False,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if return_attention:
            return self._attention_probs(x)
        if self.windowed and segment_ids is not None:
            raise ValueError("a windowed block takes no segment ids")
        if self.attn_impl == "flash":
            return self._trained(x, segment_ids, hw)
        if segment_ids is not None:
            raise ValueError("the deployed configuration takes no segment ids")
        B, N, C = x.shape
        if self.windowed:
            h = layernorm(x, self.norm1.weight, self.norm1.bias, self.norm1.eps)
            x = x + self.ls1(self._windowed_attention(h, hw))
        else:
            q, k, v = self._qkv(x)                                  # (B, H, N, Dh)
            out = flash_fwd(q, k, v, 1.0 / math.sqrt(C // self.attn.num_heads))
            x = x + self.ls1(self.attn.proj(out.transpose(1, 2).reshape(B, N, C)))
        if self.fused_mlp:
            mlp = self.mlp
            return fused_ln_mlp(x, self.norm2.weight, self.norm2.bias, mlp.fc1.weight,
                                mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias, self.ls2.gamma,
                                self.norm2.eps, mlp.approximate == "tanh")
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

    def _windowed_attention(self, h: torch.Tensor, hw) -> torch.Tensor:
        """The windowed attention of the normed tokens h (B, N, C): qkv,
        `windowed_sdpa` over the patch tokens, proj."""
        if hw is None:
            raise ValueError("windowed attention needs the token grid `hw`")
        B, N, C = h.shape
        H = self.attn.num_heads
        n_cls = N - hw[0] * hw[1]
        if n_cls not in (0, 1):
            raise ValueError(f"token count {N} does not match grid {tuple(hw)}")
        q, k, v = self.attn.qkv(h).reshape(B, N, 3, H, C // H).unbind(2)   # (B, N, H, Dh)
        out = windowed_sdpa(q[:, n_cls:], k[:, n_cls:], v[:, n_cls:],
                            1.0 / math.sqrt(C // H), hw, self.window_size)
        out = torch.cat([v[:, :n_cls], out], dim=1)
        return self.attn.proj(out.reshape(B, N, C))

    def _trained(self, x: torch.Tensor, segment_ids, hw=None) -> torch.Tensor:
        B, N, C = x.shape
        if self.windowed:
            x = x + self.ls1(self._windowed_attention(self.norm1(x), hw))
        else:
            q, k, v = self._qkv(x)                                  # (B, H, N, Dh)
            out = flash_attn(q, k, v, 1.0 / math.sqrt(C // self.attn.num_heads), segment_ids)
            x = x + self.ls1(self.attn.proj(out.transpose(1, 2).reshape(B, N, C)))
        return x + self.ls2(self.mlp(self.norm2(x)))
