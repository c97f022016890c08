"""DINOv2 Vision Transformer backbone (counterpart of the JAX package's
`models/vit.py`), split into `embed` / `run_blocks` / `final_norm` so the
adapter segmentor can interleave its adapters between the last blocks.

Two configurations (`layers.Block`): the deployed frozen walks (the
default) and the SSL step's trained backbone (attn_impl="flash", ln_impl,
qkv_impl and mlp_impl "xla"), which adds the iBOT mask-token substitution
(`embed(..., masks=)`, `forward_with_masks`) and the packed multicrop
forward (`forward_packed_crops`).

Every backbone of the JAX package's `ARCHS` but the windowed ones: DINOv2's
ViT-S/B/L and ViT-g/14 (SwiGLU FFN), vit_tiny, and DINO-v1's
(`DinoV1VisionTransformer`, no LayerScale). `num_register_tokens` adds
register tokens after the cls token, after the positional embedding;
`get_last_selfattention` is the DINO attention-map hook."""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.layernorm import layernorm
from ..ops.resize import resize_bicubic
from .layers import Block, PatchEmbed


class DinoVisionTransformer(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 1e-5, gelu_approx: bool = False,
                 ffn_layer: str = "mlp", num_register_tokens: int = 0,
                 attn_impl: str = "flash_fwd", ln_impl: str = "pallas",
                 qkv_impl: str = "pallas", mlp_impl: str = "pallas"):
        super().__init__()
        impls = dict(attn_impl=attn_impl, ln_impl=ln_impl, qkv_impl=qkv_impl, mlp_impl=mlp_impl)
        self.ln_impl = ln_impl
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_register_tokens = num_register_tokens
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        n_base = (img_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, n_base + 1, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, init_values, gelu_approx, ffn_layer, **impls)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos_encoding(self, hp: int, wp: int) -> torch.Tensor:
        """Bicubic resize of the pos-embed grid to (hp, wp), in fp32, with
        DINOv2's scale_factor (hp + 0.1)/m. Returns (1, 1 + hp·wp, C)."""
        pe = self.pos_embed.float()
        m = int(round((pe.shape[1] - 1) ** 0.5))
        if (hp, wp) == (m, m):
            return pe
        grid = pe[:, 1:].reshape(1, m, m, self.embed_dim)
        grid = resize_bicubic(grid, (hp, wp), scales=((hp + 0.1) / m, (wp + 0.1) / m))
        return torch.cat([pe[:, :1], grid.reshape(1, hp * wp, self.embed_dim)], dim=1)

    def embed(self, x: torch.Tensor, with_pos_cls: bool = True,
              masks: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Patch-embed NHWC x. with_pos_cls=False gives the adapter re-walk's
        tokens: no cls token and no positional embedding. `masks` (B, hp·wp)
        bool replaces masked patch tokens by the mask token before cls and
        pos (the iBOT substitution). The register tokens, if any, follow the
        cls token, after the positional embedding."""
        tokens, (hp, wp) = self.patch_embed(x)
        if masks is not None:
            tokens = torch.where(masks[..., None], self.mask_token.to(tokens.dtype), tokens)
        if not with_pos_cls:
            return tokens, (hp, wp)
        B = tokens.shape[0]
        cls = self.cls_token.to(tokens.dtype).expand(B, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.interpolate_pos_encoding(hp, wp).to(tokens.dtype)
        if self.num_register_tokens:
            reg = self.register_tokens.to(tokens.dtype).expand(B, -1, -1)
            tokens = torch.cat([tokens[:, :1], reg, tokens[:, 1:]], dim=1)
        return tokens, (hp, wp)

    def run_blocks(self, x: torch.Tensor, start: int, stop: int,
                   segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.blocks[start:stop]:
            x = blk(x, segment_ids)
        return x

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_with_masks(x)

    def forward_with_masks(self, x: torch.Tensor, masks: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
        """The full forward: the normed cls, register and patch tokens, and
        the last block's output before the norm."""
        tokens, _ = self.embed(x, with_pos_cls=True, masks=masks)
        tokens = self.run_blocks(tokens, 0, self.depth)
        normed = self.final_norm(tokens)
        r = self.num_register_tokens
        return {"x_norm_clstoken": normed[:, 0], "x_norm_regtokens": normed[:, 1:1 + r],
                "x_norm_patchtokens": normed[:, 1 + r:], "x_prenorm": tokens}

    def forward_packed_crops(self, g: torch.Tensor, l: torch.Tensor,
                             masks: Optional[torch.Tensor] = None
                             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """All crops through one attention call per block: row r packs
        global crop r (masks apply here) with local crops r·k .. r·k + k − 1,
        each in a segment of its own (segment ids 0, 1, .., k), so each
        crop's tokens attend only to its own. g: (2B, Sg, Sg, 3), l: (k·2B,
        Sl, Sl, 3). Returns the global and the local crops' normed cls and
        patch tokens."""
        tg, _ = self.embed(g, with_pos_cls=True, masks=masks)
        tl, _ = self.embed(l, with_pos_cls=True)
        B2, Ng, C = tg.shape
        nB, Nl, _ = tl.shape
        if nB % B2:
            raise ValueError(f"{nB} local crops not divisible by {B2} global rows")
        k = nB // B2
        x = torch.cat([tg, tl.to(tg.dtype).reshape(B2, k * Nl, C)], dim=1)
        seg = torch.cat([torch.zeros(Ng, dtype=torch.int32, device=x.device),
                         torch.arange(1, k + 1, dtype=torch.int32,
                                      device=x.device).repeat_interleave(Nl)])
        x = self.run_blocks(x, 0, self.depth, seg.expand(B2, -1).contiguous())
        x = self.final_norm(x)
        xg, xl = x[:, :Ng], x[:, Ng:].reshape(nB, Nl, C)
        r = self.num_register_tokens
        return ({"x_norm_clstoken": xg[:, 0], "x_norm_patchtokens": xg[:, 1 + r:]},
                {"x_norm_clstoken": xl[:, 0], "x_norm_patchtokens": xl[:, 1 + r:]})

    def collect_block_outputs(self, x: torch.Tensor, taps: Sequence[int]) -> List[torch.Tensor]:
        """Run all blocks; return the un-normed outputs of the blocks in `taps`."""
        want = set(taps)
        out = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                out.append(x)
        return out

    def get_intermediate_layers(self, x: torch.Tensor, n: int = 1, reshape: bool = False,
                                return_class_token: bool = False, norm: bool = True) -> tuple:
        """The outputs of the last n blocks (final-normed with `norm`): DINOv2's
        feature tap. The patch tokens, as (B, hp, wp, C) maps with `reshape`,
        and with `return_class_token` (patch tokens, cls token) pairs."""
        tokens, (hp, wp) = self.embed(x, with_pos_cls=True)
        outs = self.collect_block_outputs(tokens, range(self.depth - n, self.depth))
        if norm:
            outs = [self.final_norm(o) for o in outs]
        patches = [o[:, 1 + self.num_register_tokens:] for o in outs]
        if reshape:
            patches = [p.reshape(x.shape[0], hp, wp, self.embed_dim) for p in patches]
        if return_class_token:
            return tuple(zip(patches, [o[:, 0] for o in outs]))
        return tuple(patches)

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's attention probabilities (B, heads, N, N), fp32:
        the DINO attention-visualisation hook."""
        tokens, _ = self.embed(x, with_pos_cls=True)
        tokens = self.run_blocks(tokens, 0, self.depth - 1)
        return self.blocks[-1](tokens, return_attention=True)

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Deployed: the LayerNorm kernel (K6), whose output keeps x's dtype,
        also under autocast, as the JAX package's fused LayerNorm does. SSL:
        the plain `nn.LayerNorm` (K6 is forward only)."""
        if self.ln_impl == "xla":
            return self.norm(x)
        return layernorm(x, self.norm.weight, self.norm.bias, self.norm.eps)


class DinoV1VisionTransformer(DinoVisionTransformer):
    """DINO-v1's ViT on the shared block stack: built with init_values=None
    (no LayerScale); `forward` returns the final-normed patch tokens (cls
    dropped), and `get_intermediate_layers(x, n)` the last n blocks'
    final-normed token sequences with the cls token kept."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.embed(x, with_pos_cls=True)
        return self.final_norm(self.run_blocks(tokens, 0, self.depth))[:, 1:]

    def get_intermediate_layers(self, x: torch.Tensor, n: int = 1, **_) -> List[torch.Tensor]:
        tokens, _ = self.embed(x, with_pos_cls=True)
        outs = self.collect_block_outputs(tokens, range(self.depth - n, self.depth))
        return [self.final_norm(o) for o in outs]


ARCHS = {
    "vit_test": partial(DinoVisionTransformer, embed_dim=64, depth=5, num_heads=4),
    "vit_small": partial(DinoVisionTransformer, embed_dim=384, depth=12, num_heads=6),
    "vit_base": partial(DinoVisionTransformer, embed_dim=768, depth=12, num_heads=12),
    "vit_large": partial(DinoVisionTransformer, embed_dim=1024, depth=24, num_heads=16),
    "vit_giant2": partial(DinoVisionTransformer, embed_dim=1536, depth=40, num_heads=24,
                          ffn_layer="swiglufused"),
    "vit_tiny": partial(DinoVisionTransformer, embed_dim=192, depth=12, num_heads=3),
    "vit_tiny_v1": partial(DinoV1VisionTransformer, embed_dim=192, depth=12, num_heads=3,
                           init_values=None),
    "vit_small_v1": partial(DinoV1VisionTransformer, embed_dim=384, depth=12, num_heads=6,
                            init_values=None),
    "vit_base_v1": partial(DinoV1VisionTransformer, embed_dim=768, depth=12, num_heads=12,
                           init_values=None),
}
# the JAX package's windowed-attention backbones of the Mask2Former head
WINDOWED = ("vit_small_windowed", "vit_base_windowed", "vit_large_windowed",
            "vit_giant2_windowed")


def build_backbone(arch: str, img_size: int = 518, patch_size: int = 14,
                   **kw) -> DinoVisionTransformer:
    if arch in WINDOWED:
        raise ValueError(f"unknown arch {arch!r}: the windowed backbones are not ported yet "
                         "(ROADMAP.md, M12: the Mask2Former head)")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch](img_size=img_size, patch_size=patch_size, **kw)
