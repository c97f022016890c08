"""DINOv2 Vision Transformer backbone (counterpart of the JAX package's
`models/vit.py`), split into `embed` / `run_blocks` / `final_norm` so the
adapter segmentor can interleave its adapters between the last blocks."""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.layernorm import layernorm
from ..ops.resize import resize_bicubic
from .layers import Block, PatchEmbed


class DinoVisionTransformer(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5, gelu_approx: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        n_base = (img_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, n_base + 1, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, init_values, gelu_approx)
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

    def embed(self, x: torch.Tensor, with_pos_cls: bool = True
              ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Patch-embed NHWC x. with_pos_cls=False gives the adapter re-walk's
        tokens: no cls token and no positional embedding."""
        tokens, (hp, wp) = self.patch_embed(x)
        if not with_pos_cls:
            return tokens, (hp, wp)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + self.interpolate_pos_encoding(hp, wp).to(tokens.dtype), (hp, wp)

    def run_blocks(self, x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        for blk in self.blocks[start:stop]:
            x = blk(x)
        return x

    def collect_block_outputs(self, x: torch.Tensor, taps: Sequence[int]) -> List[torch.Tensor]:
        """Run all blocks; return the un-normed outputs of the blocks in `taps`."""
        want = set(taps)
        out = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                out.append(x)
        return out

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        """The LayerNorm kernel (K6): the output keeps x's dtype, also under
        autocast, as the JAX package's fused LayerNorm does."""
        return layernorm(x, self.norm.weight, self.norm.bias, self.norm.eps)


ARCHS = {
    "vit_test": partial(DinoVisionTransformer, embed_dim=64, depth=5, num_heads=4),
    "vit_small": partial(DinoVisionTransformer, embed_dim=384, depth=12, num_heads=6),
    "vit_base": partial(DinoVisionTransformer, embed_dim=768, depth=12, num_heads=12),
    "vit_large": partial(DinoVisionTransformer, embed_dim=1024, depth=24, num_heads=16),
}


def build_backbone(arch: str, img_size: int = 518, patch_size: int = 14,
                   **kw) -> DinoVisionTransformer:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch](img_size=img_size, patch_size=patch_size, **kw)
