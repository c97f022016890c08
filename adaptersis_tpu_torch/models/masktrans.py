"""The mask transformer (Segmenter) decode head (counterpart of the JAX
package's `models/masktrans.py`; the reference's
eval/eval_dinov2_masktrans.py and backbones/masktrans_block.py): encoder
tokens projected to d_model, n_cls learned class embeddings appended, pre-norm
blocks, L2-normalised patch and class projections, masks = patches ·
classesᵀ, a LayerNorm over the classes, reshaped to (B, GS, GS, n_cls).
The attention is plain torch, as it is plain XLA in the JAX package, with
its rounding points: q scaled before q·kᵀ, the softmax in fp32 and cast
back. Every LayerNorm has eps 1e-5."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class MTAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, C = x.shape
        H = self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        attn = (q * (C // H) ** -0.5) @ k.transpose(-1, -2)              # (B, H, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out), attn


class MTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MTAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, mlp_dim)
        self.mlp_fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        y, attn = self.attn(self.norm1(x))
        if return_attention:
            return attn
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class MaskTransformer(nn.Module):
    """d_model defaults to d_encoder, heads = d_model // 64, MLP 4·d_model
    (the reference's instantiation)."""

    def __init__(self, n_cls: int, patch_size: int, d_encoder: int, n_layers: int = 2,
                 d_model: Optional[int] = None):
        super().__init__()
        d = d_model or d_encoder
        self.n_cls = n_cls
        self.patch_size = patch_size
        self.proj_dec = nn.Linear(d_encoder, d)
        self.cls_emb = nn.Parameter(torch.zeros(1, n_cls, d))
        nn.init.trunc_normal_(self.cls_emb, std=0.02)
        self.blocks = nn.ModuleList(MTBlock(d, d // 64, 4 * d) for _ in range(n_layers))
        self.decoder_norm = nn.LayerNorm(d, eps=1e-5)
        self.proj_patch = nn.Parameter(torch.randn(d, d) * d ** -0.5)
        self.proj_classes = nn.Parameter(torch.randn(d, d) * d ** -0.5)
        self.mask_norm = nn.LayerNorm(n_cls, eps=1e-5)

    def forward(self, tokens: torch.Tensor, im_size: Tuple[int, int]) -> torch.Tensor:
        """tokens (B, N, d_encoder) patch tokens → (B, GS_h, GS_w, n_cls)
        channel-last mask logits."""
        B = tokens.shape[0]
        gs_h, gs_w = im_size[0] // self.patch_size, im_size[1] // self.patch_size
        x = self.proj_dec(tokens)
        x = torch.cat([x, self.cls_emb.to(x.dtype).expand(B, -1, -1)], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.decoder_norm(x)
        patches = x[:, :-self.n_cls] @ self.proj_patch.to(x.dtype)
        cls_feat = x[:, -self.n_cls:] @ self.proj_classes.to(x.dtype)
        patches = patches / patches.float().norm(dim=-1, keepdim=True).to(patches.dtype)
        cls_feat = cls_feat / cls_feat.float().norm(dim=-1, keepdim=True).to(cls_feat.dtype)
        masks = self.mask_norm(patches @ cls_feat.transpose(1, 2))
        return masks.reshape(B, gs_h, gs_w, self.n_cls)
