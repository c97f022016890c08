"""The generic DETR transformer stack and DynamicConv (counterpart of the
JAX package's `models/detr.py`; the reference's mm-style
`segmentation_m2f/models/utils/transformer.py`):

  * `DetrTransformerEncoder` / `DetrTransformerDecoder`: post-norm layers
    in mmcv's order (self-attention, norm, [cross-attention, norm,] FFN,
    norm), positions added to q and k (never v), the decoder optionally
    returning every layer's output;
  * `DetrTransformer`: the DETR forward over an NHWC map, zero targets,
    key-padding masks from the pixel mask;
  * `DeformableDetrTransformerDecoder`: cross-attention by multi-scale
    deformable attention (`ops/ms_deform_attn.py`, so K1 and K2 on the
    card) over flattened level features, with optional iterative
    refinement of the reference points through inverse_sigmoid space;
  * `inverse_sigmoid` and `DynamicConv` (per-proposal 1×1 convolutions as
    two batched products with LayerNorm and ReLU between).

Batch-major (B, N, C) throughout. The attention is flax's
MultiHeadDotProductAttention (`MultiHeadAttention`): query, key, value and
out projections, q scaled by 1/√Dh, masked scores at the dtype's lowest
value. Nothing in either package's entry points calls these modules.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ms_deform_attn import MSDeformAttn


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The logit with the reference's clamping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention (query, key, value, out; the
    weight bridge maps its (C, H, Dh) and (H, Dh, C) kernels)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v, key_padding_mask: Optional[torch.Tensor] = None):
        """key_padding_mask (B, Nk) True = padding."""
        B, C = q.shape[0], q.shape[-1]
        H, Dh = self.heads, C // self.heads

        def split(t, proj):
            return proj(t).reshape(B, -1, H, Dh).transpose(1, 2)     # (B, H, N, Dh)

        qh, kh, vh = split(q, self.query), split(k, self.key), split(v, self.value)
        logits = (qh / math.sqrt(Dh)) @ kh.transpose(-1, -2)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        o = torch.softmax(logits, dim=-1) @ vh
        return self.out(o.transpose(1, 2).reshape(B, -1, C))


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


def _with(x, pos):
    return x if pos is None else x + pos


class DetrEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.norm1 = _ln(dim)
        self.ffn = _FFN(dim, ffn_dim)
        self.norm2 = _ln(dim)

    def forward(self, x, pos=None, key_padding_mask=None):
        qk = _with(x, pos)
        x = self.norm1(x + self.self_attn(qk, qk, x, key_padding_mask))
        return self.norm2(self.ffn(x))


class DetrDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.norm1 = _ln(dim)
        self.cross_attn = MultiHeadAttention(dim, heads)
        self.norm2 = _ln(dim)
        self.ffn = _FFN(dim, ffn_dim)
        self.norm3 = _ln(dim)

    def forward(self, q, memory, query_pos=None, key_pos=None, key_padding_mask=None):
        qq = _with(q, query_pos)
        q = self.norm1(q + self.self_attn(qq, qq, q))
        q = self.norm2(q + self.cross_attn(_with(q, query_pos), _with(memory, key_pos), memory,
                                           key_padding_mask))
        return self.norm3(self.ffn(q))


class DetrTransformerEncoder(nn.Module):
    def __init__(self, dim: int, num_layers: int = 6, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layers_{i}", DetrEncoderLayer(dim, heads, ffn_dim))
        self.num_layers = num_layers

    def forward(self, x, pos=None, key_padding_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, pos, key_padding_mask)
        return x


class DetrTransformerDecoder(nn.Module):
    """Every layer's output, post-normed by one shared LayerNorm (the JAX
    module's defaults, return_intermediate and post_norm)."""

    def __init__(self, dim: int, num_layers: int = 6, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layers_{i}", DetrDecoderLayer(dim, heads, ffn_dim))
        self.num_layers = num_layers
        self.post_norm = _ln(dim)

    def forward(self, q, memory, query_pos=None, key_pos=None, key_padding_mask=None):
        """(num_layers, B, nq, C)."""
        inter = []
        for i in range(self.num_layers):
            q = getattr(self, f"layers_{i}")(q, memory, query_pos, key_pos, key_padding_mask)
            inter.append(self.post_norm(q))
        return torch.stack(inter)


class DetrTransformer(nn.Module):
    """The DETR wiring over NHWC feature maps."""

    def __init__(self, embed_dim: int = 256, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.encoder = DetrTransformerEncoder(embed_dim, num_encoder_layers, heads, ffn_dim)
        self.decoder = DetrTransformerDecoder(embed_dim, num_decoder_layers, heads, ffn_dim)

    def forward(self, x, mask: Optional[torch.Tensor], query_embed, pos_embed):
        """x (B, H, W, C); mask (B, H, W) True = padding, or None; query_embed
        (nq, C); pos_embed (B, H, W, C). Returns (the decoder's per-layer
        outputs (L, B, nq, C), the memory (B, H, W, C))."""
        B, H, W, C = x.shape
        kpm = None if mask is None else mask.reshape(B, H * W)
        pos = pos_embed.reshape(B, H * W, C)
        memory = self.encoder(x.reshape(B, H * W, C), pos, kpm)
        qe = query_embed[None].expand(B, -1, -1)
        out = self.decoder(torch.zeros_like(qe), memory, qe, pos, kpm)
        return out, memory.reshape(B, H, W, C)


class DeformableDetrDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 1024, n_points: int = 4,
                 n_levels: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.norm1 = _ln(dim)
        self.cross_attn = MSDeformAttn(dim, n_levels, heads, n_points)
        self.norm2 = _ln(dim)
        self.ffn = _FFN(dim, ffn_dim)
        self.norm3 = _ln(dim)

    def forward(self, q, memory, reference_points, spatial_shapes, query_pos=None):
        qq = _with(q, query_pos)
        q = self.norm1(q + self.self_attn(qq, qq, q))
        q = self.norm2(q + self.cross_attn(_with(q, query_pos), reference_points, memory,
                                           spatial_shapes))
        return self.norm3(self.ffn(q))


class DeformableDetrTransformerDecoder(nn.Module):
    """MSDA cross-attention; with `reg_branch` (a module mapping (B, nq, C)
    to (B, nq, 2)) each layer refines the points: sigmoid(delta +
    inverse_sigmoid(refs)), detached, as the reference's reg_branches do.
    Every layer's output is returned (the JAX module's default)."""

    def __init__(self, dim: int, num_layers: int = 6, heads: int = 8, ffn_dim: int = 1024,
                 n_points: int = 4, n_levels: int = 4):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layers_{i}",
                            DeformableDetrDecoderLayer(dim, heads, ffn_dim, n_points, n_levels))
        self.num_layers = num_layers

    def forward(self, q, memory, reference_points, spatial_shapes: Sequence[Tuple[int, int]],
                query_pos=None, reg_branch: Optional[Callable] = None):
        """reference_points (B, nq, n_levels, 2) in [0, 1]. Returns (outputs,
        points), each stacked per layer."""
        inter, inter_refs = [], []
        refs = reference_points
        for i in range(self.num_layers):
            q = getattr(self, f"layers_{i}")(q, memory, refs, spatial_shapes, query_pos)
            if reg_branch is not None:
                new = torch.sigmoid(reg_branch(q) + inverse_sigmoid(refs[..., 0, :]))
                refs = new[..., None, :].expand(refs.shape).detach()
            inter.append(q)
            inter_refs.append(refs)
        return torch.stack(inter), torch.stack(inter_refs)


class DynamicConv(nn.Module):
    """Per-proposal dynamic 1×1 convolutions: a Linear generates (in → feat)
    and (feat → out) kernels from each proposal's parameter feature; its
    roi feature goes through both with LayerNorm and ReLU, then (with
    `with_proj`) a flatten projection."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 64,
                 out_channels: Optional[int] = None, input_feat_shape: int = 7,
                 with_proj: bool = True):
        super().__init__()
        cin, cf = in_channels, feat_channels
        cout = out_channels or cin
        self.cin, self.cf, self.cout = cin, cf, cout
        self.with_proj = with_proj
        self.dynamic_layer = nn.Linear(cin, cin * cf + cout * cf)
        self.norm_in = _ln(cf)
        self.norm_out = _ln(cout)
        if with_proj:
            self.fc_layer = nn.Linear(input_feat_shape ** 2 * cout, cout)
            self.fc_norm = _ln(cout)

    def forward(self, param_feature: torch.Tensor, input_feature: torch.Tensor) -> torch.Tensor:
        """param_feature (N, in), input_feature (N, HW, in) → (N, out), or
        (N, HW, out) without the projection."""
        cin, cf, cout = self.cin, self.cf, self.cout
        params = self.dynamic_layer(param_feature)
        p_in = params[:, :cin * cf].reshape(-1, cin, cf)
        p_out = params[:, cin * cf:].reshape(-1, cf, cout)
        feats = F.relu(self.norm_in(input_feature @ p_in))
        feats = F.relu(self.norm_out(feats @ p_out))
        if not self.with_proj:
            return feats
        return F.relu(self.fc_norm(self.fc_layer(feats.reshape(feats.shape[0], -1))))
