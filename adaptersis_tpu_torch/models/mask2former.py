"""The Mask2Former head (counterpart of the JAX package's
`models/mask2former.py`) and the model `segment_m2f` trains: a frozen
DINOv2 backbone under a ViTAdapter FPN (`models/vit_adapter.py`), then

  * `MSDeformAttnPixelDecoder`: 1×1 projections of the three coarse levels
    (high stride first: [f4, f3, f2]), sine positions plus a level
    encoding, 6 deformable self-attention encoder layers over their 5313
    tokens at 518 px (`ops/ms_deform_attn.py:MSDeformAttn`, so K1 and K2 at
    head width C/8 = 32, 3 levels, Lq = S), then a top-down FPN step into
    f1 for the mask features;
  * `Mask2FormerHead`: learned queries, decoder layers cycling over the
    encoder's three levels with masked cross-attention (−1e9 where the
    previous layer's mask is off; a query with an empty mask attends
    everywhere), self-attention and an FFN, post-norm, and prediction
    heads shared by all layers. Its attention is plain torch (the JAX code
    is einsum and an fp32 softmax; no Pallas kernel computes it).

Module and parameter names are the flax ones (`encoder_0_attn`,
`dec_3_cross_q`, ...), so the weight bridge maps the JAX package's trees
unchanged. The point sampling of the loss is here too (`point_sample`,
`uncertainty_sample_points`), with the random draws kept apart from the
arithmetic: the caller passes the points.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ms_deform_attn import MSDeformAttn
from ..ops.resize import resize_bilinear
from .adapters import get_reference_points
from .vit_adapter import ViTAdapter


def sine_positional_encoding(hw: Tuple[int, int], num_feats: int = 128,
                             device: torch.device | str = "cpu") -> torch.Tensor:
    """SinePositionalEncoding (normalised, scale 2π, temperature 10000) →
    (H, W, 2·num_feats) fp32: the y half, then the x half, each sin and cos
    interleaved."""
    H, W = hw
    y = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None].expand(H, W)
    x = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :].expand(H, W)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (H + eps) * scale
    x = x / (W + eps) * scale
    k = torch.arange(num_feats, device=device) // 2
    dim_t = 10000 ** (2 * k / num_feats).float()
    pos_x, pos_y = x[..., None] / dim_t, y[..., None] / dim_t

    def interleave(p):
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).reshape(H, W, num_feats)

    return torch.cat([interleave(pos_y), interleave(pos_x)], dim=-1)


class FFN(nn.Module):
    """x + fc2(relu(fc1(x)))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.relu(self.fc1(x)))


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 convolution of NHWC x as the product over channels."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)      # flax's default epsilon


ENCODER_LAYERS, HEADS, POINTS = 6, 8, 4


class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable-encoder FPN: 6 encoder layers, 8 heads of 4 points. Input
    [f1 (1/4), f2 (1/8), f3 (1/16), f4 (1/32)] NHWC with `in_channels`;
    returns the mask features (B, H/4, W/4, C) and the encoder's maps
    [1/32, 1/16, 1/8]."""

    def __init__(self, in_channels: int, feat_channels: int = 256):
        super().__init__()
        C = feat_channels
        for i in range(3):
            self.add_module(f"input_proj_{i}", nn.Conv2d(in_channels, C, 1))
            self.register_parameter(f"level_encoding_{i}", nn.Parameter(torch.randn(C)))
        for li in range(ENCODER_LAYERS):
            self.add_module(f"encoder_{li}_attn", MSDeformAttn(C, 3, HEADS, POINTS))
            self.add_module(f"encoder_{li}_norm1", _layer_norm(C))
            self.add_module(f"encoder_{li}_ffn", FFN(C, 1024))
            self.add_module(f"encoder_{li}_norm2", _layer_norm(C))
        self.lateral_conv = nn.Conv2d(in_channels, C, 1, bias=False)
        self.output_conv = nn.Conv2d(C, C, 3, padding=1, bias=False)
        self.mask_feature = nn.Conv2d(C, C, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        f1, f2, f3, f4 = feats
        B = f1.shape[0]
        enc_maps = [f4, f3, f2]                 # high → low stride
        shapes = [tuple(m.shape[1:3]) for m in enc_maps]
        tokens, pos_toks = [], []
        for i, m in enumerate(enc_maps):
            t = _conv1x1(getattr(self, f"input_proj_{i}"), m)
            C = t.shape[-1]
            pos = sine_positional_encoding(shapes[i], C // 2, device=m.device)
            tokens.append(t.reshape(B, -1, C))
            pos_toks.append((pos + getattr(self, f"level_encoding_{i}")).reshape(1, -1, C))
        src = torch.cat(tokens, dim=1)
        pos = torch.cat(pos_toks, dim=1).to(src.dtype)
        ref = get_reference_points(shapes, src.device).expand(B, -1, len(shapes), -1)
        for li in range(ENCODER_LAYERS):
            attn = getattr(self, f"encoder_{li}_attn")(src + pos, ref, src, shapes)
            src = getattr(self, f"encoder_{li}_norm1")(src + attn)
            src = getattr(self, f"encoder_{li}_norm2")(getattr(self, f"encoder_{li}_ffn")(src))
        mems, start = [], 0
        for h, w in shapes:
            mems.append(src[:, start:start + h * w].reshape(B, h, w, -1))
            start += h * w
        # FPN: the 1/8 level up into f1
        lateral = F.conv2d(f1.permute(0, 3, 1, 2), self.lateral_conv.weight).permute(0, 2, 3, 1)
        fused = lateral + resize_bilinear(mems[-1], f1.shape[1:3])
        fused = self.output_conv(fused.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return _conv1x1(self.mask_feature, fused), mems


class Mask2FormerHead(nn.Module):
    """Returns (cls_all, mask_all): per prediction (the queries before the
    first decoder layer, then after each) the class logits (B, Q,
    num_classes + 1) and the mask logits (B, Q, H/4, W/4). Its attention
    has 8 heads."""

    def __init__(self, in_channels: int, num_classes: int, num_queries: int = 100,
                 feat_channels: int = 256, num_decoder_layers: int = 9):
        super().__init__()
        C = feat_channels
        if C % HEADS:
            raise ValueError(f"feat_channels {C} not divisible by {HEADS} heads")
        self.num_decoder_layers = num_decoder_layers
        self.pixel_decoder = MSDeformAttnPixelDecoder(in_channels, C)
        self.query_feat = nn.Parameter(torch.randn(num_queries, C))
        self.query_embed = nn.Parameter(torch.randn(num_queries, C))
        for i in range(3):
            self.register_parameter(f"dec_level_embed_{i}", nn.Parameter(torch.randn(C)))
        self.pred_norm = _layer_norm(C)
        self.pred_cls = nn.Linear(C, num_classes + 1)
        for k in range(3):
            self.add_module(f"pred_maskmlp_{k}", nn.Linear(C, C))
        for li in range(num_decoder_layers):
            for kind in ("cross", "self"):
                for p in "qkvo":
                    self.add_module(f"dec_{li}_{kind}_{p}", nn.Linear(C, C))
            for k in (1, 2, 3):
                self.add_module(f"dec_{li}_norm{k}", _layer_norm(C))
            self.add_module(f"dec_{li}_ffn", FFN(C, 2048))

    def _mha(self, qx, kx, vx, name: str, bias=None) -> torch.Tensor:
        B, C = qx.shape[0], qx.shape[-1]
        H = HEADS
        Dh = C // H

        def heads(t, p):
            return getattr(self, f"{name}_{p}")(t).reshape(B, -1, H, Dh).transpose(1, 2)

        qh, kh, vh = heads(qx, "q"), heads(kx, "k"), heads(vx, "v")   # (B, H, N, Dh)
        logits = (qh / math.sqrt(Dh)) @ kh.transpose(-1, -2)
        if bias is not None:
            logits = logits + bias
        a = torch.softmax(logits, dim=-1, dtype=torch.promote_types(logits.dtype, torch.float32))
        o = (a.to(vh.dtype) @ vh).transpose(1, 2).reshape(B, -1, C)
        return getattr(self, f"{name}_o")(o)

    def _predict(self, q, mask_features):
        qn = self.pred_norm(q)
        e = qn
        for k in range(3):
            e = getattr(self, f"pred_maskmlp_{k}")(e)
            if k < 2:
                e = F.relu(e)
        return self.pred_cls(qn), torch.einsum("bqc,bhwc->bqhw", e, mask_features)

    def forward(self, feats: Sequence[torch.Tensor]):
        mask_features, mems = self.pixel_decoder(feats)
        B, C = mask_features.shape[0], mask_features.shape[-1]
        Q = self.query_feat.shape[0]
        dt = mask_features.dtype
        q = self.query_feat[None].expand(B, Q, C).to(dt)
        q_pos = self.query_embed[None].expand(B, Q, C).to(dt)
        mem_tokens, mem_pos = [], []
        for i, m in enumerate(mems):
            lvl = getattr(self, f"dec_level_embed_{i}")
            pos = sine_positional_encoding(m.shape[1:3], C // 2, device=m.device)
            mem_tokens.append(m.reshape(B, -1, C) + lvl.to(m.dtype))
            mem_pos.append(pos.reshape(1, -1, C).expand(B, -1, C).to(dt))
        cls_l, mask_l = self._predict(q, mask_features)
        cls_all, mask_all = [cls_l], [mask_l]
        for li in range(self.num_decoder_layers):
            lvl = li % 3
            hw = mems[lvl].shape[1:3]
            with torch.no_grad():
                # attention mask from the previous prediction
                am = resize_bilinear(mask_all[-1].permute(0, 2, 3, 1), hw)
                am = (torch.sigmoid(am) > 0.5).permute(0, 3, 1, 2).reshape(B, Q, -1)
                am = am | ~am.any(dim=-1, keepdim=True)     # an empty mask attends everywhere
                bias = torch.zeros(am.shape, dtype=torch.float32, device=am.device)
                bias = bias.masked_fill(~am, -1e9)[:, None]          # (B, 1, Q, N)
            mem = mem_tokens[lvl]
            kk = mem + mem_pos[lvl]
            q = getattr(self, f"dec_{li}_norm1")(
                q + self._mha(q + q_pos, kk, mem, f"dec_{li}_cross", bias))
            qp = q + q_pos
            q = getattr(self, f"dec_{li}_norm2")(q + self._mha(qp, qp, q, f"dec_{li}_self"))
            q = getattr(self, f"dec_{li}_norm3")(getattr(self, f"dec_{li}_ffn")(q))
            cls_l, mask_l = self._predict(q, mask_features)
            cls_all.append(cls_l)
            mask_all.append(mask_l)
        return cls_all, mask_all


class Mask2FormerSegmentor(nn.Module):
    """`segment_m2f`'s model: ViTAdapter (`adapter`, which holds the
    backbone) → Mask2FormerHead (`head`). forward(x NHWC in [0, 1]) →
    (cls_all, mask_all)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 2, num_queries: int = 100,
                 feat_channels: int = 256, num_decoder_layers: int = 9):
        super().__init__()
        self.adapter = ViTAdapter(backbone)
        self.head = Mask2FormerHead(backbone.embed_dim, num_classes, num_queries, feat_channels,
                                    num_decoder_layers)

    @property
    def backbone(self) -> nn.Module:
        return self.adapter.backbone

    def forward(self, x: torch.Tensor):
        return self.head(self.adapter(x))


# ---- point sampling ----

def _nearest_at(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """logits (N, H, W) at the pixels holding points p (N, P, 2) xy ∈ [0, 1]."""
    N, H, W = logits.shape
    y = (p[..., 1] * H - 0.5).clamp(0, H - 1).floor().long()
    x = (p[..., 0] * W - 0.5).clamp(0, W - 1).floor().long()
    return logits.flatten(1).gather(1, y * W + x)


IMPORTANCE = 0.75           # the share of the points taken by uncertainty


def uncertainty_sample_points(mask_logits: torch.Tensor, num_points: int, over: torch.Tensor,
                              rand: torch.Tensor) -> torch.Tensor:
    """Uncertainty-based point sampling: of the oversampled points `over`
    (N, n_over, 2) in [0, 1], keep the int(num_points · IMPORTANCE) most
    uncertain (largest −|logit| at their nearest pixel; ties to the lower
    index, as `jax.lax.top_k`), then the random points `rand` (N,
    num_points − that, 2). Returns (N, num_points, 2)."""
    n_imp = int(num_points * IMPORTANCE)
    if rand.shape[1] != num_points - n_imp:
        raise ValueError(f"{rand.shape[1]} random points, expected {num_points - n_imp}")
    unc = -_nearest_at(mask_logits, over).abs()
    top = torch.sort(unc, dim=1, descending=True, stable=True).indices[:, :n_imp]
    imp = over.gather(1, top[..., None].expand(-1, -1, 2))
    return torch.cat([imp, rand.to(imp.dtype)], dim=1)


def point_sample(mask: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (N, H, W) at (N, P, 2) xy ∈ [0, 1] → (N, P), the
    JAX package's form: corner indices clamped to the map (border
    semantics, where `grid_sample` would read zeros) and fractional weights
    clamped to [0, 1]."""
    N, H, W = mask.shape
    x = points[..., 0] * W - 0.5
    y = points[..., 1] * H - 0.5
    x0 = x.floor().long().clamp(0, W - 1)
    y0 = y.floor().long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    tx = (x - x0).clamp(0, 1)
    ty = (y - y0).clamp(0, 1)
    flat = mask.flatten(1)

    def g(yy, xx):
        return flat.gather(1, yy * W + xx)

    return (g(y0, x0) * (1 - tx) * (1 - ty) + g(y0, x1) * tx * (1 - ty)
            + g(y1, x0) * (1 - tx) * ty + g(y1, x1) * tx * ty)


def mask2former_semantic_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Semantic map Σ_q softmax(cls)[q, :-1] ⊗ sigmoid(mask_q), resized
    bilinearly to out_hw: (B, H, W, num_classes)."""
    cls_p = torch.softmax(cls_logits, dim=-1)[..., :-1]           # drop no-object
    seg = torch.einsum("bqc,bqhw->bhwc", cls_p, torch.sigmoid(mask_logits))
    return resize_bilinear(seg, out_hw)
