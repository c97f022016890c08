"""The plain reference of the adapter segmentor: AdapterSIS's model (a frozen
DINOv2 ViT walked twice, CAViT/CACNN deformable cross-attention adapters
between the ViT tokens and a CNN pyramid, the feature decoder), written
out in plain PyTorch from the published descriptions. It imports nothing of
the program and takes nothing it made: its weights come from
`benchmark/weights.py`, the same tensors the program is loaded with.

The module tree only holds parameters, under the names that the DINOv2 and
AdapterSIS state dicts use (so one state dict loads strictly into both the
program and this model); every product and convolution goes through the
precision object `prec` (`precision.py`), so the same code runs the fp32
reference and the lower-precision controls.

Departures from the published code, each also the program's: the
BatchNorms keep the biased batch variance in their running statistics
(flax's semantics, which the program keeps); the last adapter round skips
its CACNN, whose output reaches nothing; the deformable sampling is
Deformable-DETR's own `ms_deform_attn_core_pytorch` (grid_sample).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .precision import FP32

Shapes = Sequence[Tuple[int, int]]


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, m.eps)


def batch_norm(x: torch.Tensor, m: nn.BatchNorm2d, training: bool) -> torch.Tensor:
    """NCHW batch norm; in training the batch mean and biased variance,
    and running statistics 0.9·old + 0.1·batch (biased variance)."""
    shape = (1, -1, 1, 1)
    if not training:
        mean, var = m.running_mean, m.running_var
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            m.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
            m.running_var.mul_(0.9).add_(var.detach(), alpha=0.1)
    xhat = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + m.eps)
    return xhat * m.weight.reshape(shape) + m.bias.reshape(shape)


# ---------------------------------------------------------------- backbone


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class Block(nn.Module):
    """DINOv2's pre-norm block with LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, prec, gelu: str) -> torch.Tensor:
        B, N, C = x.shape
        H = self.attn.num_heads
        qkv = prec.linear(layer_norm(x, self.norm1), self.attn.qkv.weight, self.attn.qkv.bias)
        q, k, v = qkv.reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        s = prec.matmul(q * (1.0 / math.sqrt(C // H)), k.transpose(-1, -2))
        o = prec.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, N, C)
        x = x + self.ls1.gamma * prec.linear(o, self.attn.proj.weight, self.attn.proj.bias)
        h = prec.linear(layer_norm(x, self.norm2), self.mlp.fc1.weight, self.mlp.fc1.bias)
        h = F.gelu(h, approximate="tanh" if gelu == "tanh" else "none")
        return x + self.ls2.gamma * prec.linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch)


class Backbone(nn.Module):
    """DINOv2 ViT: patch embedding, cls token, a learned position embedding
    for `pos_img_size` resized bicubically (DINOv2's +0.1 scale factor)."""

    def __init__(self, cfg: dict):
        super().__init__()
        E, p = cfg["embed_dim"], cfg["patch_size"]
        self.embed_dim, self.patch = E, p
        self.patch_embed = PatchEmbed(p, E)
        self.cls_token = nn.Parameter(torch.empty(1, 1, E))
        self.mask_token = nn.Parameter(torch.empty(1, E))   # DINOv2's; unused here
        self.pos_embed = nn.Parameter(torch.empty(1, (cfg["pos_embed_img_size"] // p) ** 2 + 1, E))
        self.blocks = nn.ModuleList(Block(E, cfg["num_heads"], cfg["mlp_ratio"])
                                    for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(E, eps=1e-6)

    def pos(self, hp: int, wp: int) -> torch.Tensor:
        pe = self.pos_embed
        m = int(round((pe.shape[1] - 1) ** 0.5))
        if (hp, wp) == (m, m):
            return pe
        grid = pe[:, 1:].reshape(1, m, m, self.embed_dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((hp + 0.1) / m, (wp + 0.1) / m),
                             mode="bicubic", align_corners=False)
        if tuple(grid.shape[2:]) != (hp, wp):
            raise ValueError(f"pos-embed resize gave {tuple(grid.shape[2:])}, not {(hp, wp)}")
        return torch.cat([pe[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)

    def embed(self, x: torch.Tensor, prec, with_pos_cls: bool) -> torch.Tensor:
        pe = self.patch_embed.proj
        t = prec.conv2d(x.permute(0, 3, 1, 2), pe.weight, pe.bias, stride=self.patch)
        hp, wp = t.shape[2:]
        t = t.flatten(2).transpose(1, 2)
        if not with_pos_cls:
            return t
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], dim=1)
        return t + self.pos(hp, wp)


# ---------------------------------------------------------------- adapters


def reference_points(shapes: Shapes, device) -> torch.Tensor:
    """Normalised cell centres of every level: (1, ΣHW, 1, 2)."""
    pts = []
    for H, W in shapes:
        ys = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(pts, 0)[None, :, None, :]


def ms_deform_attn_core(value: torch.Tensor, shapes: Shapes, loc: torch.Tensor,
                        aw: torch.Tensor) -> torch.Tensor:
    """Deformable-DETR's `ms_deform_attn_core_pytorch`: value (B, S, M, D),
    loc (B, Lq, M, L, P, 2) in [0, 1], aw (B, Lq, M, L, P) → (B, Lq, M·D)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * M, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)          # (B·M, Lq, P, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))               # (B·M, D, Lq, P)
    a = aw.transpose(1, 2).reshape(B * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * a).sum(-1).view(B, M * D, Lq)
    return out.transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, d: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, feat, shapes: Shapes, prec) -> torch.Tensor:
        B, Lq, _ = query.shape
        S = feat.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = prec.linear(feat, self.value_proj.weight, self.value_proj.bias).reshape(B, S, M, -1)
        off = prec.linear(query, self.sampling_offsets.weight, self.sampling_offsets.bias)
        off = off.reshape(B, Lq, M, L, P, 2)
        aw = prec.linear(query, self.attention_weights.weight, self.attention_weights.bias)
        aw = torch.softmax(aw.reshape(B, Lq, M, L * P), -1).reshape(B, Lq, M, L, P)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=off.dtype, device=off.device)
        loc = ref.expand(B, Lq, L, 2)[:, :, None, :, None, :] + off / norm[None, None, None, :, None]
        out = ms_deform_attn_core(value, shapes, loc, aw)
        return prec.linear(out, self.output_proj.weight, self.output_proj.bias)


class CAViT(nn.Module):
    def __init__(self, d: int, heads: int, points: int):
        super().__init__()
        self.query_norm = nn.LayerNorm(d, eps=1e-6)
        self.feat_norm = nn.LayerNorm(d, eps=1e-6)
        self.attn = MSDeformAttn(d, 3, heads, points)
        self.gamma = nn.Parameter(torch.empty(d))

    def forward(self, query, ref, feat, shapes, prec):
        a = self.attn(layer_norm(query, self.query_norm), ref, layer_norm(feat, self.feat_norm),
                      shapes, prec)
        return query + self.gamma * a


class DWConv(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dwconv = nn.Conv2d(d, d, 3, 1, 1, groups=d)


class ConvFFN(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x, shapes: Shapes, prec):
        h = prec.linear(x, self.fc1.weight, self.fc1.bias)
        B, _, C = h.shape
        conv = self.dwconv.dwconv
        outs, start = [], 0
        for H, W in shapes:
            seg = h[:, start:start + H * W].transpose(1, 2).reshape(B, C, H, W)
            outs.append(prec.conv2d(seg, conv.weight, conv.bias, padding=1,
                                    groups=C).flatten(2).transpose(1, 2))
            start += H * W
        return prec.linear(F.gelu(torch.cat(outs, 1)), self.fc2.weight, self.fc2.bias)


class CACNN(nn.Module):
    def __init__(self, d: int, heads: int, points: int):
        super().__init__()
        self.query_norm = nn.LayerNorm(d, eps=1e-6)
        self.feat_norm = nn.LayerNorm(d, eps=1e-6)
        self.attn = MSDeformAttn(d, 1, heads, points)
        self.ffn_norm = nn.LayerNorm(d, eps=1e-6)
        self.ffn = ConvFFN(d, d // 4)

    def forward(self, query, ref, feat, shapes, query_shapes, prec):
        query = query + self.attn(layer_norm(query, self.query_norm), ref,
                                  layer_norm(feat, self.feat_norm), shapes, prec)
        return query + self.ffn(layer_norm(query, self.ffn_norm), query_shapes, prec)


# ------------------------------------------------------- encoder, decoder


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1, bias=bias)
        self.bn = nn.BatchNorm2d(cout)


class Encoder(nn.Module):
    """The spatial-prior CNN: stem to /4, stride-2 stages to /8, /16, /32
    (paddings 0, 0, 1), 1×1 projections to the ViT width."""

    def __init__(self, p: int, E: int):
        super().__init__()
        self.stem1, self.stem2, self.stem3 = ConvBN(3, p, False), ConvBN(p, p, False), \
            ConvBN(p, p, False)
        self.conv2, self.conv3, self.conv4 = ConvBN(p, 2 * p, False), \
            ConvBN(2 * p, 4 * p, False), ConvBN(4 * p, 8 * p, False)
        self.fc1 = nn.Conv2d(p, E, 1)     # its output reaches nothing (no c1 is decoded)
        self.fc2 = nn.Conv2d(2 * p, E, 1)
        self.fc3 = nn.Conv2d(4 * p, E, 1)
        self.fc4 = nn.Conv2d(8 * p, E, 1)

    def forward(self, x: torch.Tensor, prec, training: bool):
        def cbr(m: ConvBN, y, stride, pad):
            y = prec.conv2d(y, m.conv.weight, None, stride=stride, padding=pad)
            return F.relu(batch_norm(y, m.bn, training))

        y = x.permute(0, 3, 1, 2)
        y = cbr(self.stem3, cbr(self.stem2, cbr(self.stem1, y, 2, 1), 1, 1), 1, 1)
        c1 = F.max_pool2d(y, 3, 2, 1)
        c2 = cbr(self.conv2, c1, 2, 0)
        c3 = cbr(self.conv3, c2, 2, 0)
        c4 = cbr(self.conv4, c3, 2, 1)
        outs = [prec.conv2d(c, fc.weight, fc.bias) for c, fc in
                ((c2, self.fc2), (c3, self.fc3), (c4, self.fc4))]
        shapes = [tuple(o.shape[2:]) for o in outs]
        return [o.flatten(2).transpose(1, 2) for o in outs], shapes


class Decoder(nn.Module):
    """Four conv → BN → ReLU → 2× bilinear (align_corners) stages, then a
    3×3 logit conv. NHWC in and out."""

    def __init__(self, cin: int, features: Sequence[int], num_classes: int):
        super().__init__()
        widths = [cin, *features[1:]]
        self.n = len(widths) - 1
        for i in range(1, self.n + 1):
            self.add_module(f"decoder_{i}", ConvBN(widths[i - 1], widths[i], True))
        self.final_out = nn.Conv2d(widths[-1], num_classes, 3, 1, 1)

    def forward(self, x: torch.Tensor, prec, training: bool) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        for i in range(1, self.n + 1):
            m = getattr(self, f"decoder_{i}")
            y = F.relu(batch_norm(prec.conv2d(y, m.conv.weight, m.conv.bias, padding=1),
                                  m.bn, training))
            y = F.interpolate(y, size=(2 * y.shape[2], 2 * y.shape[3]), mode="bilinear",
                              align_corners=True)
        y = prec.conv2d(y, self.final_out.weight, self.final_out.bias, padding=1)
        return y.permute(0, 2, 3, 1)


def center_pad(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad NHWC x to `size`, the odd row or column last."""
    dy, dx = size[0] - x.shape[1], size[1] - x.shape[2]
    return F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class Segmentor(nn.Module):
    """AdapterSIS: c2..c4 of the CNN pyramid with level embeddings; a clean
    frozen walk (cls + pos) whose last n blocks' outputs, final-normed, are
    the taps; an adapter re-walk (no cls, no pos) through blocks[:depth−n+1]
    and then n rounds of {CAViT; CACNN (not in the last round); + tap; the
    next block}; the decoder on [adapter tokens, centre-padded c4, last
    tap]; logits resized bilinearly to the input."""

    def __init__(self, cfg: dict):
        super().__init__()
        E = cfg["embed_dim"]
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.encoder = Encoder(cfg["encoder_inplanes"], E)
        self.cross_vit = CAViT(E, cfg["adapter_num_heads"], cfg["adapter_n_points"])
        self.cross_cnn = CACNN(E, cfg["adapter_num_heads"], cfg["adapter_n_points"])
        self.level_embed = nn.Parameter(torch.empty(3, E))
        self.decoder = Decoder(3 * E, cfg["decoder_features"], cfg["num_classes"])

    @torch.no_grad()
    def clean_walk(self, x: torch.Tensor, prec=FP32(), conv_tf32: bool = False) -> torch.Tensor:
        """The frozen clean walk's last block output (B, 1 + hp·wp, E), its
        patch embedding in TF32 where `conv_tf32` (cuDNN's, as the program
        runs its convolutions by default; none on the CPU)."""
        bb = self.backbone
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = conv_tf32
        try:
            t = bb.embed(x, prec, with_pos_cls=True)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        for blk in bb.blocks:
            t = blk(t, prec, self.cfg["gelu"])
        return t

    def forward(self, x: torch.Tensor, prec=FP32(), training: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) in [0, 1] → logits (B, H, W, classes)."""
        B, H, W, _ = x.shape
        bb, cfg = self.backbone, self.cfg
        depth, n, E, gelu = cfg["depth"], cfg["n_last_blocks"], cfg["embed_dim"], cfg["gelu"]
        hp, wp = H // bb.patch, W // bb.patch
        (c2, c3, c4), cnn_shapes = self.encoder(x, prec, training)
        le = self.level_embed
        c4 = c4 + le[2]
        c = torch.cat([c2 + le[0], c3 + le[1], c4], dim=1)
        ref1 = reference_points([(hp, wp)], x.device)
        ref2 = reference_points(cnn_shapes, x.device)

        def run(t, start, stop):
            for blk in bb.blocks[start:stop]:
                t = blk(t, prec, gelu)
            return t

        with torch.no_grad():
            t = bb.embed(x, prec, with_pos_cls=True)
            taps: List[torch.Tensor] = []
            for i, blk in enumerate(bb.blocks):
                t = blk(t, prec, gelu)
                if i >= depth - n:
                    taps.append(layer_norm(t, bb.norm)[:, 1:])
            xa = run(bb.embed(x, prec, with_pos_cls=False), 0, depth - (n - 1))
        for r in range(n):
            if r > 0:
                with torch.no_grad():
                    xa = run(xa, depth - n + r, depth - n + r + 1)
            xa = self.cross_vit(xa, ref1, c, cnn_shapes, prec)
            if r < n - 1:
                c = self.cross_cnn(c, ref2, xa, [(hp, wp)], cnn_shapes, prec)
            xa = xa + taps[r]
        h32, w32 = cnn_shapes[2]
        feat = torch.cat([xa.reshape(B, hp, wp, E),
                          center_pad(c4.reshape(B, h32, w32, E), (hp, wp)),
                          taps[-1].reshape(B, hp, wp, E)], dim=-1)
        logits = self.decoder(feat, prec, training)
        out = F.interpolate(logits.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                            align_corners=False)
        return out.permute(0, 2, 3, 1)
