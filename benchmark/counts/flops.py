"""Analytic operation and byte counts of the adapter segmentor at a
configuration's sizes: the benchmark's frozen yardstick.

`train_step_flops` and the functions it calls are a copy, term for term, of
`adaptersis_tpu_torch/utils/flops.py` as it stood when the benchmark was
defined: matmul and convolution MACs from the geometry, 2 FLOPs per MAC;
LayerNorm, softmax, GELU, the augmentation, resizes and the loss not
counted; the trainable parts (adapters, encoder, decoder) 3× their forward,
the frozen walks 1×. It counts all `n_last_blocks` CACNN rounds, although
the program skips the last one, whose output reaches nothing (≈ 2 % of a
step at ViT-L/14 @ 588): a copy is a copy. `forward_flops` is the same
count for one forward (serving). `walk_flops` and `walk_bytes` count the
frozen blocks alone, the work that `walk_ms` times: each block's input
tokens read and output tokens written once, and its weights read once per
call, in the walk's dtype.

A later change to the program cannot move these numbers.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _conv2d(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def vit_block_flops(n_tokens: int, embed_dim: int, mlp_ratio: float = 4.0) -> float:
    """qkv + attention scores/values + out-proj + 2-layer MLP, per image."""
    e, n = embed_dim, n_tokens
    matmuls = 2.0 * n * e * e * (3 + 1 + 2 * mlp_ratio)   # qkv, proj, fc1, fc2
    attention = 4.0 * n * n * e                           # q·kᵀ and p·v
    return matmuls + attention


def msda_flops(lq: int, lv: int, embed_dim: int, heads: int = 8,
               levels: int = 3, points: int = 4) -> float:
    """One MSDeformAttn forward: value/offset/weight/output projections and
    the bilinear gather-reduce (4 corners + the weighted sum ≈ 5 MACs per
    channel and sampling point)."""
    e = embed_dim
    d = e // heads
    proj = 2.0 * lv * e * e + 2.0 * lq * e * e
    offs = 2.0 * lq * e * (heads * levels * points * 3)   # offsets (2) + weights (1)
    gather = 2.0 * lq * heads * levels * points * 5 * d
    return proj + offs + gather


def adapter_round_flops(n_vit: int, n_cnn: int, embed_dim: int) -> float:
    """CAViT (ViT tokens query the 3-level CNN pyramid) + CACNN (CNN tokens
    query the ViT grid, 1 level) + CACNN's ConvFFN at ratio 0.25."""
    cavit = msda_flops(n_vit, n_cnn, embed_dim, levels=3)
    cacnn = msda_flops(n_cnn, n_vit, embed_dim, levels=1)
    hidden = embed_dim // 4
    cffn = 2.0 * n_cnn * embed_dim * hidden * 2 + 2.0 * n_cnn * 9 * hidden
    return cavit + cacnn + cffn


def pyramid_sides(imsize: int) -> Tuple[int, int, int, int, int]:
    """The encoder's grid sides: /2 (stem), /4 (max-pool), /8, /16, /32."""
    h2 = (imsize + 1) // 2                 # stem s2 p1
    h4 = (h2 + 1) // 2                     # maxpool s2 p1
    h8 = (h4 - 1) // 2                     # conv2 s2 VALID
    h16 = (h8 - 1) // 2                    # conv3 s2 VALID
    h32 = (h16 + 1) // 2                   # conv4 s2 p1
    return h2, h4, h8, h16, h32


def encoder_flops(imsize: int, inplanes: int = 64, embed_dim: int = 1024) -> float:
    """FeatureEncoder conv pyramid at its grid arithmetic (73/36/18 at 588)."""
    p = inplanes
    h2, h4, h8, h16, h32 = pyramid_sides(imsize)
    f = _conv2d(h2, h2, 3, 3, p) + 2 * _conv2d(h2, h2, 3, p, p)
    f += _conv2d(h8, h8, 3, p, 2 * p) + _conv2d(h16, h16, 3, 2 * p, 4 * p)
    f += _conv2d(h32, h32, 3, 4 * p, 8 * p)
    f += _conv2d(h4, h4, 1, p, embed_dim) + _conv2d(h8, h8, 1, 2 * p, embed_dim)
    f += _conv2d(h16, h16, 1, 4 * p, embed_dim) + _conv2d(h32, h32, 1, 8 * p, embed_dim)
    return f


def decoder_flops(hp: int, wp: int, embed_dim: int, num_classes: int = 2,
                  features: Sequence[int] = (1024, 512, 256, 128, 64)) -> float:
    """FeatureDecoder: 3×3 conv then 2× upsampling, four times, then the
    logit conv."""
    cin = 3 * embed_dim
    h, w = hp, wp
    f = 0.0
    for cout in features[1:]:
        f += _conv2d(h, w, 3, cin, cout)
        cin = cout
        h, w = 2 * h, 2 * w
    return f + _conv2d(h, w, 3, cin, num_classes)


def _parts(imsize: int, patch: int, embed_dim: int, depth: int, n_last_blocks: int,
           num_classes: int) -> Tuple[float, float]:
    """(frozen, trainable) FLOPs of one image's forward."""
    hp = wp = imsize // patch
    n_vit = hp * wp                              # adapter stream (no cls)
    enc = encoder_flops(imsize, embed_dim=embed_dim)
    _, _, h8, h16, h32 = pyramid_sides(imsize)
    n_cnn = h8 * h8 + h16 * h16 + h32 * h32
    patch_embed = 2.0 * n_vit * (patch * patch * 3) * embed_dim
    frozen = (depth * (vit_block_flops(n_vit + 1, embed_dim) + vit_block_flops(n_vit, embed_dim))
              + 2 * patch_embed)
    adapters = n_last_blocks * adapter_round_flops(n_vit, n_cnn, embed_dim)
    dec = decoder_flops(hp, wp, embed_dim, num_classes)
    return frozen, adapters + enc + dec


def train_step_flops(batch: int, imsize: int = 588, patch: int = 14,
                     embed_dim: int = 1024, depth: int = 24,
                     n_last_blocks: int = 4, num_classes: int = 2) -> float:
    """FLOPs of one train step: the clean walk runs `depth` blocks on
    1 + hp·wp tokens, the adapter re-walk `depth` blocks (the shared prefix
    and the interleaved ones) on hp·wp; the adapters (n rounds), encoder and
    decoder count forward and backward."""
    frozen, trained = _parts(imsize, patch, embed_dim, depth, n_last_blocks, num_classes)
    return batch * (frozen + 3.0 * trained)


def forward_flops(batch: int, imsize: int = 588, patch: int = 14, embed_dim: int = 1024,
                  depth: int = 24, n_last_blocks: int = 4, num_classes: int = 2) -> float:
    """FLOPs of one forward (serving): every part once."""
    frozen, trained = _parts(imsize, patch, embed_dim, depth, n_last_blocks, num_classes)
    return batch * (frozen + trained)


def walk_flops(batch: int, imsize: int = 588, patch: int = 14, embed_dim: int = 1024,
               depth: int = 24, mlp_ratio: float = 4.0) -> float:
    """FLOPs of the frozen blocks of both walks of one forward: `depth`
    blocks on 1 + hp·wp tokens and `depth` on hp·wp."""
    n = (imsize // patch) ** 2
    return batch * depth * (vit_block_flops(n + 1, embed_dim, mlp_ratio)
                            + vit_block_flops(n, embed_dim, mlp_ratio))


def walk_bytes(batch: int, dtype_bytes: int, imsize: int = 588, patch: int = 14,
               embed_dim: int = 1024, depth: int = 24, mlp_ratio: float = 4.0) -> float:
    """Bytes the frozen blocks of both walks must move at the least: each
    block call reads its input tokens and its weights (qkv, proj, fc1, fc2
    with biases, two LayerNorms, two LayerScales) and writes its output
    tokens, in the walk's dtype."""
    e = embed_dim
    hidden = int(e * mlp_ratio)
    weights = 3 * e * e + 3 * e + e * e + e + 2 * e * hidden + hidden + e + 4 * e + 2 * e
    n = (imsize // patch) ** 2
    tokens = 2 * batch * ((n + 1) + n) * e          # read and written, both walks
    return float(dtype_bytes) * depth * (tokens + 2 * weights)
