"""Analytic FLOP counts of the adapter-segmentation train step (the port's
own copy of the JAX package's `utils/flops.py`; the port imports nothing of
it) and of the SSL train step (`ssl_step_flops`, the copy of
`tools/bench_ssl_step.py`'s).

Matmul and convolution MACs from the model geometry, 2 FLOPs per MAC, so the
MFU that `bench.py` reports does not depend on how the kernels compute them.
Deliberately conservative: LayerNorm, softmax, GELU and other elementwise
work, the augmentation, the resizes and the loss are not counted. The
trainable parts (adapters, encoder, decoder) count 3× their forward
(forward, dX and dW); the frozen backbone walks count 1×, since they run
under `torch.no_grad()`.

One deliberate change: the frozen walks are counted at the lengths the port
runs, 1 + hp·wp tokens (the clean walk, with cls) and hp·wp (the adapter
re-walk), 1765 and 1764 at 588 px. The JAX package counts both at the
128-padded length its flash kernels need (1792); the port does no padding
work. Every other function is the JAX module's, term for term.
"""

from __future__ import annotations

from typing import Tuple


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


def encoder_flops(imsize: int, inplanes: int = 64, embed_dim: int = 1024) -> float:
    """FeatureEncoder conv pyramid at its grid arithmetic (73/36/18 at 588)."""
    p = inplanes
    h2 = (imsize + 1) // 2                 # stem s2 p1
    h4 = (h2 + 1) // 2                     # maxpool s2 p1
    h8 = (h4 - 1) // 2                     # conv2 s2 VALID
    h16 = (h8 - 1) // 2                    # conv3 s2 VALID
    h32 = (h16 + 1) // 2                   # conv4 s2 p1
    f = _conv2d(h2, h2, 3, 3, p) + 2 * _conv2d(h2, h2, 3, p, p)
    f += _conv2d(h8, h8, 3, p, 2 * p) + _conv2d(h16, h16, 3, 2 * p, 4 * p)
    f += _conv2d(h32, h32, 3, 4 * p, 8 * p)
    f += _conv2d(h4, h4, 1, p, embed_dim) + _conv2d(h8, h8, 1, 2 * p, embed_dim)
    f += _conv2d(h16, h16, 1, 4 * p, embed_dim) + _conv2d(h32, h32, 1, 8 * p, embed_dim)
    return f


def decoder_flops(hp: int, wp: int, embed_dim: int, num_classes: int = 2,
                  features: Tuple[int, ...] = (1024, 512, 256, 128, 64)) -> float:
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


def train_step_flops(batch: int, imsize: int = 588, patch: int = 14,
                     embed_dim: int = 1024, depth: int = 24,
                     n_last_blocks: int = 4, num_classes: int = 2) -> float:
    """FLOPs of one train step: the clean walk runs `depth` blocks on
    1 + hp·wp tokens, the adapter re-walk `depth` blocks (the shared prefix
    and the interleaved ones) on hp·wp; the adapters (n rounds), encoder and
    decoder count forward and backward."""
    hp = wp = imsize // patch
    n_vit = hp * wp                              # adapter stream (no cls)
    enc = encoder_flops(imsize, embed_dim=embed_dim)
    h8 = ((((imsize + 1) // 2 + 1) // 2) - 1) // 2
    h16 = (h8 - 1) // 2
    h32 = (h16 + 1) // 2
    n_cnn = h8 * h8 + h16 * h16 + h32 * h32
    patch_embed = 2.0 * n_vit * (patch * patch * 3) * embed_dim

    frozen = (depth * (vit_block_flops(n_vit + 1, embed_dim) + vit_block_flops(n_vit, embed_dim))
              + 2 * patch_embed)
    adapters = n_last_blocks * adapter_round_flops(n_vit, n_cnn, embed_dim)
    dec = decoder_flops(hp, wp, embed_dim, num_classes)
    return batch * (frozen + 3.0 * (adapters + enc + dec))


def ssl_step_flops(batch: int, embed_dim: int, depth: int, upperbound: int,
                   global_size: int = 224, local_size: int = 98, n_local: int = 8,
                   patch: int = 14, out_dim: int = 65536, hidden_dim: int = 2048,
                   bottleneck_dim: int = 256) -> float:
    """FLOPs (2·MACs) of one SSL train step, conservative as above: the
    student's backbone forward and backward (3× its forward) over 2B global
    and n_local·B local crops, the teacher's forward over the 2B global
    crops, the patch-embed convolutions, and the DINO/iBOT heads on the cls
    tokens and the `upperbound` gathered masked rows (student 3×, teacher
    1×). Attention is counted at each crop's own segment length: the masked
    cross-segment pairs of the packed rows are not counted."""
    E = embed_dim
    tg = (global_size // patch) ** 2 + 1            # 257 tokens per global crop
    tl = (local_size // patch) ** 2 + 1             # 50 per local crop

    def backbone_macs(n_crops: int, t: int) -> float:
        return n_crops * t * (depth * (12 * E * E + 2 * t * E) + 3 * patch * patch * E)

    mac_head_tok = (E * hidden_dim + hidden_dim * hidden_dim + hidden_dim * bottleneck_dim
                    + bottleneck_dim * out_dim)
    s_head_tokens = (2 + n_local) * batch + upperbound
    t_head_tokens = 2 * batch + upperbound
    mac = (3 * (backbone_macs(2 * batch, tg) + backbone_macs(n_local * batch, tl))
           + 3 * s_head_tokens * mac_head_tok
           + backbone_macs(2 * batch, tg)
           + t_head_tokens * mac_head_tok)
    return 2.0 * mac
