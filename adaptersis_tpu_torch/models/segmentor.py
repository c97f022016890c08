"""AdapterSegmentor (counterpart of the JAX package's `models/segmentor.py`,
decoder_type "feature"): a frozen DINOv2 backbone walked twice, deformable
cross-attention adapters exchanging features with a CNN pyramid, and the
FeatureDecoder.

  1. FeatureEncoder pyramid c1..c4; c2..c4 get level embeddings.
  2. Clean frozen walk (cls + pos) → the outputs of the last n blocks,
     final-LayerNormed, patch tokens only.
  3. Adapter re-walk: patch tokens without cls or pos through blocks[0:-(n-1)],
     then n rounds of {CAViT; CACNN; add the clean tap; next frozen block}.
     One CAViT/CACNN pair serves all rounds.
  4. Decode concat[adapter out, centre-padded c4, clean tap] (3·E channels)
     and resize the logits to the input size in fp32.

Both backbone walks run under torch.no_grad(): the backbone is frozen.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.resize import center_pad, resize_bilinear
from .adapters import CACNN, CAViT, adapter_geometry
from .decoders import DEFAULT_FEATURES, FeatureDecoder
from .encoders import FeatureEncoder
from .vit import DinoVisionTransformer


class AdapterSegmentor(nn.Module):
    def __init__(self, backbone: DinoVisionTransformer, num_classes: int = 2,
                 n_last_blocks: int = 4, decoder_type: str = "feature",
                 adapter_num_heads: int = 8, adapter_n_points: int = 4,
                 encoder_inplanes: int = 64,
                 decoder_features: Optional[Sequence[int]] = None):
        super().__init__()
        if decoder_type != "feature":
            raise NotImplementedError(
                f"decoder_type {decoder_type!r} is not ported yet (ROADMAP.md, item M11); "
                "only 'feature' is")
        E = backbone.embed_dim
        self.backbone = backbone
        self.n_last_blocks = n_last_blocks
        self.encoder = FeatureEncoder(encoder_inplanes, E)
        self.cross_vit = CAViT(E, adapter_num_heads, adapter_n_points, n_levels=3,
                               init_values=0.0)
        self.cross_cnn = CACNN(E, adapter_num_heads, adapter_n_points, n_levels=1,
                               cffn_ratio=0.25)
        self.level_embed = nn.Parameter(torch.zeros(3, E))
        self.decoder = FeatureDecoder(3 * E, num_classes,
                                      tuple(decoder_features or DEFAULT_FEATURES))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC image in [0, 1]. Returns fp32 logits (B, H, W, num_classes)."""
        B, H, W, _ = x.shape
        bb = self.backbone
        p, depth, n, E = bb.patch_size, bb.depth, self.n_last_blocks, bb.embed_dim
        hp, wp = H // p, W // p
        x = x.to(self.level_embed.dtype)

        c1, c2, c3, c4, cnn_shapes = self.encoder(x)
        le = self.level_embed.to(c2.dtype)
        c4 = c4 + le[2]
        c = torch.cat([c2 + le[0], c3 + le[1], c4], dim=1)
        (ref1, shapes1), (ref2, shapes2) = adapter_geometry((hp, wp), cnn_shapes, x.device)

        stop = depth - (n - 1)          # end of the prefix both walks share
        with torch.no_grad():
            tokens, _ = bb.embed(x, with_pos_cls=True)
            raw_taps = bb.collect_block_outputs(tokens, range(depth - n, depth))
            taps = [bb.final_norm(t)[:, 1:] for t in raw_taps]
            xa, _ = bb.embed(x, with_pos_cls=False)
            xa = bb.run_blocks(xa, 0, stop)

        for r in range(n):
            if r > 0:
                with torch.no_grad():
                    xa = bb.run_blocks(xa, depth - n + r, depth - n + r + 1)
            xa = self.cross_vit(xa, ref1, c, shapes1)
            c = self.cross_cnn(c, ref2, xa, shapes2, query_level_shapes=shapes1)
            xa = xa + taps[r]

        h32, w32 = shapes1[2]
        c4_map = center_pad(c4.reshape(B, h32, w32, E), (hp, wp))
        feat = torch.cat([xa.reshape(B, hp, wp, E), c4_map,
                          taps[-1].reshape(B, hp, wp, E)], dim=-1)
        logits = self.decoder(feat)
        return resize_bilinear(logits.float(), (H, W), align_corners=False)
