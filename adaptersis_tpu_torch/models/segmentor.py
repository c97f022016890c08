"""AdapterSegmentor (counterpart of the JAX package's `models/segmentor.py`,
every decoder_type): a frozen DINOv2 backbone walked twice, deformable
cross-attention adapters exchanging features with a CNN pyramid, and a
decoder.

  1. FeatureEncoder pyramid c1..c4; c2..c4 get level embeddings.
  2. Clean frozen walk (cls + pos) → the outputs of the last n blocks,
     final-LayerNormed, patch tokens only.
  3. Adapter re-walk: patch tokens without cls or pos through blocks[0:-(n-1)],
     then n rounds of {CAViT; CACNN; add the clean tap; next frozen block}.
     One CAViT/CACNN pair serves all rounds. The last round's CACNN output
     reaches no output, so it is not computed (7 MSDA calls for n = 4).
  4. Decode and resize the logits to the input size in fp32. decoder_type
     "feature" (FeatureDecoder) and "setr" (DecoderSETR) read concat[adapter
     out, centre-padded c4, clean tap] (3·E channels); "mla" (DecoderMLA,
     the reference's train_mla.py) reads the four rounds' outputs. With
     `parity_frozen_head` the decoder input is detached: the reference's
     accidental decoder-only training (its train.py wraps the adapters in
     no_grad), so only the decoder gets gradients. `mla_last_block_bug`
     reproduces train_mla.py's copy-paste fault: the last round re-runs
     block depth − 2 in place of block depth − 1.

Both backbone walks run under torch.no_grad(): the backbone is frozen.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.resize import center_pad, resize_bilinear
from .adapters import CACNN, CAViT, adapter_geometry
from .decoders import DEFAULT_FEATURES, DecoderMLA, DecoderSETR, FeatureDecoder
from .encoders import FeatureEncoder
from .vit import DinoVisionTransformer


class AdapterSegmentor(nn.Module):
    def __init__(self, backbone: DinoVisionTransformer, num_classes: int = 2,
                 n_last_blocks: int = 4, decoder_type: str = "feature",
                 adapter_num_heads: int = 8, adapter_n_points: int = 4,
                 encoder_inplanes: int = 64,
                 decoder_features: Optional[Sequence[int]] = None,
                 parity_frozen_head: bool = False, mla_last_block_bug: bool = False):
        super().__init__()
        if backbone.num_register_tokens:
            raise ValueError(
                f"the adapter segmentor reads the patch tokens as tokens[:, 1:], so a backbone "
                f"with {backbone.num_register_tokens} register tokens does not fit it (the JAX "
                "package fails there too, adding the taps to the adapter tokens)")
        E = backbone.embed_dim
        self.backbone = backbone
        self.n_last_blocks = n_last_blocks
        self.parity_frozen_head = parity_frozen_head
        self.mla_last_block_bug = mla_last_block_bug
        self.decoder_type = decoder_type
        self.encoder = FeatureEncoder(encoder_inplanes, E)
        self.cross_vit = CAViT(E, adapter_num_heads, adapter_n_points, n_levels=3,
                               init_values=0.0)
        self.cross_cnn = CACNN(E, adapter_num_heads, adapter_n_points, n_levels=1,
                               cffn_ratio=0.25)
        self.level_embed = nn.Parameter(torch.zeros(3, E))
        if decoder_type == "feature":
            self.decoder = FeatureDecoder(3 * E, num_classes,
                                          tuple(decoder_features or DEFAULT_FEATURES))
        elif decoder_type == "mla":
            self.decoder = DecoderMLA(E, num_classes=num_classes)
        elif decoder_type == "setr":
            self.decoder = DecoderSETR(3 * E, num_classes)
        else:
            raise ValueError(f"unknown decoder_type {decoder_type!r}")

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

        rounds = []
        for r in range(n):
            if r > 0:
                blk = depth - n + r
                if self.mla_last_block_bug and r == n - 1:
                    blk = depth - 2
                with torch.no_grad():
                    xa = bb.run_blocks(xa, blk, blk + 1)
            xa = self.cross_vit(xa, ref1, c, shapes1)
            if r < n - 1:               # the last round's c reaches no output
                c = self.cross_cnn(c, ref2, xa, shapes2, query_level_shapes=shapes1)
            xa = xa + taps[r]
            rounds.append(xa)

        if self.decoder_type == "mla":
            maps = [o.reshape(B, hp, wp, E) for o in rounds]
            if self.parity_frozen_head:
                maps = [m.detach() for m in maps]
            return resize_bilinear(self.decoder(*maps).float(), (H, W), align_corners=False)
        h32, w32 = shapes1[2]
        c4_map = center_pad(c4.reshape(B, h32, w32, E), (hp, wp))
        feat = torch.cat([xa.reshape(B, hp, wp, E), c4_map,
                          taps[-1].reshape(B, hp, wp, E)], dim=-1)
        if self.parity_frozen_head:
            feat = feat.detach()
        logits = self.decoder(feat)
        return resize_bilinear(logits.float(), (H, W), align_corners=False)
