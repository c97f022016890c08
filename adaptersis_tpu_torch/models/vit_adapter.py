"""ViTAdapter (counterpart of the JAX package's `models/vit_adapter.py`):
the adapter backbone of the Mask2Former stack. Beside the paper's
AdapterSegmentor it differs in that

  * `level_embed` is a trainable parameter with a normal init;
  * the backbone's blocks run in four ranges of a quarter of the depth
    (`interaction_ranges`), each after its own injector (CAViT: the ViT
    tokens query the CNN pyramid) and before its own extractor (CACNN: the
    pyramid queries the ViT tokens), and the last range is followed by two
    extra extractors: 6 extractors, each with its own weights, and every
    one feeds the FPN (none may be skipped);
  * it returns an FPN pyramid [f1, f2, f3, f4] (NHWC, embed_dim wide):
    the extractor pyramid split back into maps, f1 a 2× transposed
    convolution of f2 plus the stem's c1, each plus the resized ViT tokens
    of its range, then four BatchNorms (flax momentum
    0.9 = torch momentum 0.1, eps 1e-5).

The cls token rides with the blocks (1370 tokens at 518 px for patch 14)
and stays out of the adapter exchanges.

The backbone is frozen (the JAX module's `freeze_vit=True`, the only way
its entry points build it): the block outputs are cut from the graph, as
the JAX package's stop_gradient cuts them. The injectors' outputs reach
the loss only through those blocks, so their gradient is zero: the patch
embedding, the injectors and the blocks run under `torch.no_grad()` (the
frozen walk's kernels are forward only), and the injectors' parameters get
no gradient (`segment_m2f`'s trainer hands them zeros, which AdamW decays
as optax does). The JAX module's other fields are fixed at the defaults
its entry points use: 8 heads of 4 points, CAViT's γ starting at 0, a
ConvFFN ratio of 0.25, the extra extractors and the ViT features added.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .adapters import CACNN, CAViT, adapter_geometry
from .encoders import BatchNorm2d, FeatureEncoder


def interaction_ranges(depth: int) -> List[Tuple[int, int]]:
    """The four (first, last) block ranges of a quarter of the depth each."""
    q = depth // 4
    return [(0, q - 1), (q, 2 * q - 1), (2 * q, 3 * q - 1), (3 * q, depth - 1)]


def _nchw(f):
    return f.permute(0, 3, 1, 2)


def _nhwc(f):
    return f.permute(0, 2, 3, 1)


HEADS, POINTS = 8, 4


class ViTAdapter(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        if backbone.num_register_tokens:
            raise ValueError("ViTAdapter reads the patch tokens as tokens[:, 1:]: a backbone "
                             f"with {backbone.num_register_tokens} register tokens does not "
                             "fit it")
        E = backbone.embed_dim
        self.backbone = backbone
        self.ranges = interaction_ranges(backbone.depth)
        self.spm = FeatureEncoder(64, E)
        self.level_embed = nn.Parameter(torch.randn(3, E))
        for i in range(len(self.ranges)):
            self.add_module(f"interactions_{i}_injector", CAViT(E, HEADS, POINTS, n_levels=3))
            self.add_module(f"interactions_{i}_extractor", CACNN(E, HEADS, POINTS, n_levels=1))
        for j in range(2):
            self.add_module(f"extra_extractor_{j}", CACNN(E, HEADS, POINTS, n_levels=1))
        self.up = nn.ConvTranspose2d(E, E, 2, 2)
        for i in range(1, 5):
            self.add_module(f"norm{i}", BatchNorm2d(E))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x NHWC in [0, 1] → [f1, f2, f3, f4] NHWC."""
        bb = self.backbone
        E, p = bb.embed_dim, bb.patch_size
        B, H, W, _ = x.shape
        hp, wp = H // p, W // p

        c1, c2, c3, c4, cnn_shapes = self.spm(x)
        le = self.level_embed.to(c2.dtype)
        c2, c3, c4 = c2 + le[0], c3 + le[1], c4 + le[2]
        n2, n3 = c2.shape[1], c3.shape[1]
        c = torch.cat([c2, c3, c4], dim=1)
        (ref1, shapes1), (ref2, shapes2) = adapter_geometry((hp, wp), cnn_shapes, x.device)

        with torch.no_grad():
            tokens, _ = bb.embed(x, with_pos_cls=True)
        cls, xt = tokens[:, :1], tokens[:, 1:]
        outs = []
        last = len(self.ranges) - 1
        for i, (lo, hi) in enumerate(self.ranges):
            with torch.no_grad():
                xt = getattr(self, f"interactions_{i}_injector")(xt, ref1, c, shapes1)
                blk = bb.run_blocks(torch.cat([cls, xt], dim=1), lo, hi + 1, hw=(hp, wp))
            cls, xt = blk[:, :1], blk[:, 1:]
            c = getattr(self, f"interactions_{i}_extractor")(c, ref2, xt, shapes2,
                                                             query_level_shapes=shapes1)
            if i == last:
                for j in range(2):
                    c = getattr(self, f"extra_extractor_{j}")(c, ref2, xt, shapes2,
                                                              query_level_shapes=shapes1)
            outs.append(xt.reshape(B, hp, wp, E))

        (h2, w2), (h3, w3), (h4, w4) = cnn_shapes
        c2m = c[:, :n2].reshape(B, h2, w2, E)
        c3m = c[:, n2:n2 + n3].reshape(B, h3, w3, E)
        c4m = c[:, n2 + n3:].reshape(B, h4, w4, E)
        c1m = _nhwc(self.up(_nchw(c2m)))
        c1m = resize_bilinear(c1m, c1.shape[1:3]) + c1
        x1, x2, x3, x4 = outs
        c1m = c1m + resize_bilinear(x1, c1m.shape[1:3])
        c2m = c2m + resize_bilinear(x2, (h2, w2))
        c3m = c3m + resize_bilinear(x3, (h3, w3))
        c4m = c4m + resize_bilinear(x4, (h4, w4))
        return [_nhwc(getattr(self, f"norm{i}")(_nchw(f)))
                for i, f in enumerate((c1m, c2m, c3m, c4m), start=1)]
