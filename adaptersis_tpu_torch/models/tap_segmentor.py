"""TapSegmentor (counterpart of the JAX package's `models/tap_segmentor.py`):
the adapter-free models of the reference's eval scripts, a frozen DINOv2
backbone's feature taps decoded by one of five heads (`decoder`):
  * "setr": the last n blocks' normed patch tokens concatenated (n·E
    channels) → DecoderSETR (eval_dinov2_setr.py);
  * "unet": the last block's → the truncated feature-space UNet
    (eval_dinov2_unet.py);
  * "unet_fuse": a full-image UNet fed the last block's tap of three
    backbone walks, at scales 1.0, 1.5 and 0.5, fused into its first three
    stages (eval_dinov2_or_unet_fuse.py);
  * "masktrans": the last n blocks' concatenated → MaskTransformer
    (eval_dinov2_masktrans.py);
  * "setr_ete": the full forward's normed patch tokens → a small
    DecoderSETR (256, 128, 64), the backbone trained end to end
    (eval_dinov2_setr_cross_ete.py).
Every variant's logits are resized bilinearly to the input size, in fp32.

The frozen taps run under torch.no_grad(), so the deployed configuration's
forward-only kernels serve them. "setr_ete" differentiates through the
backbone: it takes a backbone in the trained configuration
(`layers.TRAINED`: K7 between plain LayerNorm, Linear and MLP)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .decoders import DecoderSETR, FCUUp
from .masktrans import MaskTransformer
from .unet_parts import DoubleConv, Down, FeatureUNet, OutConv, Up
from .vit import DinoVisionTransformer

DECODERS = ("setr", "unet", "unet_fuse", "masktrans", "setr_ete")


class UNetFuse(nn.Module):
    """A full-image UNet whose first three stages each add a ViT tap,
    projected by FCUUp to the stage's width and nearest-resized to its size,
    then ReLU: x1 takes the 1.5-scale walk's tap, x2 the 1.0's, x3 the 0.5's."""

    def __init__(self, n_classes: int = 2, embed_dim: int = 384, bilinear: bool = False):
        super().__init__()
        f = 2 if bilinear else 1
        E = embed_dim
        self.inc = DoubleConv(3, 64)
        self.expand_block_4 = FCUUp(E, 64, up_stride=1)
        self.down1 = Down(64, 128)
        self.expand_block_3 = FCUUp(E, 128, up_stride=1)
        self.down2 = Down(128, 256)
        self.expand_block_2 = FCUUp(E, 256, up_stride=1)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // f)
        self.up1 = Up(1024 // f, 512, 512 // f, bilinear)
        self.up2 = Up(512 // f, 256, 256 // f, bilinear)
        self.up3 = Up(256 // f, 128, 128 // f, bilinear)
        self.up4 = Up(128 // f, 64, 64, bilinear)
        self.outc = OutConv(64, n_classes)

    def forward(self, x, tap_o, tap_t2, tap_d2) -> torch.Tensor:
        def fuse(stage, tap, block):
            return F.relu(stage + block(tap, stage.shape[1], stage.shape[2]))

        x1 = fuse(self.inc(x), tap_t2, self.expand_block_4)
        x2 = fuse(self.down1(x1), tap_o, self.expand_block_3)
        x3 = fuse(self.down2(x2), tap_d2, self.expand_block_2)
        x4 = self.down3(x3)
        h = self.up2(self.up1(self.down4(x4), x4), x3)
        return self.outc(self.up4(self.up3(h, x2), x1))


class TapSegmentor(nn.Module):
    def __init__(self, backbone: DinoVisionTransformer, num_classes: int = 2,
                 n_last_blocks: int = 4, decoder: str = "setr"):
        super().__init__()
        if decoder not in DECODERS:
            raise ValueError(f"unknown tap decoder {decoder!r}; choose from {DECODERS}")
        self.train_backbone = decoder == "setr_ete"
        if self.train_backbone and backbone.blocks[0].attn_impl != "flash":
            raise ValueError("a trained backbone needs the trained block configuration "
                             "(layers.TRAINED): the deployed one is forward only")
        E, p, n = backbone.embed_dim, backbone.patch_size, n_last_blocks
        self.backbone = backbone
        self.decoder = decoder
        self.n_last_blocks = n
        if decoder == "setr":
            self.head = DecoderSETR(n * E, num_classes)
        elif decoder == "unet":
            self.head = FeatureUNet(num_classes, in_channels=E)
        elif decoder == "masktrans":
            self.head = MaskTransformer(num_classes, p, d_encoder=n * E)
        elif decoder == "unet_fuse":
            self.head = UNetFuse(num_classes, embed_dim=E)
        else:
            self.head = DecoderSETR(E, num_classes, features=(256, 128, 64))

    def _taps(self, x: torch.Tensor, n: int) -> List[torch.Tensor]:
        if self.train_backbone:
            return self.backbone.get_intermediate_layers(x, n, norm=True)
        with torch.no_grad():
            return self.backbone.get_intermediate_layers(x, n, norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC image. Returns fp32 logits (B, H, W, num_classes)."""
        B, H, W, _ = x.shape
        p = self.backbone.patch_size
        x = x.to(next(self.head.parameters()).dtype)

        def to_map(t, h=H // p, w=W // p):
            return t.reshape(B, h, w, t.shape[-1])

        if self.decoder == "setr":
            logits = self.head(to_map(torch.cat(self._taps(x, self.n_last_blocks), dim=-1)))
        elif self.decoder == "unet":
            logits = self.head(to_map(self._taps(x, 1)[-1]))
        elif self.decoder == "masktrans":
            logits = self.head(torch.cat(self._taps(x, self.n_last_blocks), dim=-1), (H, W))
        elif self.decoder == "unet_fuse":
            x_t2 = resize_bilinear(x, (H * 3 // 2, W * 3 // 2))
            x_d2 = resize_bilinear(x, (H // 2, W // 2))
            tap_o = to_map(self._taps(x, 1)[-1])
            tap_t2 = to_map(self._taps(x_t2, 1)[-1], H * 3 // (2 * p), W * 3 // (2 * p))
            tap_d2 = to_map(self._taps(x_d2, 1)[-1], H // (2 * p), W // (2 * p))
            logits = self.head(x, tap_o, tap_t2, tap_d2)
        else:
            tokens = self.backbone.forward_with_masks(x)["x_norm_patchtokens"]
            logits = self.head(to_map(tokens))
        return resize_bilinear(logits.float(), (H, W))
