"""Segmentation decoders (counterpart of the JAX package's
`models/decoders.py`, the reference's `backbones/decoders.py`):
  * FeatureDecoder: the paper's decoder, 3·E channels in, four
    ConvBNReluUp stages and a 3×3 logit conv;
  * DecoderSETR: SETR's progressive up-sampling; DecoderSETRF, with skips
    from encoder maps c1..c3 centre-padded and concatenated;
  * MLAHead and DecoderMLA: four parallel two-conv heads, each up-sampled
    4× to a square (4·w)² (the reference's quirk, kept), concatenated, a
    conv stack, and a resize to img_size = 588 whatever the input size (the
    reference's, kept; the segmentor resizes once more);
  * FusionModel, FCUUp, ConvBlock and DecoderUNet: the UNet-fuse bricks.
NHWC between stages; each conv runs on a channels_last view. Every module
takes its input channels as an argument (flax infers them)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import center_pad, resize_bilinear, resize_nearest, upsample2x
from .encoders import BatchNorm2d
from .unet_parts import Down, DoubleConv, OutConv, Up, nchw, nhwc

DEFAULT_FEATURES = (1024, 512, 256, 128, 64)
SETR_FEATURES = (512, 256, 128, 64)


class ConvBNReluUp(nn.Module):
    """conv 3×3 → BatchNorm (eps 1e-5) → ReLU, then (by default) a 2×
    bilinear up (align_corners=True). NHWC in and out."""

    def __init__(self, in_ch: int, out_ch: int, upsample: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.bn = BatchNorm2d(out_ch)
        self.upsample = upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc(F.relu(self.bn(self.conv(nchw(x)))))
        return upsample2x(x, align_corners=True) if self.upsample else x


class LogitConv(nn.Conv2d):
    """The 3×3 logit conv, NHWC in and out. The JAX package pads its output
    channels to 16 inside the op, a TPU tiling workaround with the same
    result; the port computes the plain conv."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__(in_ch, num_classes, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(super().forward(nchw(x)))


class FeatureDecoder(nn.Module):
    """Four ConvBNReluUp stages of widths features[1:], then a 3×3 logit conv.
    features[0] is the nominal input width; the real one is `in_ch`."""

    def __init__(self, in_ch: int, num_classes: int = 2,
                 features: Sequence[int] = DEFAULT_FEATURES):
        super().__init__()
        widths = [in_ch, *features[1:]]
        for i in range(1, len(widths)):
            self.add_module(f"decoder_{i}", ConvBNReluUp(widths[i - 1], widths[i]))
        self.n_stages = len(widths) - 1
        self.final_out = LogitConv(widths[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"decoder_{i}")(x)
        return self.final_out(x)


class DecoderSETR(FeatureDecoder):
    """SETR's progressive up-sampling: a ConvBNReluUp stage for each of
    `features`, then the logit conv."""

    def __init__(self, in_ch: int, out_channels: int = 2,
                 features: Sequence[int] = SETR_FEATURES):
        super().__init__(in_ch, out_channels, (in_ch, *features))


class DecoderSETRF(nn.Module):
    """SETR with skips: after stages 2, 3 and 4 the stream is centre-padded
    to c3's, c2's and c1's size and concatenated with it."""

    def __init__(self, in_ch: int, skip_channels: Tuple[int, int, int], out_channels: int = 2,
                 features: Sequence[int] = SETR_FEATURES):
        super().__init__()
        c1, c2, c3 = skip_channels
        f = features
        self.decoder_1 = ConvBNReluUp(in_ch, f[0])
        self.decoder_2 = ConvBNReluUp(f[0], f[1])
        self.decoder_3 = ConvBNReluUp(f[1] + c3, f[2])
        self.decoder_4 = ConvBNReluUp(f[2] + c2, f[3])
        self.final_out = LogitConv(f[3] + c1, out_channels)

    def forward(self, x, c1, c2, c3) -> torch.Tensor:
        x = self.decoder_2(self.decoder_1(x))
        for stage, skip in ((self.decoder_3, c3), (self.decoder_4, c2), (None, c1)):
            x = torch.cat([center_pad(x, skip.shape[1:3]), skip], dim=-1)
            if stage is not None:
                x = stage(x)
        return self.final_out(x)


class MLAHead(nn.Module):
    """Four parallel heads (conv-BN-ReLU twice), each resized to the square
    (4·w)² (align_corners=True), concatenated."""

    def __init__(self, in_ch: int, mlahead_channels: int = 128):
        super().__init__()
        m = mlahead_channels
        for i in range(2, 6):
            self.add_module(f"head{i}_a", ConvBNReluUp(in_ch, m, upsample=False))
            self.add_module(f"head{i}_b", ConvBNReluUp(m, m, upsample=False))

    def forward(self, p2, p3, p4, p5) -> torch.Tensor:
        outs = []
        for i, p in enumerate((p2, p3, p4, p5), start=2):
            h = getattr(self, f"head{i}_b")(getattr(self, f"head{i}_a")(p))
            outs.append(resize_bilinear(h, (4 * p.shape[2], 4 * p.shape[2]),
                                        align_corners=True))
        return torch.cat(outs, dim=-1)


class DecoderMLA(nn.Module):
    """MLAHead → conv-BN-ReLU 256 → 128 → 64 → logit conv → bilinear resize
    to (img_size, img_size)."""

    def __init__(self, in_ch: int, img_size: int = 588, mlahead_channels: int = 128,
                 num_classes: int = 2):
        super().__init__()
        self.img_size = img_size
        self.mlahead = MLAHead(in_ch, mlahead_channels)
        self.cls = ConvBNReluUp(4 * mlahead_channels, 256, upsample=False)
        self.cls_1 = ConvBNReluUp(256, 128, upsample=False)
        self.cls_2 = ConvBNReluUp(128, 64, upsample=False)
        self.cls_3 = LogitConv(64, num_classes)

    def forward(self, p2, p3, p4, p5) -> torch.Tensor:
        x = self.cls_2(self.cls_1(self.cls(self.mlahead(p2, p3, p4, p5))))
        return resize_bilinear(self.cls_3(x), (self.img_size, self.img_size))


class FusionModel(nn.Module):
    """conv 1×1 → bilinear resize to `size` → add x1 → ReLU."""

    def __init__(self, in_ch: int, out_channels: int = 384, size: Tuple[int, int] = (42, 42)):
        super().__init__()
        self.size = tuple(size)
        self.conv = nn.Conv2d(in_ch, out_channels, 1)

    def forward(self, x: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(nhwc(self.conv(nchw(x))), self.size)
        return F.relu(x + x1)


class FCUUp(nn.Module):
    """Token map → CNN map: conv 1×1 → BatchNorm (eps 1e-6) → ReLU →
    nearest resize to (H·s, W·s)."""

    def __init__(self, in_ch: int, outplanes: int, up_stride: int):
        super().__init__()
        self.up_stride = up_stride
        self.conv_project = nn.Conv2d(in_ch, outplanes, 1)
        self.bn = BatchNorm2d(outplanes, eps=1e-6)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = nhwc(F.relu(self.bn(self.conv_project(nchw(x)))))
        return resize_nearest(x, (H * self.up_stride, W * self.up_stride))


class ConvBlock(nn.Module):
    """The bottleneck residual block: 1×1 → 3×3 (stride) → 1×1, BatchNorms
    of eps 1e-6, `x_t` added after the first ReLU, a projected residual with
    `res_conv`."""

    def __init__(self, in_ch: int, outplanes: int, stride: int = 1, res_conv: bool = False):
        super().__init__()
        med = outplanes // 4
        self.conv1 = nn.Conv2d(in_ch, med, 1, bias=False)
        self.bn1 = BatchNorm2d(med, eps=1e-6)
        self.conv2 = nn.Conv2d(med, med, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(med, eps=1e-6)
        self.conv3 = nn.Conv2d(med, outplanes, 1, bias=False)
        self.bn3 = BatchNorm2d(outplanes, eps=1e-6)
        self.res_conv = res_conv
        if res_conv:
            self.residual_conv = nn.Conv2d(in_ch, outplanes, 1, stride, bias=False)
            self.residual_bn = BatchNorm2d(outplanes, eps=1e-6)

    def forward(self, x: torch.Tensor, x_t=None) -> torch.Tensor:
        xc = nchw(x)
        h = F.relu(self.bn1(self.conv1(xc)))
        if x_t is not None:
            h = h + nchw(x_t)
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = self.residual_bn(self.residual_conv(xc)) if self.res_conv else xc
        return nhwc(F.relu(h + residual))


class DecoderUNet(nn.Module):
    """A full-image UNet whose bottleneck takes a ViT token map (`vit_ch`
    channels, at 1/dw_stride of the bottleneck's grid) through FCUUp and
    ConvBlock."""

    def __init__(self, n_classes: int = 2, vit_ch: int = 384, outplanes: int = 1024,
                 dw_stride: int = 3, bilinear: bool = False):
        super().__init__()
        f = 2 if bilinear else 1
        self.dw_stride = dw_stride
        self.inc = DoubleConv(3, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // f)
        self.expand_block = FCUUp(vit_ch, outplanes // 4, dw_stride)
        self.fusion_block = ConvBlock(1024 // f, outplanes)
        self.up1 = Up(1024 // f, 512, 512 // f, bilinear)
        self.up2 = Up(512 // f, 256, 256 // f, bilinear)
        self.up3 = Up(256 // f, 128, 128 // f, bilinear)
        self.up4 = Up(128 // f, 64, 64, bilinear)
        self.outc = OutConv(64, n_classes)

    def forward(self, x: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        H, W = x5.shape[1], x5.shape[2]
        xv = self.expand_block(xv, H // self.dw_stride, W // self.dw_stride)
        x5 = self.fusion_block(x5, xv)
        h = self.up2(self.up1(x5, x4), x3)
        return self.outc(self.up4(self.up3(h, x2), x1))
