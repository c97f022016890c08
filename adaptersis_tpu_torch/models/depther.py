"""Depth estimation on a frozen backbone (counterpart of the JAX package's
`models/depther.py`; DINOv2's `eval/depth/models/depther/encoder_decoder.py`).

DepthEncoderDecoder: the backbone's last n final-normed taps under
`torch.no_grad()` (only the head trains; the deployed ViT runs K3, K4 and
K6 on the card), reshaped to (B, h, w, C) maps with their cls tokens, then
a decode head: "linear" (BNHead over `n_bins` uniform depth bins, depth =
Σ softmax(logits)·bin centres) or "dpt" (DPTHead); the depth map resized
bilinearly to the input size. `loss` is the scale-invariant log loss plus
0.5 × the multi-scale gradient loss."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .heads import BNHead, DPTHead, gradient_loss, sig_loss


class DepthEncoderDecoder(nn.Module):
    def __init__(self, backbone: nn.Module, head: str = "linear", n_last_blocks: int = 4,
                 min_depth: float = 0.001, max_depth: float = 10.0, n_bins: int = 256):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.n_last_blocks = n_last_blocks
        self.min_depth, self.max_depth, self.n_bins = min_depth, max_depth, n_bins
        E = backbone.embed_dim
        if head == "dpt":
            self.decode_head = DPTHead(embed_dim=E, min_depth=min_depth, max_depth=max_depth)
        elif head == "linear":
            self.decode_head = BNHead(n_last_blocks * 2 * E, num_classes=n_bins)
        else:
            raise ValueError(f"unknown depth head {head!r} (linear, dpt)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1]; depth (B, H, W, 1) fp32. The head's
        BatchNorms follow the module's train/eval mode."""
        B, H, W, _ = x.shape
        p = self.backbone.patch_size
        with torch.no_grad():
            taps = self.backbone.get_intermediate_layers(x, n=self.n_last_blocks,
                                                         return_class_token=True, norm=True)
        taps = [(t[0].reshape(B, H // p, W // p, -1), t[1]) for t in taps]
        if self.head == "dpt":
            depth = self.decode_head(taps)
        else:
            logits = self.decode_head(taps)
            centers = torch.linspace(self.min_depth, self.max_depth, self.n_bins,
                                     device=logits.device, dtype=torch.float32)
            probs = torch.softmax(logits.float(), dim=-1)
            depth = (probs * centers).sum(-1, keepdim=True)
        return resize_bilinear(depth.float(), (H, W), align_corners=False)

    def train(self, mode: bool = True):
        """The backbone stays in eval mode: it is frozen."""
        super().train(mode)
        self.backbone.eval()
        return self

    def loss(self, pred: torch.Tensor, target: torch.Tensor,
             grad_weight: float = 0.5) -> torch.Tensor:
        return (sig_loss(pred[..., 0], target)
                + grad_weight * gradient_loss(pred[..., 0], target))
