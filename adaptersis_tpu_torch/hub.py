"""Pretrained-model entry points (counterpart of the JAX package's `hub.py`):
build a DINOv2 or DINO-v1 backbone by hub name or arch, load a local `.pth`
into it, and DINOv2's linear classifier (`_lc`) on top of it.

    from adaptersis_tpu_torch import hub
    model = hub.build_model_for_eval("dinov2_vitg14", "dinov2_vitg14_pretrain.pth")
    head = hub.load_linear_head_params("dinov2_vitg14_linear_head.pth")
    logits = hub.linear_classifier_logits(model, head, images_nhwc, layers=4)

The URL tables record where Meta publishes the checkpoints; nothing here
downloads them. Images are NHWC floats, as everywhere in the port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .models.vit import DinoVisionTransformer, build_backbone
from .train.convert import load_dinov2_backbone, seeded_init_

_DINOV2_BASE = "https://dl.fbaipublicfiles.com/dinov2"

DINOV2_URLS = {
    "dinov2_vits14": f"{_DINOV2_BASE}/dinov2_vits14/dinov2_vits14_pretrain.pth",
    "dinov2_vitb14": f"{_DINOV2_BASE}/dinov2_vitb14/dinov2_vitb14_pretrain.pth",
    "dinov2_vitl14": f"{_DINOV2_BASE}/dinov2_vitl14/dinov2_vitl14_pretrain.pth",
    "dinov2_vitg14": f"{_DINOV2_BASE}/dinov2_vitg14/dinov2_vitg14_pretrain.pth",
    # the linear classifier heads
    "dinov2_vits14_lc": f"{_DINOV2_BASE}/dinov2_vits14/dinov2_vits14_linear_head.pth",
    "dinov2_vitb14_lc": f"{_DINOV2_BASE}/dinov2_vitb14/dinov2_vitb14_linear_head.pth",
    "dinov2_vitl14_lc": f"{_DINOV2_BASE}/dinov2_vitl14/dinov2_vitl14_linear_head.pth",
    "dinov2_vitg14_lc": f"{_DINOV2_BASE}/dinov2_vitg14/dinov2_vitg14_linear_head.pth",
}

# DINO-v1's checkpoints by (arch, patch size), under
# https://dl.fbaipublicfiles.com/dino/
DINOV1_URLS = {
    ("vit_small", 16): "dino_deitsmall16_pretrain/dino_deitsmall16_pretrain.pth",
    ("vit_small", 8): "dino_deitsmall8_pretrain/dino_deitsmall8_pretrain.pth",
    ("vit_base", 16): "dino_vitbase16_pretrain/dino_vitbase16_pretrain.pth",
    ("vit_base", 8): "dino_vitbase8_pretrain/dino_vitbase8_pretrain.pth",
}

_NAME2ARCH = {
    "dinov2_vits14": "vit_small",
    "dinov2_vitb14": "vit_base",
    "dinov2_vitl14": "vit_large",
    "dinov2_vitg14": "vit_giant2",
}


def build_model_for_eval(name_or_arch: str, weights_path: Optional[str] = None,
                         checkpoint_key: str = "teacher", img_size: int = 518,
                         patch_size: int = 14, device="cuda",
                         seed: int = 0) -> DinoVisionTransformer:
    """The backbone that a hub name (`dinov2_vitg14`) or an arch
    (`vit_giant2`) names, in the deployed configuration, with the `.pth` at
    `weights_path` loaded (its `checkpoint_key` sub-dict, prefixes
    stripped), or a draw from `seed`; on `device`, in eval mode."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' for the plain path)")
    model = build_backbone(_NAME2ARCH.get(name_or_arch, name_or_arch), img_size=img_size,
                           patch_size=patch_size)
    if weights_path:
        load_dinov2_backbone(model, weights_path, checkpoint_key)
    else:
        seeded_init_(model, seed)
    return model.to(device).eval()


def load_linear_head_params(weights_path: str, expect_in: Optional[int] = None) -> nn.Linear:
    """A `_lc` linear head checkpoint ({weight, bias}) as an nn.Linear
    ((1 + layers)·E → 1000 for ImageNet), on the CPU."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    out_dim, in_dim = sd["weight"].shape
    if expect_in is not None and in_dim != expect_in:
        raise ValueError(f"linear head expects in-dim {in_dim}, got {expect_in}")
    head = nn.Linear(in_dim, out_dim)
    head.load_state_dict({"weight": sd["weight"], "bias": sd["bias"]})
    return head


@torch.no_grad()
def linear_classifier_features(model: DinoVisionTransformer, x: torch.Tensor,
                               layers: int = 4) -> torch.Tensor:
    """The `_lc` head's input: layers=1 → [cls | mean(patch)]; layers=4 →
    [the last four blocks' cls | mean(the last block's patch)], each
    final-normed."""
    if layers == 1:
        out = model(x)
        return torch.cat([out["x_norm_clstoken"], out["x_norm_patchtokens"].mean(1)], dim=1)
    if layers == 4:
        taps = model.get_intermediate_layers(x, n=4, return_class_token=True)
        return torch.cat([cls for _, cls in taps] + [taps[3][0].mean(1)], dim=1)
    raise ValueError(f"Unsupported number of layers: {layers}")


@torch.no_grad()
def linear_classifier_logits(model: DinoVisionTransformer, head: nn.Linear, x: torch.Tensor,
                             layers: int = 4) -> torch.Tensor:
    """The full `_lc` forward: (B, 1000) ImageNet logits."""
    feats = linear_classifier_features(model, x, layers)
    return head.to(device=feats.device, dtype=feats.dtype)(feats)
