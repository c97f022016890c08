"""Attention maps of a ViT's last block (counterpart of the JAX package's
`tools/visualize_attention.py`): each head's [CLS] → patch attention,
upsampled to the image, and the mask of the patches that hold
`--threshold` of the head's attention mass, as PNGs.

    python -m adaptersis_tpu_torch.visualize_attention --arch vit_giant2 \\
        --pretrained_weights dinov2_vitg14_pretrain.pth --image_path frame.png \\
        --output_dir maps

Writes `attn-head{j}.png` and `mask_th{threshold}_head{j}.png` for every
head j. Without `--image_path` the image is seeded noise; without
`--pretrained_weights` (or if the file is missing) the backbone is a seeded
draw. The backbone runs in the deployed configuration on `--device` (the
card unless `--device cpu`); the probabilities are fp32.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from .models.vit import build_backbone
from .train.convert import load_dinov2_backbone, seeded_init_


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("visualize_attention")
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=14, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--image_path", default=None, type=str)
    p.add_argument("--image_size", default=(448, 448), type=int, nargs="+")
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--threshold", type=float, default=0.6,
                   help="keep this fraction of each head's total attention mass")
    p.add_argument("--platform", default=None, type=str,
                   help="the JAX package's platform choice, not acted on: --device picks the "
                        "device")
    p.add_argument("--device", default="cuda", type=str)
    return p


def mass_masks(cls_attn: np.ndarray, threshold: float) -> np.ndarray:
    """(heads, h, w) 0/1: the patches of largest attention whose sum
    holds `threshold` of each head's mass."""
    nh = cls_attn.shape[0]
    flat = cls_attn.reshape(nh, -1)
    flat = flat / flat.sum(axis=1, keepdims=True)
    order = np.argsort(flat, axis=1)
    cum = np.cumsum(np.take_along_axis(flat, order, axis=1), axis=1)
    masks = np.zeros_like(flat)
    np.put_along_axis(masks, order, (cum > (1 - threshold)).astype(np.float32), axis=1)
    return masks.reshape(cls_attn.shape)


def run(args) -> Tuple[torch.Tensor, List[str]]:
    """Write the maps; returns the last block's attention probabilities
    (heads, N, N) on the CPU and the paths written."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    p = args.patch_size
    model = build_backbone(args.arch, img_size=518, patch_size=p)
    h, w = (args.image_size * 2)[:2]
    h, w = h - h % p, w - w % p
    if args.image_path:
        img = Image.open(args.image_path).convert("RGB").resize((w, h), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 255.0
    else:
        print("no --image_path provided, using random noise")
        x = np.random.default_rng(0).uniform(size=(h, w, 3)).astype(np.float32)
    if args.pretrained_weights and os.path.isfile(args.pretrained_weights):
        load_dinov2_backbone(model, args.pretrained_weights, args.checkpoint_key)
    else:
        print("no pretrained weights found, using random init")
        seeded_init_(model, 0)
    model = model.to(device).eval()
    with torch.no_grad():
        attn = model.get_last_selfattention(torch.from_numpy(x)[None].to(device))[0].cpu()
    nh = attn.shape[0]
    hf, wf = h // p, w // p
    cls_attn = attn[:, 0, 1:].reshape(nh, hf, wf).numpy()      # CLS → patches
    masks = mass_masks(cls_attn, args.threshold)

    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for j in range(nh):
        m = cls_attn[j] / max(cls_attn[j].max(), 1e-9)
        for name, a in ((f"attn-head{j}.png", m),
                        (f"mask_th{args.threshold}_head{j}.png", masks[j])):
            path = os.path.join(args.output_dir, name)
            Image.fromarray((a * 255).astype(np.uint8)).resize((w, h), Image.NEAREST).save(path)
            paths.append(path)
    print(f"saved {nh} attention maps to {args.output_dir}")
    return attn, paths


def main(argv: Optional[List[str]] = None) -> List[str]:
    return run(get_args_parser().parse_args(argv))[1]


if __name__ == "__main__":
    main()
