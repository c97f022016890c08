"""Preprocessing (counterpart of the JAX package's `data/augment.py`): the
training augmentations on the device, validation's /255 and the input
norms.

The training augmentations are albumentations' pipeline of the reference
trainer, drawn per image:
  OneOf[RandomSizedCrop(min_max=(S/2, S) → S) p=.5, PadIfNeeded(S) p=.5]
  → HorizontalFlip p=.5 → RandomRotate90 p=.5 → CLAHE p=.8 (clip ~ U(1, 4))
  → RandomBrightnessContrast p=.8 (±0.2) → RandomGamma p=.8 (0.8–1.2),
with a round to uint8 after the geometry, after CLAHE and at the end.
`draw_train_augment` makes the draws (on the host, from a torch.Generator),
`apply_train_augment` applies them on the tensors' device, so the JAX
package's draws can be fed to it unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..parallel.dist import get_rank, get_world_size
from .clahe import clahe_rgb

Draws = Dict[str, torch.Tensor]

# the reference recipe: RandomSizedCrop(min_max_height=(S/2, S)), CLAHE p=.8
CROP_MIN_FRAC = 0.5
CLAHE_P = 0.8


def draw_train_augment(generator: torch.Generator, B: int, S: int,
                       use_clahe: bool = True) -> Draws:
    """Per-image draws for a batch of B images of S×S pixels, on the CPU:
    crop size, offsets y0 and x0 (size S and offsets 0 when the crop is
    off), flip, rot90 k (0 when off), and for each photometric stage its
    on/off flag and parameters."""
    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(B, generator=generator)

    def bernoulli(p):
        return torch.rand(B, generator=generator) < p

    do_crop = bernoulli(0.5)
    size = torch.randint(int(S * CROP_MIN_FRAC), S + 1, (B,), generator=generator).float()
    size = torch.where(do_crop, size, torch.full_like(size, float(S)))
    max_off = (S - size).clamp(min=0.0)
    y0, x0 = uniform() * max_off, uniform() * max_off
    flip = bernoulli(0.5)
    k = torch.randint(0, 4, (B,), generator=generator)
    k90 = torch.where(bernoulli(0.5), k, torch.zeros_like(k))
    draws = dict(size=size, y0=y0, x0=x0, flip=flip, k90=k90)
    if use_clahe:
        draws.update(clahe=bernoulli(CLAHE_P), clip=uniform(1.0, 4.0))
    draws.update(bc=bernoulli(0.8), alpha=1.0 + uniform(-0.2, 0.2), beta=uniform(-0.2, 0.2),
                 gamma_on=bernoulli(0.8), gamma=uniform(0.8, 1.2))
    return draws


def rank_rows(draws: Draws) -> Draws:
    """This rank's rows of per-image draws made for the global batch: rows
    rank, rank + W, …, the rows of the images the sampler gives it (all of
    them in a single process)."""
    W = get_world_size()
    return draws if W == 1 else {k: v[get_rank()::W] for k, v in draws.items()}


def draws_to(draws: Draws, device: torch.device) -> Draws:
    """Move draws to `device` without making the host wait for the device
    (pinned memory, non-blocking copies)."""
    if device.type == "cpu":
        return draws
    return {k: v.pin_memory().to(device, non_blocking=True) for k, v in draws.items()}


def _lerp_taps(src: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear taps of source coordinates `src` on an axis of n pixels,
    with torch's clamping (the JAX package's `interp_matrix_bilinear`)."""
    src = src.clamp(0.0, n - 1)
    i0 = torch.floor(src)
    return i0.long(), (i0 + 1).clamp(max=n - 1).long(), src - i0


def _crop_resize(img: torch.Tensor, mask: torch.Tensor, d: Draws) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """Per-image (size×size) crop at (y0, x0) resized back to S×S: half-pixel
    bilinear for the image (cv2 INTER_LINEAR), nearest for the mask."""
    B, S = img.shape[0], img.shape[1]
    scale = (d["size"] / S)[:, None]                                       # (B, 1)
    o = torch.arange(S, dtype=torch.float32, device=img.device)[None]
    coords = (o + 0.5) * scale - 0.5
    b = torch.arange(B, device=img.device)[:, None, None]
    i = torch.arange(S, device=img.device)
    y0, y1, ty = _lerp_taps(coords + d["y0"][:, None], S)                  # (B, S)
    x0, x1, tx = _lerp_taps(coords + d["x0"][:, None], S)
    # rows, then columns, as the JAX package applies its two matrices
    rows = (img[b, y0[:, :, None], i] * (1.0 - ty)[:, :, None, None]
            + img[b, y1[:, :, None], i] * ty[:, :, None, None])           # (B, S, S, 3)
    out = (rows[b, i[:, None], x0[:, None, :]] * (1.0 - tx)[:, None, :, None]
           + rows[b, i[:, None], x1[:, None, :]] * tx[:, None, :, None])
    near = torch.floor((o + 0.5) * scale)
    ys = (near + d["y0"][:, None]).clamp(0, S - 1).long()
    xs = (near + d["x0"][:, None]).clamp(0, S - 1).long()
    return out, mask[b, ys[:, :, None], xs[:, None, :]]


def _flip_rot(x: torch.Tensor, d: Draws) -> torch.Tensor:
    """Horizontal flip, then rot90 by k (per image; square images)."""
    sel = (-1,) + (1,) * (x.dim() - 1)
    x = torch.where(d["flip"].reshape(sel), x.flip(2), x)
    out = x
    for k in (1, 2, 3):
        out = torch.where((d["k90"] == k).reshape(sel), torch.rot90(x, k, dims=(1, 2)), out)
    return out


def apply_train_augment(images: torch.Tensor, masks: torch.Tensor,
                        d: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, S, S, 3) uint8, masks (B, S, S) int, draws on the same
    device → (float32 images in [0, 1], int64 masks)."""
    img, mask = _crop_resize(images.float(), masks, d)
    img = torch.round(_flip_rot(img, d).clamp(0, 255)).to(torch.uint8)
    mask = _flip_rot(mask, d)
    if "clahe" in d:
        img = torch.where(d["clahe"][:, None, None, None], clahe_rgb(img, d["clip"]), img)
    x = img.float()
    sel = (-1, 1, 1, 1)
    bc = (x * d["alpha"].reshape(sel) + d["beta"].reshape(sel) * 255.0).clamp(0, 255)
    x = torch.where(d["bc"].reshape(sel), bc, x)
    gm = torch.pow((x / 255.0).clamp(0.0, 1.0), d["gamma"].reshape(sel)) * 255.0
    x = torch.where(d["gamma_on"].reshape(sel), gm, x)
    return torch.round(x.clamp(0, 255)) / 255.0, mask.long()


def val_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 / 255, no normalisation."""
    return images.float() / 255.0


# ImageNet statistics (torchvision's), used by the mask transformer variant
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def apply_input_norm(x01: torch.Tensor, mode: str) -> torch.Tensor:
    """Input normalisation after the /255: "none" (every model but the mask
    transformer), or "imagenet_div255", the reference's
    eval_dinov2_masktrans.py exactly: its transform normalises with the
    ImageNet mean and std, and its dataset then divides the normalised
    tensor by 255 once more. That second division is the reference's
    fault, kept (flagged in ROADMAP.md) so that the weights it trains
    still fit."""
    if mode == "none":
        return x01
    if mode == "imagenet_div255":
        mean = torch.tensor(IMAGENET_MEAN, dtype=x01.dtype, device=x01.device)
        std = torch.tensor(IMAGENET_STD, dtype=x01.dtype, device=x01.device)
        return ((x01 - mean) / std) / 255.0
    raise ValueError(f"unknown input_norm mode {mode!r}")
