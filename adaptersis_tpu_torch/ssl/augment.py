"""DINO multi-crop augmentation (counterpart of the JAX package's
`ssl/augment.py:multicrop_augment`), split as the trainer's augmentation is:
`draw_multicrop` makes every random draw on the host from a
`torch.Generator`, `apply_multicrop` applies them on the images' device, so
the JAX function's own draws can be fed to it unchanged.

Per image: 2 global crops and n local crops. Each crop: a random-resized
crop (area scale (0.32, 1.0) global, (0.05, 0.32) local; log-uniform aspect
ratio in (3/4, 4/3)) resized bilinearly with torch's clamping, hflip p=.5,
colour jitter p=.8 (brightness ±0.4, contrast ±0.4, saturation ±0.2), then
grayscale p=.2, a 9-tap gaussian blur (σ ~ U(0.1, 2); p=1 on the first
global crop, .1 on the second, .5 on the locals), solarize (p=.2 on the
second global crop only), and the ImageNet normalisation.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from ..data.augment import _lerp_taps

Draws = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY = (0.299, 0.587, 0.114)
GLOBAL_SCALE = (0.32, 1.0)
LOCAL_SCALE = (0.05, 0.32)
RATIO = (3 / 4, 4 / 3)
BLUR_RADIUS = 4
# blur and solarize probabilities of the two global crops; the locals blur
# with p = .5 and never solarize
GLOBAL_BLUR_P = (1.0, 0.1)
GLOBAL_SOLARIZE_P = (0.0, 0.2)
LOCAL_BLUR_P = 0.5


def draw_multicrop(generator: torch.Generator, B: int, n_local: int) -> Draws:
    """The draws of B images' 2 + n_local crops, each a (B, 2 + n_local)
    tensor on the CPU, crop slot j = 0, 1 the global crops: the crop's area
    share, log aspect ratio and offset fractions uy, ux; the flip; the
    colour jitter's switch and factors; the grayscale switch; the blur's
    switch and σ; the solarize switch."""
    n = 2 + n_local
    shape = (B, n)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    def bernoulli(p):
        return torch.rand(shape, generator=generator) < p

    lo = torch.tensor([GLOBAL_SCALE[0]] * 2 + [LOCAL_SCALE[0]] * n_local)
    hi = torch.tensor([GLOBAL_SCALE[1]] * 2 + [LOCAL_SCALE[1]] * n_local)
    blur_p = torch.tensor(list(GLOBAL_BLUR_P) + [LOCAL_BLUR_P] * n_local)
    sol_p = torch.tensor(list(GLOBAL_SOLARIZE_P) + [0.0] * n_local)
    return dict(area=uniform(lo, hi), log_r=uniform(math.log(RATIO[0]), math.log(RATIO[1])),
                uy=uniform(0.0, 1.0), ux=uniform(0.0, 1.0), flip=bernoulli(0.5),
                jitter=bernoulli(0.8), bright=uniform(0.6, 1.4), contrast=uniform(0.6, 1.4),
                sat=uniform(0.8, 1.2), gray=bernoulli(0.2), blur=bernoulli(blur_p),
                sigma=uniform(0.1, 2.0), solarize=bernoulli(sol_p))


def _crop_resize(img: torch.Tensor, d: Draws, out: int) -> torch.Tensor:
    """torchvision's RandomResizedCrop parameters from the draws, then the
    crop resized to out × out, bilinear, rows then columns."""
    B, H, W, _ = img.shape
    area = H * W * d["area"]
    r = torch.exp(d["log_r"])
    w = torch.sqrt(area * r).clamp(8.0, W)
    h = torch.sqrt(area / r).clamp(8.0, H)
    y0, x0 = d["uy"] * (H - h), d["ux"] * (W - w)
    o = torch.arange(out, dtype=torch.float32, device=img.device)[None]
    ys = y0[:, None] + (o + 0.5) * h[:, None] / out - 0.5
    xs = x0[:, None] + (o + 0.5) * w[:, None] / out - 0.5
    b = torch.arange(B, device=img.device)[:, None, None]
    cols = torch.arange(W, device=img.device)
    i0, i1, ty = _lerp_taps(ys, H)                                          # (B, out)
    rows = (img[b, i0[:, :, None], cols] * (1.0 - ty)[:, :, None, None]
            + img[b, i1[:, :, None], cols] * ty[:, :, None, None])         # (B, out, W, 3)
    j0, j1, tx = _lerp_taps(xs, W)
    r_ = torch.arange(out, device=img.device)[:, None]
    return (rows[b, r_, j0[:, None, :]] * (1.0 - tx)[:, None, :, None]
            + rows[b, r_, j1[:, None, :]] * tx[:, None, :, None])


@functools.lru_cache(maxsize=None)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A constant vector on `device`, copied there once."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _per_image(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img @ _const(GRAY, img.device)


def _color_jitter(img: torch.Tensor, d: Draws) -> torch.Tensor:
    """Brightness, contrast (about the image's mean), saturation (about its
    gray), each clipped to [0, 1], with p = .8; then grayscale with p = .2."""
    out = (img * _per_image(d["bright"])).clamp(0, 1)
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = ((out - mean) * _per_image(d["contrast"]) + mean).clamp(0, 1)
    g = _gray(out)[..., None]
    out = ((out - g) * _per_image(d["sat"]) + g).clamp(0, 1)
    img = torch.where(_per_image(d["jitter"]), out, img)
    return torch.where(_per_image(d["gray"]), _gray(img)[..., None].expand_as(img), img)


def _blur(img: torch.Tensor, d: Draws) -> torch.Tensor:
    """Separable 9-tap gaussian, zero-padded at the borders, rows then
    columns, where the blur switch is on."""
    r = BLUR_RADIUS
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (xs[None] / d["sigma"][:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)                                      # (B, 9)
    S = img.shape[1]
    out = img
    for dim in (1, 2):
        pad = torch.nn.functional.pad(out, (0, 0, r, r) if dim == 2 else (0, 0, 0, 0, r, r))
        out = sum(k[:, t].reshape(-1, 1, 1, 1) * pad.narrow(dim, t, S) for t in range(2 * r + 1))
    return torch.where(_per_image(d["blur"]), out, img)


def _one_crop(img: torch.Tensor, d: Draws, out: int) -> torch.Tensor:
    c = _crop_resize(img, d, out)
    c = torch.where(_per_image(d["flip"]), c.flip(2), c)
    c = _color_jitter(c, d)
    c = _blur(c, d)
    c = torch.where(_per_image(d["solarize"]), torch.where(c >= 0.5, 1.0 - c, c), c)
    return (c - _const(IMAGENET_MEAN, c.device)) / _const(IMAGENET_STD, c.device)


def apply_multicrop(images_u8: torch.Tensor, draws: Draws, global_size: int = 224,
                    local_size: int = 96) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 and draws on its device → global crops (2B, Sg,
    Sg, 3), crop slot-major (all images' first crop, then their second), and
    local crops (n_local·B, Sl, Sl, 3), slot-major too; normalised fp32."""
    imgs = images_u8.float() / 255.0
    n = draws["area"].shape[1]
    crops = [_one_crop(imgs, {k: v[:, j] for k, v in draws.items()},
                       global_size if j < 2 else local_size) for j in range(n)]
    local = (torch.cat(crops[2:]) if n > 2 else
             imgs.new_zeros((0, local_size, local_size, 3)))
    return torch.cat(crops[:2]), local

