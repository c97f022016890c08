"""Seeded inputs: frames, masks and augmentation draws.

Frames and masks are made on the card with a `torch.Generator` seeded
from `--seed`: uint8 RGB frames, and binary masks with a share `mask_share`
of instrument pixels. The augmentation draws are made on the host each
step, as the program's trainer takes them, by `draw_train_augment`: a copy
of the program's `data/augment.py:draw_train_augment`, so that no change to
the program moves the draws.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Draws = Dict[str, torch.Tensor]

# AdapterSIS's recipe: RandomSizedCrop(min_max_height=(S/2, S)), CLAHE p=.8
CROP_MIN_FRAC = 0.5
CLAHE_P = 0.8
# offsets of the generators' seeds, so frames, masks and draws never share a stream
FRAMES, MASKS, DRAWS = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 3 + stream)
    return gen


def frames(seed: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """uint8 frames (..., S, S, 3)."""
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=generator(seed, FRAMES, device))


def masks(seed: int, shape: Tuple[int, ...], share: float, device) -> torch.Tensor:
    """int32 binary masks (..., S, S): 1 on a share `share` of the pixels."""
    u = torch.rand(shape, device=device, generator=generator(seed, MASKS, device))
    return (u < share).to(torch.int32)


def draw_train_augment(gen: torch.Generator, B: int, S: int, use_clahe: bool = True) -> Draws:
    """Per-image draws for B images of S×S pixels, on the host: crop size,
    offsets y0 and x0 (size S and offsets 0 when the crop is off), flip,
    rot90 k (0 when off), and for each photometric stage its on/off flag
    and parameters."""
    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(B, generator=gen)

    def bernoulli(p):
        return torch.rand(B, generator=gen) < p

    do_crop = bernoulli(0.5)
    size = torch.randint(int(S * CROP_MIN_FRAC), S + 1, (B,), generator=gen).float()
    size = torch.where(do_crop, size, torch.full_like(size, float(S)))
    max_off = (S - size).clamp(min=0.0)
    y0, x0 = uniform() * max_off, uniform() * max_off
    flip = bernoulli(0.5)
    k = torch.randint(0, 4, (B,), generator=gen)
    k90 = torch.where(bernoulli(0.5), k, torch.zeros_like(k))
    draws = dict(size=size, y0=y0, x0=x0, flip=flip, k90=k90)
    if use_clahe:
        draws.update(clahe=bernoulli(CLAHE_P), clip=uniform(1.0, 4.0))
    draws.update(bc=bernoulli(0.8), alpha=1.0 + uniform(-0.2, 0.2), beta=uniform(-0.2, 0.2),
                 gamma_on=bernoulli(0.8), gamma=uniform(0.8, 1.2))
    return draws


def host_draws(seed: int) -> torch.Generator:
    """The host generator the draws of a run come from."""
    gen = torch.Generator()
    gen.manual_seed(int(seed) * 3 + DRAWS)
    return gen


def to_device(draws: Draws, device) -> Draws:
    """Pinned, non-blocking copies, as the program's own loaders make them."""
    if torch.device(device).type == "cpu":
        return dict(draws)
    return {k: v.pin_memory().to(device, non_blocking=True) for k, v in draws.items()}
