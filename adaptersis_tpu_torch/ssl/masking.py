"""iBOT block-wise mask sampling and collate: a copy of the JAX package's
`ssl/masking.py` (jax-free, but the port imports nothing of that package),
giving bit-identical masks for the same seeds.

`MaskingGenerator` places rectangular blocks of log-uniform aspect ratio
until a target count of masked patches is reached (Python `random`);
`collate_masks` draws per-sample ratios for a mask_probability share of the
batch (numpy `default_rng`); `collate_masks_with_indices` adds the flat
indices and weights of the masked tokens, padded to the static
`mask_upperbound`, which the iBOT heads gather (`MaskInfo`)."""

from __future__ import annotations

import math
import random
from typing import NamedTuple, Optional, Tuple

import numpy as np


class MaskingGenerator:
    def __init__(self, input_size: Tuple[int, int], num_masking_patches: Optional[int] = None,
                 min_num_patches: int = 4, max_num_patches: Optional[int] = None,
                 min_aspect: float = 0.3, max_aspect: Optional[float] = None):
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = num_masking_patches if max_num_patches is None else max_num_patches
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int, rng: random.Random) -> int:
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(self.min_num_patches, max_mask_patches)
            aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                # Kept from the JAX package, which differs from upstream
                # DINOv2 here: randint's upper bound is inclusive, so
                # H − h − 1 never places a block against the last row or
                # column (upstream: H − h). Kept so that the masks match.
                top = rng.randint(0, self.height - h - 1)
                left = rng.randint(0, self.width - w - 1)
                num_masked = mask[top:top + h, left:left + w].sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    mask[top:top + h, left:left + w] = 1
                    delta += h * w - num_masked
            if delta > 0:
                break
        return delta

    def __call__(self, num_masking_patches: int = 0, seed: Optional[int] = None) -> np.ndarray:
        rng = random.Random(seed)
        mask = np.zeros((self.height, self.width), dtype=bool)
        count = 0
        while count < num_masking_patches:
            max_mask = min(num_masking_patches - count, self.max_num_patches)
            delta = self._mask_block(mask, max_mask, rng)
            if delta == 0:
                break
            count += delta
        return mask


def collate_masks(batch_size: int, n_tokens: int, mask_generator: MaskingGenerator,
                  mask_ratio_range: Tuple[float, float] = (0.1, 0.5),
                  mask_probability: float = 0.5, seed: Optional[int] = None) -> np.ndarray:
    """(batch_size, n_tokens) bool: for a mask_probability share of the
    samples a ratio and a block mask, the rest unmasked, in a seeded order."""
    rng = np.random.default_rng(seed)
    n_samples_masked = int(batch_size * mask_probability)
    probs = np.linspace(*mask_ratio_range, n_samples_masked + 1)
    masks = []
    for i in range(n_samples_masked):
        ratio = rng.uniform(probs[i], probs[i + 1])
        masks.append(mask_generator(int(n_tokens * ratio),
                                    seed=None if seed is None else seed + i).flatten())
    for _ in range(batch_size - n_samples_masked):
        masks.append(np.zeros(n_tokens, dtype=bool))
    masks = np.stack(masks)
    return masks[rng.permutation(batch_size)]


class MaskInfo(NamedTuple):
    """The masked-token plumbing of the iBOT heads, with a static row count:
    padding rows carry index 0 and weight 0."""

    masks: np.ndarray      # (B, n_tokens) bool: mask-token substitution
    indices: np.ndarray    # (upperbound,) int32 flat indices into (B·n_tokens)
    weights: np.ndarray    # (upperbound,) f32: 1/n_masked(sample) per token; 0 = pad
    n_masked: np.ndarray   # () int32: real rows in indices/weights


def mask_upperbound(batch_size: int, n_tokens: int,
                    mask_ratio_range: Tuple[float, float] = (0.1, 0.5),
                    mask_probability: float = 0.5) -> int:
    """Σ_i int(n_tokens · prob_max_i): a static bound on the masked count."""
    n_samples_masked = int(batch_size * mask_probability)
    probs = np.linspace(*mask_ratio_range, n_samples_masked + 1)
    return int(sum(int(n_tokens * probs[i + 1]) for i in range(n_samples_masked)))


def collate_masks_with_indices(batch_size: int, n_tokens: int,
                               mask_generator: MaskingGenerator,
                               mask_ratio_range: Tuple[float, float] = (0.1, 0.5),
                               mask_probability: float = 0.5,
                               seed: Optional[int] = None) -> MaskInfo:
    masks = collate_masks(batch_size, n_tokens, mask_generator,
                          mask_ratio_range, mask_probability, seed)
    ub = mask_upperbound(batch_size, n_tokens, mask_ratio_range, mask_probability)
    return mask_info(masks, ub)


def mask_info(masks: np.ndarray, ub: int) -> MaskInfo:
    """The gathered-token plumbing of (B, n_tokens) bool masks, padded to
    `ub` rows."""
    n_tokens = masks.shape[1]
    idx = np.nonzero(masks.reshape(-1))[0].astype(np.int32)
    n_masked = idx.shape[0]
    assert n_masked <= ub, (n_masked, ub)
    per_sample = masks.sum(axis=1).clip(min=1).astype(np.float32)
    indices = np.zeros(ub, np.int32)
    weights = np.zeros(ub, np.float32)
    indices[:n_masked] = idx
    weights[:n_masked] = (1.0 / per_sample)[idx // n_tokens]
    return MaskInfo(masks=masks, indices=indices, weights=weights, n_masked=np.int32(n_masked))


def rank_masks(info: MaskInfo, n_tokens: int, rank: int, world_size: int,
               mask_ratio_range: Tuple[float, float] = (0.1, 0.5),
               mask_probability: float = 0.5) -> MaskInfo:
    """A rank's share of the masks made for the global batch's 2B global
    crops ([crop 0 of the B images; crop 1 of them]): the rows of its
    images rank, rank + W, … in both halves, re-gathered and padded to the
    largest count any 2B/W of the rows can hold. One process: `info`."""
    if world_size == 1:
        return info
    B = info.masks.shape[0] // 2
    mine = np.arange(rank, B, world_size)
    masks = info.masks[np.concatenate([mine, B + mine])]
    n_masked_max = int(2 * B * mask_probability)
    probs = np.linspace(*mask_ratio_range, n_masked_max + 1)
    largest = sorted((int(n_tokens * probs[i + 1]) for i in range(n_masked_max)), reverse=True)
    return mask_info(masks, sum(largest[:masks.shape[0]]))
