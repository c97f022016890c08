"""Seeded synthetic frames and masks: a numpy copy of the JAX package's
`data/datasets.py:SyntheticSeg` (whose package imports jax), equal item by
item. Random ellipses as "instruments" on a striped background."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticSeg:
    def __init__(self, n: int = 64, imsize: int = 140, num_classes: int = 2, seed: int = 0):
        self.n = n
        self.imsize = imsize
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, int]:
        if not 0 <= index < self.n:
            raise IndexError(index)
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.imsize
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.stack(
            [np.sin(6 * np.pi * (xx + rng.uniform())) * 0.25 + 0.5 for _ in range(3)], -1)
        mask = np.zeros((s, s), np.int32)
        for c in range(1, self.num_classes):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            rx, ry = rng.uniform(0.05, 0.25, 2)
            ell = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1
            mask[ell] = c
            img[ell] = img[ell] * 0.5 + np.asarray([0.8, 0.2 * c, 0.1])[None] * 0.5
        return (img * 255).clip(0, 255).astype(np.uint8), mask, index

    def batches(self, batch_size: int):
        """(images (b, s, s, 3) uint8, masks (b, s, s) int32) in order; the
        last batch may be short."""
        for i in range(0, self.n, batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, self.n))]
            yield np.stack([a for a, _, _ in items]), np.stack([m for _, m, _ in items])
