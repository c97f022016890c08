"""The epoch sampler of the trainer: a numpy copy of the JAX package's
`data/samplers.py:EpochSampler` (its package imports jax). A deterministic
shuffled permutation per epoch, sharded across ranks."""

from __future__ import annotations

from typing import Iterator

import numpy as np


class EpochSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1, drop_last: bool = True):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.size // self.world_size
        return -(-self.size // self.world_size)

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.size)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if not self.drop_last:
            order = np.concatenate([order, order[:(-len(order)) % self.world_size]])
        shard = order[self.rank::self.world_size]
        if self.drop_last:
            shard = shard[:len(self)]
        return iter(shard.tolist())
