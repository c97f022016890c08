"""Samplers: numpy copies of the JAX package's `data/samplers.py` (its
package imports jax). `EpochSampler`, the trainer's deterministic shuffled
permutation per epoch, sharded across ranks; `InfiniteSampler`, an endless
stream of shuffled epochs strided over the ranks; `ShardedInfiniteSampler`,
the SSL pretraining's resumable endless stream."""

from __future__ import annotations

import itertools
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


class InfiniteSampler:
    """One `default_rng(seed)` reshuffling every pass over the data; rank r
    of W takes yields r, r + W, ... of that stream, after skipping
    advance // W of its own (the JAX sampler's indices, bit for bit)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1, advance: int = 0):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.advance = advance

    def _stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            order = np.arange(self.size)
            if self.shuffle:
                rng.shuffle(order)
            yield from order.tolist()

    def __iter__(self) -> Iterator[int]:
        it = itertools.islice(self._stream(), self.rank, None, self.world_size)
        return itertools.islice(it, self.advance // max(self.world_size, 1), None)


def _make_seed(seed: int, start: int, iter_count: int) -> int:
    return seed + start + (iter_count << 24)


class ShardedInfiniteSampler:
    """One global permutation seeded with `seed`; each rank takes the slice
    perm[rank::world_size], cut to size // world_size. Every window of that
    slice is reshuffled with the seed _make_seed(seed, rank, window), so
    whole windows can be skipped; `advance` skips advance // size windows
    and then advance % size yields of the rank's stream."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1, advance: int = 0):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.advance = advance

    def _windows(self, iter_count: int) -> Iterator[int]:
        perm = (np.random.default_rng(self.seed).permutation(self.size) if self.shuffle
                else np.arange(self.size))
        count = self.size // self.world_size
        shard = perm[self.rank + np.arange(count) * self.world_size]
        while True:
            if self.shuffle:
                rng = np.random.default_rng(_make_seed(self.seed, self.rank, iter_count))
                yield from rng.permutation(shard).tolist()
            else:
                yield from shard.tolist()
            iter_count += 1

    def __iter__(self) -> Iterator[int]:
        iter_count = self.advance // self.size
        remainder = self.advance - iter_count * self.size
        return itertools.islice(self._windows(iter_count), remainder, None)
