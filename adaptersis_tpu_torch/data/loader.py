"""Host-side batching with a background prefetch (a copy of the JAX
package's `data/loader.py`). The host only decodes and collates uint8
frames and int32 masks; augmentation runs on the device in the train step.
A thread pool fills the batches (decode and resize release the GIL, in PIL
and in the native library), and a producer thread keeps `prefetch` batches
ahead of the consumer.

With `pin_memory` the producer hands the frames and masks over as pinned
CPU tensors, so the caller's `.to(device, non_blocking=True)` copies them
while the host goes on."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class DataLoader:
    """Iterable over (images uint8 (B, H, W, 3), masks int32 (B, H, W),
    idx int32 (B,)); a worker's error is raised in the consumer."""

    def __init__(self, dataset, sampler=None, batch_size: int = 16, num_workers: int = 4,
                 drop_last: bool = True, prefetch: int = 2, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        # stream from the sampler: an infinite sampler never ends, so its
        # indices are not materialised up front
        source = iter(self.sampler) if self.sampler is not None else iter(range(len(self.dataset)))
        b = []
        for i in source:
            b.append(i)
            if len(b) == self.batch_size:
                yield b
                b = []
        if b and not self.drop_last:
            yield b

    def _collate(self, pool: ThreadPoolExecutor, batch_idx):
        items = list(pool.map(self.dataset.__getitem__, batch_idx))
        imgs = np.stack([it[0] for it in items])
        masks = np.stack([it[1] for it in items])
        idx = np.asarray([it[2] for it in items], np.int32)
        if self.pin_memory:
            return (torch.from_numpy(imgs).pin_memory(), torch.from_numpy(masks).pin_memory(),
                    idx)
        return imgs, masks, idx

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bidx in self._index_batches():
                        if stop.is_set():
                            return
                        q.put(self._collate(pool, bidx))
                q.put(None)
            except BaseException as e:  # hand the error over, never leave the consumer waiting
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():        # a producer waiting to put sees the stop
                q.get_nowait()
