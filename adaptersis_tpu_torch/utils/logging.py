"""MetricLogger and SmoothedValue: the part of the JAX package's
`utils/logging.py` that `segment_m2f` uses. Meters keep a window of recent
values (median, avg, max, value) and a running total (global_avg);
`log_every` yields from an iterable and prints the meters with the
iteration's time, the loader's wait and the card's peak memory. One
process: nothing is synchronised across processes."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def device_memory_mb() -> float:
    """The card's peak allocated memory in MiB (0 without a card)."""
    return torch.cuda.max_memory_allocated() / 2 ** 20 if torch.cuda.is_available() else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: defaultdict = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, n: int = 1, **kwargs) -> None:
        """`n` weights this update in each meter's global average."""
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def __getattr__(self, attr):
        meters = self.__dict__.get("meters", {})
        if attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  n_iterations: Optional[int] = None):
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = SmoothedValue(fmt="{avg:.6f}")
        if n_iterations is None:
            try:
                n_iterations = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                n_iterations = -1
        space = len(str(n_iterations))
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == n_iterations - 1:
                eta = iter_time.global_avg * (n_iterations - i) if n_iterations > 0 else 0
                print(self.delimiter.join([
                    header, f"[{i:{space}d}/{n_iterations}]",
                    f"eta: {datetime.timedelta(seconds=int(eta))}", str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                    f"max mem: {device_memory_mb():.0f}MB"]), flush=True)
            end = time.time()
        total = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total))} "
              f"({total / max(n_iterations, 1):.6f} s / it)", flush=True)
