"""MetricLogger, SmoothedValue and profile_trace (counterpart of the JAX
package's `utils/logging.py`; `profile_trace` on `torch.profiler`).
Meters keep a window of recent values (median, avg, max, value) and a
running total (global_avg);
`log_every` yields from an iterable and prints the meters with the
iteration's time, the loader's wait and the card's peak memory.
`synchronize_between_processes` sums the meters' counts and totals over the
ranks (float64), so `global_avg` is the job's; only rank 0 prints and
writes `output_file`."""

from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np
import torch

from ..parallel.dist import all_reduce_sum, get_world_size, is_main_process


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

    def synchronize_between_processes(self, device: Optional[torch.device] = None) -> None:
        """All-reduce [count, total] in float64 (the window stays this
        rank's); `device` is where the collective's tensor lives (a card
        for NCCL)."""
        if get_world_size() == 1:
            return
        t = all_reduce_sum(torch.tensor([self.count, self.total], dtype=torch.float64,
                                        device=device))
        self.count, self.total = int(t[0].item()), float(t[1].item())

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
    def __init__(self, delimiter: str = "  ", output_file: Optional[str] = None):
        self.meters: defaultdict = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.output_file = output_file

    def update(self, n: int = 1, **kwargs) -> None:
        """`n` weights this update in each meter's global average."""
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def synchronize_between_processes(self, device: Optional[torch.device] = None) -> None:
        for name in sorted(self.meters):    # the same order on every rank
            self.meters[name].synchronize_between_processes(device)

    def dump_in_output_file(self, iteration: int, iter_time: float, data_time: float) -> None:
        """Append one JSON line of the meters' medians (rank 0 only)."""
        if self.output_file is None or not is_main_process():
            return
        entry = dict(iteration=iteration, iter_time=iter_time, data_time=data_time,
                     memory_mb=device_memory_mb())
        entry.update({k: v.median for k, v in self.meters.items()})
        with open(self.output_file, "a") as f:
            f.write(json.dumps(entry) + "\n")

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
                self.dump_in_output_file(i, iter_time.avg, data_time.avg)
                eta = iter_time.global_avg * (n_iterations - i) if n_iterations > 0 else 0
                if is_main_process():
                    print(self.delimiter.join([
                        header, f"[{i:{space}d}/{n_iterations}]",
                        f"eta: {datetime.timedelta(seconds=int(eta))}", str(self),
                        f"time: {iter_time}", f"data: {data_time}",
                        f"max mem: {device_memory_mb():.0f}MB"]), flush=True)
            end = time.time()
        total = time.time() - start
        if is_main_process():
            print(f"{header} Total time: {datetime.timedelta(seconds=int(total))} "
                  f"({total / max(n_iterations, 1):.6f} s / it)", flush=True)


class profile_trace:
    """A `torch.profiler` trace of a region, written to `logdir` as a
    Chrome-trace `*.pt.trace.json` that TensorBoard's profiler plugin (and
    chrome://tracing or Perfetto) loads; the CPU's activity, and the card's
    when one is present:

        with profile_trace("/tmp/trace", enabled=args.profile):
            ... train steps ...

    A no-op when disabled; a profiler that cannot start or stop prints a
    warning and never ends the run."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            try:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(
                    activities=acts,
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(self.logdir))
                prof.__enter__()
                self._prof = prof
            except Exception as e:  # the profiler is optional
                print(f"profiler trace unavailable: {e}")
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)
            except Exception as e:
                print(f"profiler stop failed: {e}")
            self._prof = None
        return False
