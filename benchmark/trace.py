"""The benchmark's own spans and its reduction of a profiler trace.

`Spans` records a CUDA event pair around each call of the modules or the
function it wraps, from the benchmark's side (forward pre- and post-hooks,
or a wrapper put in the function's place), and gives the device
milliseconds a step spent inside them. `profile` runs steps under
torch.profiler and reduces the trace to the device's busy seconds (the
union of its operations' intervals), the window's seconds, the operations
that took the most time, and the idle gaps labelled by what the host was
doing then. `Clock` and `sync` time the parts of set-up.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Seconds of each part of set-up, each ending in a synchronise."""

    def __init__(self, device):
        self.device, self.parts, self.t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


class Spans:
    """CUDA event pairs around calls; `mark_step` closes a step."""

    def __init__(self):
        self.steps: List[List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = [[]]
        self._open: List[torch.cuda.Event] = []
        self._undo: List[Callable[[], None]] = []

    def begin(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open.append(ev)

    def end(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((self._open.pop(), ev))

    def on_modules(self, modules: Sequence[nn.Module]) -> "Spans":
        for m in modules:
            h1 = m.register_forward_pre_hook(lambda *_: self.begin())
            h2 = m.register_forward_hook(lambda *_: self.end())
            self._undo += [h1.remove, h2.remove]
        return self

    def on_function(self, module, attr: str) -> "Spans":
        fn = getattr(module, attr)

        def wrapped(*a, **kw):
            self.begin()
            try:
                return fn(*a, **kw)
            finally:
                self.end()

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))
        return self

    def mark_step(self) -> None:
        self.steps.append([])

    def remove(self) -> None:
        for undo in self._undo:
            undo()
        self._undo = []

    def ms_per_step(self) -> float | None:
        """Mean device ms a step inside the spans, over the steps that have
        any; None when none has."""
        torch.cuda.synchronize()
        per = [sum(a.elapsed_time(b) for a, b in s) for s in self.steps if s]
        return sum(per) / len(per) if per else None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile(step: Callable[[], None], n: int) -> dict:
    """Run `step` n times under torch.profiler (CPU and CUDA activity),
    synchronising at the end. Returns busy_s, window_s, device_ops and
    idle_gaps (each the ten largest, [name, seconds])."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function("bench.step"):
                    step()
            with torch.profiler.record_function("bench.synchronize"):
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    device: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    busy = _union([(a, b) for a, b, _ in device])
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_op[name] += (b - a) / 1e6
    gaps: Dict[str, float] = defaultdict(float)
    win = [(a, b) for a, b, name in host if name == "bench.window"]
    lo, hi = (win[0] if win else (busy[0][0], busy[-1][1])) if busy else (0.0, 0.0)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), label in zip(idle, _host_labels(host, [(a + b) / 2 for a, b in idle])):
        gaps[label] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": seconds,
            "device_ops": top(by_op), "idle_gaps": top(gaps)}


def _host_labels(host: List[Tuple[float, float, str]], times: List[float]) -> List[str]:
    """The innermost host operation running at each of the ascending
    `times`: a sweep over the host operations in order of their start."""
    host = sorted(host)
    out, active, j = [], [], 0
    for t in times:
        while j < len(host) and host[j][0] <= t:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= t]
        out.append(min(active, key=lambda h: h[1] - h[0])[2] if active else "no host operation")
    return out
