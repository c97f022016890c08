"""Serving traffic: a closed loop of one client segmenting recorded video.

Each request is a clip of uint8 frames held in pinned host memory, from a
pool of clips made from the seed. A request copies its clip to the card,
runs the program's serving model (`cast_for_inference`), takes the argmax
as uint8 masks, copies them to pinned host memory and waits for them; the
client then sends the next. A request's latency runs from its submission
to its masks being in host memory, timed by CUDA events recorded before
the copy in and after the copy out (the stream is idle at submission, so
the first event fires as it is recorded).

Mix parameters: `frames` (a clip), `clips` (the pool), `warmup_requests`,
`checked_requests` (requests of the window whose masks are compared with
the reference, drawn from the seed once the window has closed),
`traced_steps` and `profiled_steps` (requests under the probes and under
torch.profiler).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from .. import inputs, program, weights
from ..counts import flops
from ..reference import steps
from ..reference.precision import FP32
from ..trace import Clock, sync


class Driver:
    kind = "serve"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.F, self.S = mix["frames"], cfg["imsize"]
        self.units_per_step = self.F

    def setup(self) -> None:
        cfg, dev, F, S = self.cfg, self.device, self.F, self.S
        clock = Clock(dev)
        program.load_kernels(dev)
        clock.lap("kernels")
        clips = inputs.frames(self.seed, (self.mix["clips"], F, S, S, 3), dev)
        pin = dev.type == "cuda"
        self.clips = clips.cpu().pin_memory() if pin else clips
        del clips
        w = weights.make(cfg, self.seed, dev)
        clock.lap("inputs_weights")
        self.model = program.serving_model(cfg, program.build_model(cfg, w, dev))
        del w
        clock.lap("model")
        self.x = torch.empty((F, S, S, 3), dtype=torch.uint8, device=dev)
        self.out = [torch.empty((F, S, S), dtype=torch.uint8) for _ in range(2)]
        if pin:
            self.out = [o.pin_memory() for o in self.out]
        self.i = 0
        for _ in range(self.mix["warmup_requests"]):
            self.step()
        clock.lap("warmup")
        self.setup_parts = clock.parts
        self.served: List[Tuple[int, torch.Tensor]] = []

    def _submit(self, i: int):
        timed = self.device.type == "cuda"
        st = torch.cuda.Event(enable_timing=True) if timed else None
        en = torch.cuda.Event(enable_timing=True) if timed else None
        if timed:
            st.record()
        self.x.copy_(self.clips[i % self.mix["clips"]], non_blocking=True)
        with torch.no_grad():
            logits = self.model(self.x.float() / 255.0)
            masks = logits.argmax(dim=-1).to(torch.uint8)
        self.out[i % 2].copy_(masks, non_blocking=True)
        if timed:
            en.record()
        return st, en

    def step(self) -> None:
        _, en = self._submit(self.i)
        if en is not None:
            en.synchronize()
        self.i += 1

    def window(self, seconds: float) -> dict:
        sync(self.device)
        dispatch, events = [], []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            st, en = self._submit(self.i)
            dispatch.append(time.perf_counter() - a)
            if events:      # the previous request's masks, while this one runs
                self.served.append((self.i - 1, self.out[(self.i - 1) % 2].clone()))
            if en is not None:
                en.synchronize()
            events.append((st, en))
            self.i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        self.served.append((self.i - 1, self.out[(self.i - 1) % 2].clone()))
        lat = [a.elapsed_time(b) for a, b in events] if events[0][0] is not None else []
        n = len(events)
        return {"steps": n, "units": n * self.F, "seconds": t1 - t0, "dispatch_s": dispatch,
                "latency_ms": lat}

    def attempted_failed(self) -> tuple:
        return len(self.served), 0

    def flops_per_step(self) -> float:
        c = self.cfg
        return flops.forward_flops(self.F, c["imsize"], c["patch_size"], c["embed_dim"],
                                   c["depth"], c["n_last_blocks"], c["num_classes"])

    def probe_modules(self) -> dict:
        return {"walk": list(self.model.backbone.blocks),
                "adapter": [self.model.cross_vit, self.model.cross_cnn]}

    def free(self) -> None:
        del self.model, self.x
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def sample(self) -> List[Tuple[int, torch.Tensor]]:
        """`checked_requests` served requests, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        k = min(self.mix["checked_requests"], len(self.served))
        pick = rng.choice(len(self.served), size=k, replace=False)
        return [self.served[j] for j in sorted(pick)]

    def clip(self, i: int) -> torch.Tensor:
        return self.clips[i % self.mix["clips"]].to(self.device)

    def numbers(self, prec=FP32(), fault: str | None = None, program_side: bool = True,
                ref: dict | None = None) -> tuple:
        """({"margin_gap": …}, reference logits by request): the served masks
        of the sampled requests against the fp32 reference, or, with
        `program_side` False, the reference in `prec` put in the program's
        place, with an optional planted `fault` ("half": the second half of
        each clip left out; "altered": the first frame's answer altered)."""
        w = weights.make(self.cfg, self.seed, self.device)
        model = steps.load(self.cfg, w, self.device).eval()
        del w
        ref = {} if ref is None else ref
        gaps = []
        for i, served in self.sample():
            if i not in ref:
                ref[i] = steps.serve_logits(model, self.clip(i))
            if program_side:
                masks = served.to(self.device)
            else:
                masks = steps.serve_logits(model, self.clip(i), prec).argmax(-1)
                if fault == "half":
                    masks[self.F // 2:] = 0
                elif fault == "altered":
                    masks[0] = (masks[0] + 1) % self.cfg["num_classes"]
            gaps.append(steps.margin_gap(masks, ref[i]))
        return {"margin_gap": max(gaps)}, ref
