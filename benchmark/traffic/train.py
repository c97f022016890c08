"""Training traffic: the program's `Trainer.train_step` on a pool of
batches staged on the card, with fresh augmentation draws made on the host
each step.

Mix parameters: `batch` (images a step), `pool` (batches staged on the
card, used in turn), `mask_share` (share of instrument pixels in the
masks), `checked_steps` (the first steps of the run, which set-up drives
through the same call and feed as the window and which the reference
follows), `traced_steps` (steps under the probes' events) and
`profiled_steps` (steps under torch.profiler).

The window issues steps until its seconds have passed, synchronises once,
and counts every image of every step over the whole time.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from .. import inputs, program, weights
from ..counts import flops
from ..reference import steps
from ..reference.precision import FP32
from ..trace import Clock, sync


class Driver:
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.B, self.S = mix["batch"], cfg["imsize"]
        self.units_per_step = self.B

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        cfg, mix, dev, B, S = self.cfg, self.mix, self.device, self.B, self.S
        P = mix["pool"]
        clock = Clock(dev)
        program.load_kernels(dev)
        clock.lap("kernels")
        self.images = inputs.frames(self.seed, (P, B, S, S, 3), dev)
        self.masks = inputs.masks(self.seed, (P, B, S, S), mix["mask_share"], dev)
        self.gen = inputs.host_draws(self.seed)
        w = weights.make(cfg, self.seed, dev)
        clock.lap("inputs_weights")
        self.model = program.build_model(cfg, w, dev)
        del w
        self.trainer = program.trainer(cfg, self.model)
        clock.lap("model")
        ids = {id(p) for p in self.trainer.params}
        self.named = [(n, p) for n, p in self.model.named_parameters() if id(p) in ids]
        self.i = 0
        self.losses: List[torch.Tensor] = []
        self.first_draws = []
        self.walk1 = None
        keep = self.model.backbone.blocks[-1].register_forward_hook(self._keep_walk)
        for k in range(mix["checked_steps"]):
            d = self.draw()
            self.first_draws.append(d)
            self._step(d)
            if k == 0:
                keep.remove()
                state = self.trainer.optimizer.state
                # a step that left no momentum (nothing stepped) gave no gradient
                self.buf1 = {n: state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                             .detach().to("cpu", copy=True) for n, p in self.named}
        self.p_after = {n: p.detach().to("cpu", copy=True) for n, p in self.named}
        self.stats_after = {n: b.detach().to("cpu", copy=True)
                            for n, b in steps.bn_stats(self.model.named_buffers()).items()}
        self.first_losses = [float(x) for x in self.losses]
        self.losses = []
        clock.lap("first_steps")
        self.setup_parts = clock.parts

    def _keep_walk(self, module, args, out) -> None:
        """The first step's clean walk: the first call of the last block."""
        if self.walk1 is None:
            self.walk1 = out.detach().to("cpu", copy=True)

    def draw(self) -> Dict[str, torch.Tensor]:
        return inputs.draw_train_augment(self.gen, self.B, self.S, self.cfg["use_clahe"])

    def _step(self, d) -> None:
        b = self.i % self.mix["pool"]
        self.losses.append(self.trainer.train_step(self.images[b], self.masks[b],
                                                   inputs.to_device(d, self.device), epoch=0))
        self.i += 1

    def step(self) -> None:
        self._step(self.draw())

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        sync(self.device)
        dispatch = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self.step()
            dispatch.append(time.perf_counter() - a)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        t1 = time.perf_counter()
        n = len(dispatch)
        return {"steps": n, "units": n * self.B, "seconds": t1 - t0, "dispatch_s": dispatch}

    def attempted_failed(self) -> tuple:
        bad = sum(not math.isfinite(float(x)) for x in self.losses)
        return len(self.losses), bad

    def flops_per_step(self) -> float:
        c = self.cfg
        return flops.train_step_flops(self.B, c["imsize"], c["patch_size"], c["embed_dim"],
                                      c["depth"], c["n_last_blocks"], c["num_classes"])

    def probe_modules(self) -> dict:
        return {"walk": list(self.model.backbone.blocks),
                "adapter": [self.model.cross_vit, self.model.cross_cnn],
                "augment": (program.trainer_module(), "apply_train_augment")}

    def free(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        del self.trainer, self.model, self.named
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def batches(self):
        P = self.mix["pool"]
        return [(self.images[k % P], self.masks[k % P], inputs.to_device(d, self.device))
                for k, d in enumerate(self.first_draws)]

    def program_readings(self, w: Dict[str, torch.Tensor]) -> dict:
        wd = self.cfg["weight_decay"]
        dev = self.device
        return {"losses": self.first_losses,
                "grad1": {n: float((b.to(dev) - wd * w[n]).norm()) for n, b in self.buf1.items()},
                "delta": {n: float((p.to(dev) - w[n]).norm()) for n, p in self.p_after.items()},
                "stats": {n: float((b.to(dev) - w[n]).norm()) for n, b in self.stats_after.items()},
                "walk1": self.walk1.to(dev)}

    def numbers(self, prec=FP32(), rows: slice = slice(None), program_side: bool = True,
                ref: dict | None = None, update: bool = True) -> tuple:
        """(numbers, reference readings): the program's first steps
        against the reference's, or, with `program_side` False, the
        reference in `prec` on `rows` put in the program's place (with
        `update` False, as a step that leaves its state unchanged)."""
        w = weights.make(self.cfg, self.seed, self.device)
        if ref is None:
            ref = steps.train_steps(self.cfg, w, self.batches())
        side = (self.program_readings(w) if program_side
                else steps.train_steps(self.cfg, w, self.batches(), prec, rows, update))
        self.look = steps.train_look(side, ref)
        return steps.train_numbers(side, ref), ref
