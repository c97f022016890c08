"""Train-step throughput of the port's deployed configuration: the
counterpart of the JAX package's `bench.py`.

    python -m adaptersis_tpu_torch.bench          # ViT-L/14 @ 588 px, batch 16

The `Trainer` step of an AdapterSegmentor (frozen DINOv2 backbone at
img_size 518, patch 14, tanh GELU; bf16 compute; on-device augmentation with
CLAHE; softmax → DC loss; SGD) on one fixed batch drawn from
`np.random.default_rng(0)` and staged on the device before timing. The
frozen walks run the kernels K3 (attention), K4 (LN → qkv), K5 (LN → MLP)
and K6 (the final LayerNorm); the adapters K1 and K2 (deformable attention).
Weights and augmentation draws come from seed 0, as in the JAX bench. 2
warm-up steps, then `--repeats` windows of `--steps` steps, each ending in a
synchronise on the loss; the median window is reported. Under `torchrun
--nproc_per_node W` every rank steps on `--batch` images, its rows of a
global batch of W·`--batch` drawn from the same seeds, with the gradients
all-reduced (the JAX bench's `BATCH * n_chips`).

Prints one JSON line: metric, value (img/s), unit, spread (the slowest and
fastest window), mfu (analytic FLOPs of the step, `utils/flops.py`, over the
card's dense bf16 peak; null off the card), peak_mem_gib (null off the
card), the device's name, the batch per rank, the world size, the global
img/s (`value` is per GPU) and the last loss; rank 0 alone prints.
`--profile` then traces 3 more steps of the same model and batch with
torch.profiler and prints the device's activities by name, the idle share
and torch's table of operators (`train_seg.profile_table`): the
counterpart of the JAX package's `tools/profile_step.py`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .data.augment import draw_train_augment, draws_to, rank_rows
from .models.segmentor import AdapterSegmentor
from .models.vit import build_backbone
from .train.convert import seeded_init_
from .parallel.dist import get_rank, get_world_size, init_distributed, print_on_main_only
from .parallel.mesh import get_mesh
from .train.trainer import Trainer
from .train_seg import profiled_steps
from .utils.flops import train_step_flops

PATCH = 14
# dense bf16 tensor-core peaks by torch.cuda.get_device_name (NVIDIA's data
# sheet: H100 SXM, at its 700 W limit)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def get_args_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog)
    p.add_argument("--arch", default="vit_large", type=str)
    p.add_argument("--imsize", default=588, type=int)
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--steps", default=10, type=int, help="steps per timed window")
    p.add_argument("--repeats", default=3, type=int, help="timed windows")
    p.add_argument("--device", default="cuda", type=str)
    return p


def setup(args) -> torch.device:
    """This rank's device, the process group joined under torchrun."""
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    if args.imsize % PATCH:
        sys.exit(f"error: --imsize {args.imsize} must be divisible by the patch size {PATCH}")
    device = init_distributed("env://", args.device)
    print_on_main_only()
    return device


def build_model(args) -> AdapterSegmentor:
    backbone = build_backbone(args.arch, img_size=518, patch_size=PATCH, gelu_approx=True)
    return seeded_init_(AdapterSegmentor(backbone, num_classes=2, n_last_blocks=4), seed=0)


def timed_windows(step: Callable[[], torch.Tensor], args) -> List[float]:
    """img/s of each window of `args.steps` steps after 2 warm-up steps;
    `step` returns a device tensor whose read synchronises the window."""
    for _ in range(2):
        step().item()
    rates = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = step()
        out.item()
        rates.append(args.batch * args.steps / (time.perf_counter() - t0))
    return rates


def peak_bf16_flops(name: str) -> float:
    """The card's dense bf16 peak; an unknown card raises rather than guess."""
    if name not in PEAK_BF16_FLOPS:
        raise ValueError(f"no known dense bf16 peak for {name!r}: add it to PEAK_BF16_FLOPS")
    return PEAK_BF16_FLOPS[name]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv: Optional[List[str]] = None) -> dict:
    p = get_args_parser("adaptersis-torch-bench")
    p.add_argument("--profile", action="store_true",
                   help="then trace 3 steps with torch.profiler and print the table")
    args = p.parse_args(argv)
    device = setup(args)
    B, S = args.batch, args.imsize
    model = build_model(args)
    E, depth = model.backbone.embed_dim, model.backbone.depth
    W, mine = get_world_size(), slice(get_rank(), None, get_world_size())
    trainer = Trainer(model.to(device), bf16=True, mesh=get_mesh(1, device.type))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (B * W, S, S, 3), np.uint8)[mine]).to(device)
    masks = torch.from_numpy(
        (rng.uniform(size=(B * W, S, S)) > 0.8).astype(np.int32)[mine]).to(device)
    gen = torch.Generator().manual_seed(0)
    losses = []

    def step() -> torch.Tensor:
        draws = draws_to(rank_rows(draw_train_augment(gen, B * W, S, use_clahe=True)), device)
        losses.append(trainer.train_step(imgs, masks, draws, epoch=0))
        return losses[-1]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rates = timed_windows(step, args)
    value = sorted(rates)[len(rates) // 2]
    mfu = peak_mem = None
    if device.type == "cuda":
        flops = train_step_flops(B, S, PATCH, embed_dim=E, depth=depth)
        mfu = flops * (value / B) / peak_bf16_flops(device_name(device))
        peak_mem = torch.cuda.max_memory_allocated(device) / 2 ** 30
    result = {"metric": "vitl14_588_adapter_train_images_per_sec_per_gpu", "value": value,
              "unit": "img/s/gpu", "spread": [min(rates), max(rates)], "mfu": mfu,
              "peak_mem_gib": peak_mem, "device": device_name(device), "batch": B,
              "world_size": W, "global_img_per_s": value * W, "loss": float(losses[-1])}
    print(json.dumps(result), flush=True)
    if args.profile:
        print(profiled_steps(step, device), flush=True)
    return result


if __name__ == "__main__":
    main()
