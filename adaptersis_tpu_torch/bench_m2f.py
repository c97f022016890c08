"""Train-step throughput of the ViT-Adapter + Mask2Former stack: the
counterpart of the JAX package's `tools/bench_m2f_step.py`, its
configuration as flags.

    python -m adaptersis_tpu_torch.bench_m2f        # ViT-L/14 @ 518 px, batch 4

`segment_m2f`'s train step (`M2FTrainer`): a frozen DINOv2 backbone (`--arch`,
img_size 518, patch 14, tanh GELU, stored in bf16: the deployed walk, K3,
K4 and K5), ViTAdapter and the Mask2Former head (100 queries, 9 decoder
layers; their deformable attention K1 and K2) under bf16 autocast with
fp32 parameters, the Hungarian-matched loss, AdamW(1e-4, weight decay
0.05). One fixed batch drawn from `np.random.default_rng(0)`, staged on
the device; weights from seed 0. 2 warm-up steps, then `--repeats`
windows of `--steps` steps, each ending in a synchronise on the loss; the
median window is reported.

Prints one JSON line with the JAX tool's keys (metric, value in img/s,
unit, ms_step, batch, spread: the slowest and fastest window, msda_impl)
and the device's name, the peak memory and the last loss. No MFU: the
JAX tool computes none.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from .bench import PATCH, device_name, setup, timed_windows
from .segment_m2f import M2FTrainer, build_model

NUM_CLASSES = 2


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-bench-m2f")
    p.add_argument("--arch", default="vit_large", type=str)
    p.add_argument("--imsize", default=518, type=int)
    p.add_argument("--batch", default=4, type=int)
    p.add_argument("--steps", default=5, type=int, help="steps per timed window")
    p.add_argument("--repeats", default=3, type=int, help="timed windows")
    p.add_argument("--device", default="cuda", type=str)
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    device = setup(args)
    B, S = args.batch, args.imsize
    model_args = argparse.Namespace(
        arch=args.arch, patch_size=PATCH, num_classes=NUM_CLASSES, num_queries=100,
        feat_channels=256, num_decoder_layers=9, seed=0, pretrained_weights="")
    trainer = M2FTrainer(build_model(model_args, gelu_approx=True).to(device), NUM_CLASSES,
                         lr=1e-4, weight_decay=0.05, bf16=True)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), np.uint8)).to(device)
    masks = torch.from_numpy((rng.uniform(size=(B, S, S)) > 0.8).astype(np.int32)).to(device)
    gen = torch.Generator(device).manual_seed(1)
    losses = []

    def step() -> torch.Tensor:
        losses.append(trainer.step(imgs, masks, trainer.draws(gen, B))[0])
        return losses[-1]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rates = timed_windows(step, args)
    value = sorted(rates)[len(rates) // 2]
    result = {"metric": f"{args.arch}_{S}_vitadapter_m2f_train_images_per_sec_per_gpu",
              "value": value, "unit": "img/s/gpu", "ms_step": 1000 * B / value, "batch": B,
              "spread": [min(rates), max(rates)],
              "msda_impl": "cuda" if device.type == "cuda" else "plain",
              "device": device_name(device),
              "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                               if device.type == "cuda" else None),
              "loss": float(losses[-1])}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
