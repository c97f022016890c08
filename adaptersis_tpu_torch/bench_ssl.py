"""Train-step throughput of the DINOv2 SSL pretraining: the counterpart of
the JAX package's `tools/bench_ssl_step.py` (and, with `--profile`, of
`tools/profile_ssl_step.py`).

    python -m adaptersis_tpu_torch.bench_ssl        # ViT-S/14, batch 32, bf16

The full `SSLMetaArch.train_step` at the reference pretraining defaults:
global crops 224, 8 local crops of 98 packed with them into one attention
call per block (K7, segment ids), the EMA teacher over the global crops,
DINO + iBOT (on the gathered masked tokens) + KoLeo with 65536 prototypes,
AdamW, the teacher and centre updates; the backbones in bf16 autocast with
fp32 parameters and heads. Weights from seed 0; one batch of random frames
(`np.random.default_rng(0)`), its multi-crop augmentation (draws from seed
1) and its masks (seed 7), all made once and kept on the device. 2 warm-up
steps, then `--repeats` windows of `--steps` steps, each ending in a
synchronise on the loss; the median window is reported. img/s counts
source images, each giving 2 global and 8 local crops. Under `torchrun
--nproc_per_node W` every rank steps on `--batch` images, its rows of a
global batch of W·`--batch` (images, draws and masks from the same seeds),
the student and teacher under FSDP2 on a (W, 1) mesh.

Prints one JSON line: metric, value (img/s), unit, ms_step, batch, spread
(the slowest and fastest window), mfu (`utils/flops.py:ssl_step_flops` over
the card's dense bf16 peak; null off the card), peak_mem_gib (null off the
card), the device's name, the world size, the global img/s (`value` is per
GPU) and the last loss; rank 0 alone prints. `--profile` then traces 3 more
steps with torch.profiler and prints the device's activities by name and
the idle share.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from .bench import device_name, peak_bf16_flops, setup, timed_windows
from .data.augment import draws_to, rank_rows
from .models.layers import TRAINED
from .models.vit import build_backbone
from .ssl.augment import apply_multicrop, draw_multicrop
from .parallel.dist import get_rank, get_world_size
from .parallel.mesh import get_mesh
from .ssl.masking import MaskingGenerator, collate_masks_with_indices, rank_masks
from .ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to, schedule_values
from .train.schedules import cosine_scheduler
from .train_seg import profiled_steps
from .utils.flops import ssl_step_flops

PATCH = 14


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-bench-ssl")
    p.add_argument("--arch", default="vit_small", type=str)
    p.add_argument("--batch", default=32, type=int, help="source images per step")
    p.add_argument("--global_size", default=224, type=int)
    p.add_argument("--local_size", default=98, type=int)
    p.add_argument("--n_local", default=8, type=int)
    p.add_argument("--out_dim", default=65536, type=int, help="DINO and iBOT prototypes")
    p.add_argument("--steps", default=10, type=int, help="steps per timed window")
    p.add_argument("--repeats", default=3, type=int, help="timed windows")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--profile", action="store_true",
                   help="then trace 3 steps with torch.profiler and print the table")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    args.imsize = args.global_size
    device = setup(args)
    B, G = args.batch, args.global_size
    attn_impl, ln_impl, qkv_impl, mlp_impl = TRAINED
    torch.manual_seed(0)
    backbone = build_backbone(args.arch, img_size=G, patch_size=PATCH, attn_impl=attn_impl,
                              ln_impl=ln_impl, qkv_impl=qkv_impl, mlp_impl=mlp_impl)
    cfg = SSLConfig(dino_out_dim=args.out_dim, ibot_out_dim=args.out_dim,
                    n_local_crops=args.n_local)
    W, rank = get_world_size(), get_rank()
    arch = SSLMetaArch(backbone, cfg, bf16=True).to(device).shard(get_mesh(1, device.type))
    schedules = {   # the shapes of pretrain's; the values do not change the work
        "lr": cosine_scheduler(1e-3, 1e-6, 1, 1000),
        "wd": cosine_scheduler(0.04, 0.4, 1, 1000),
        "momentum": cosine_scheduler(0.992, 1.0, 1, 1000),
        "teacher_temp": np.full(1000, 0.07),
        "last_layer_lr": cosine_scheduler(1e-3, 1e-6, 1, 1000),
    }
    imgs = np.random.default_rng(0).integers(0, 256, (B * W, G + 32, G + 32, 3), np.uint8)
    imgs = torch.from_numpy(imgs[rank::W]).to(device)
    draws = draw_multicrop(torch.Generator().manual_seed(1), B * W, args.n_local)
    g, l = apply_multicrop(imgs, draws_to(rank_rows(draws), device), G, args.local_size)
    grid = G // PATCH
    info = rank_masks(collate_masks_with_indices(2 * B * W, grid * grid,
                                                 MaskingGenerator((grid, grid),
                                                                  num_masking_patches=grid * grid
                                                                  // 2),
                                                 seed=7), grid * grid, rank, W)
    masks = masks_to(info, device)
    losses, it = [], [0]

    def step() -> torch.Tensor:
        out = arch.train_step(g, l, masks, **schedule_values(schedules, it[0] % 1000))
        it[0] += 1
        losses.append(out["total_loss"])
        return losses[-1]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rates = timed_windows(step, args)
    value = sorted(rates)[len(rates) // 2]
    mfu = peak_mem = None
    if device.type == "cuda":
        flops = ssl_step_flops(B, backbone.embed_dim, backbone.depth, int(info.indices.shape[0]),
                               G, args.local_size, args.n_local, PATCH, args.out_dim)
        mfu = flops * (value / B) / peak_bf16_flops(device_name(device))
        peak_mem = torch.cuda.max_memory_allocated(device) / 2 ** 30
    result = {"metric": f"{args.arch}_dino_ibot_multicrop_train_images_per_sec_per_gpu",
              "value": value, "unit": "img/s/gpu", "ms_step": 1000.0 * B / value, "batch": B,
              "spread": [min(rates), max(rates)], "mfu": mfu, "peak_mem_gib": peak_mem,
              "device": device_name(device), "world_size": W, "global_img_per_s": value * W,
              "loss": float(losses[-1])}
    print(json.dumps(result), flush=True)
    if args.profile:
        print(profiled_steps(step, device), flush=True)
    return result


if __name__ == "__main__":
    main()
