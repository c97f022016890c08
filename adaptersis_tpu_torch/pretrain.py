"""DINOv2 SSL pretraining: the counterpart of the JAX package's `pretrain.py`.

    python -m adaptersis_tpu_torch.pretrain --bf16 --output_dir out   # ViT-S/14, batch 32

The flag surface of `pretrain.py`, plus `--device` (default cuda; the run
exits when there is no card, `--device cpu` runs the plain paths) and
`--bf16` (the backbones under bf16 autocast with fp32 parameters and heads,
the configuration of `tools/bench_ssl_step.py`). The learning rate is
scaled by sqrt(batch/1024); five per-iteration schedules (lr with warm-up,
weight decay, teacher momentum, teacher temperature, last-layer lr frozen
for `--freeze_last_layer_epochs`); per iteration a batch of synthetic
frames from the resumable infinite sampler (through the threaded loader),
the multi-crop augmentation on the device from draws seeded by the
iteration, the seeded iBOT masks (seed·100000 + iteration) and one
`SSLMetaArch.train_step`; a NaN loss aborts. Each epoch prints one JSON
line: the mean losses, img/s over its steps after the first (host clock,
one synchronise per step on the loss) and the peak device memory.

With `--output_dir`, checkpoints are iteration-keyed (`PeriodicCheckpointer`):
`model_{it:07d}.pth` every `--saveckp_freq` epochs, the newest 3 kept, a
`last_checkpoint` tag, and `model_final.pth` at the last iteration; each
holds the student, the EMA teacher, both centres, Adam's moments and the
iteration. A run started again with the same flags resumes from the tag,
the sampler advanced by iteration × batch, step for step.
`ASN_PREEMPT_AT=n` stops the run after iteration n without saving (a
preemption, for tests). Without `--output_dir` nothing is saved.

Under `torchrun --nproc_per_node W` (or `srun`, one task per GPU) the run
is data-parallel over W ranks (`SSLMetaArch.shard`): each rank takes
`--batch_size_per_gpu` images a step from its slice of the sampler, and its
own rows of the crops' draws and of the masks made for the global batch;
the lr scales with the global batch. `--fsdp n` shards the student, the
teacher and Adam's moments over groups of n ranks (n must divide W). Rank 0
alone prints and saves; checkpoints hold whole tensors, so a run resumes at
any world size.

The JAX `pretrain.py` always trains on synthetic frames, whatever
`--data_path` says; the port exits on `--data_path` instead.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .data.augment import draws_to, rank_rows
from .data.loader import DataLoader
from .data.samplers import ShardedInfiniteSampler
from .data.synthetic import SyntheticSeg
from .models.layers import TRAINED
from .models.vit import build_backbone
from .ssl.augment import apply_multicrop, draw_multicrop
from .parallel.dist import get_rank, get_world_size, init_distributed, print_on_main_only
from .parallel.mesh import get_mesh
from .ssl.masking import MaskingGenerator, collate_masks_with_indices, rank_masks
from .ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to, schedule_values
from .train.checkpoint import PeriodicCheckpointer, restore_checkpoint
from .train.schedules import cosine_scheduler


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "adaptersis-torch-pretrain",
        epilog="The run trains on synthetic frames, as the JAX pretrain.py does whatever its "
               "--data_path says.")
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=14, type=int)
    p.add_argument("--global_crops_size", default=224, type=int)
    p.add_argument("--local_crops_size", default=98, type=int)
    p.add_argument("--local_crops_number", default=8, type=int)
    p.add_argument("--batch_size_per_gpu", default=32, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--lr", default=4e-3, type=float)
    p.add_argument("--weight_decay", default=0.04, type=float)
    p.add_argument("--weight_decay_end", default=0.4, type=float)
    p.add_argument("--teacher_temp", default=0.07, type=float)
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=30, type=int)
    p.add_argument("--momentum_teacher", default=0.992, type=float)
    p.add_argument("--freeze_last_layer_epochs", default=1, type=int)
    p.add_argument("--dino_out_dim", default=65536, type=int)
    p.add_argument("--koleo_loss_weight", default=0.1, type=float)
    p.add_argument("--data_path", default="", type=str,
                   help="an image folder: the JAX pretrain.py ignores it and trains on "
                        "synthetic frames; the port exits when it is given")
    p.add_argument("--output_dir", default=None, type=str,
                   help="checkpoint directory, resumed from when it holds a checkpoint "
                        "(default: save nothing)")
    p.add_argument("--saveckp_freq", default=20, type=int, help="epochs between checkpoints")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic frames (what the run trains on in any case)")
    p.add_argument("--fsdp", default=1, type=int,
                   help="shard the student, the teacher and Adam's moments over groups of this "
                        "many ranks (FSDP2); it must divide the world size")
    p.add_argument("--official_epoch_length", default=1250, type=int,
                   help="iterations per epoch (schedules are iteration-keyed)")
    p.add_argument("--scaling_rule", default="sqrt_wrt_1024", choices=["sqrt_wrt_1024", "none"],
                   help="lr *= sqrt(global_batch/1024)")
    p.add_argument("--steps_per_epoch", default=0, type=int,
                   help="override official_epoch_length (smoke tests)")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--dist_url", default="env://", type=str,
                   help="the rendezvous of several ranks, as train_seg's")
    p.add_argument("--local-rank", "--local_rank", default=0, type=int, dest="local_rank")
    p.add_argument("--bf16", action="store_true",
                   help="backbones under bf16 autocast (fp32 parameters and heads)")
    return p


def setup(args) -> torch.device:
    """This rank's device, the process group joined when there are several."""
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    device = init_distributed(args.dist_url, args.device, args.local_rank)
    if args.fsdp < 1 or get_world_size() % args.fsdp:
        sys.exit(f"error: --fsdp {args.fsdp} does not divide the world size {get_world_size()}")
    print_on_main_only()
    if args.data_path:
        sys.exit("error: --data_path: image folders are not ported; the JAX pretrain.py "
                 "trains on synthetic frames whatever it says, so use --synthetic")
    for size in (args.global_crops_size, args.local_crops_size):
        if size % args.patch_size:
            sys.exit(f"error: crop size {size} is not divisible by --patch_size "
                     f"{args.patch_size}")
    return device


def build_arch(args) -> SSLMetaArch:
    """The student (seeded with args.seed) and its teacher copy, on the CPU."""
    torch.manual_seed(args.seed)
    attn_impl, ln_impl, qkv_impl, mlp_impl = TRAINED
    backbone = build_backbone(args.arch, img_size=args.global_crops_size,
                              patch_size=args.patch_size, attn_impl=attn_impl, ln_impl=ln_impl,
                              qkv_impl=qkv_impl, mlp_impl=mlp_impl)
    cfg = SSLConfig(dino_out_dim=args.dino_out_dim, ibot_out_dim=args.dino_out_dim,
                    n_local_crops=args.local_crops_number,
                    koleo_loss_weight=args.koleo_loss_weight)
    return SSLMetaArch(backbone, cfg, bf16=args.bf16)


def make_schedules(args, niter_per_ep: int) -> dict:
    total = args.epochs * niter_per_ep
    warm_tt = min(args.warmup_teacher_temp_epochs, args.epochs) * niter_per_ep
    return {
        "lr": cosine_scheduler(args.lr, 1e-6, args.epochs, niter_per_ep,
                               warmup_epochs=args.warmup_epochs),
        "wd": cosine_scheduler(args.weight_decay, args.weight_decay_end, args.epochs,
                               niter_per_ep),
        "momentum": cosine_scheduler(args.momentum_teacher, 1.0, args.epochs, niter_per_ep),
        "teacher_temp": np.concatenate([
            np.linspace(args.warmup_teacher_temp, args.teacher_temp, warm_tt),
            np.full(max(total - warm_tt, 0), args.teacher_temp)]),
        "last_layer_lr": cosine_scheduler(
            args.lr, 1e-6, args.epochs, niter_per_ep, warmup_epochs=args.warmup_epochs,
            freeze_iters=args.freeze_last_layer_epochs * niter_per_ep),
    }


def run(args) -> Tuple[SSLMetaArch, List[dict]]:
    """Train as the flags say; returns the trained meta-architecture and the
    per-epoch stats."""
    device = setup(args)
    rank, W = get_rank(), get_world_size()
    B = args.batch_size_per_gpu
    global_batch = B * W
    if args.scaling_rule == "sqrt_wrt_1024":
        base_lr = args.lr
        args.lr = base_lr * math.sqrt(global_batch / 1024.0)
        print(f"sqrt scaling learning rate; base: {base_lr}, new: {args.lr}", flush=True)
    arch = build_arch(args).to(device).shard(get_mesh(args.fsdp, device.type))

    ds = SyntheticSeg(n=max(global_batch * 4, 64), imsize=args.global_crops_size + 32,
                      seed=args.seed)
    niter_per_ep = args.steps_per_epoch or args.official_epoch_length
    total = args.epochs * niter_per_ep
    schedules = make_schedules(args, niter_per_ep)
    grid = args.global_crops_size // args.patch_size
    n_tokens = grid * grid
    mask_gen = MaskingGenerator((grid, grid), num_masking_patches=n_tokens // 2)

    it, periodic = 0, None
    if args.output_dir is not None:
        periodic = PeriodicCheckpointer(args.output_dir, period=args.saveckp_freq * niter_per_ep,
                                        max_iter=total, max_to_keep=3)
        last = periodic.last_name()
        if last:
            state = restore_checkpoint(args.output_dir, last, map_location=device)
            arch.load_checkpoint_state(state)
            it = int(state["iteration"])
            print(f"resumed from {last} at iteration {it}", flush=True)
    # every draw is keyed by the iteration, so a resumed run repeats them
    sampler = ShardedInfiniteSampler(len(ds), seed=args.seed, rank=rank, world_size=W,
                                     advance=it * B)
    batches = iter(DataLoader(ds, sampler=sampler, batch_size=B, num_workers=4))
    gen = torch.Generator()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    history, sums, steps, t_first = [], {}, 0, None
    preempt_at = int(os.environ.get("ASN_PREEMPT_AT", "0"))
    while it < total:
        imgs = torch.from_numpy(next(batches)[0]).to(device)
        gen.manual_seed(args.seed * 1_000_003 + it)
        draws = rank_rows(draw_multicrop(gen, global_batch, args.local_crops_number))
        g, l = apply_multicrop(imgs, draws_to(draws, device), args.global_crops_size,
                               args.local_crops_size)
        masks = rank_masks(collate_masks_with_indices(2 * global_batch, n_tokens, mask_gen,
                                                      seed=args.seed * 100000 + it),
                           n_tokens, rank, W)
        metrics = arch.train_step(g, l, masks_to(masks, device),
                                  **schedule_values(schedules, min(it, total - 1)))
        values = {k: float(v) for k, v in metrics.items()}     # waits for the step
        if math.isnan(values["total_loss"]):
            raise RuntimeError(f"NaN loss at iteration {it}")
        for k, v in values.items():
            sums[k] = sums.get(k, 0.0) + v
        it += 1
        steps += 1
        if t_first is None:
            t_first = time.perf_counter()
        if it % niter_per_ep == 0:
            seconds = time.perf_counter() - t_first
            stats = {"epoch": it // niter_per_ep - 1, "steps": steps,
                     **{k: v / steps for k, v in sums.items()},
                     "img_per_s": (global_batch * (steps - 1) / seconds if steps > 1 else None),
                     "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                                        if device.type == "cuda" else None),
                     "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                else "cpu")}
            print(json.dumps(stats), flush=True)
            history.append(stats)
            sums, steps, t_first = {}, 0, None
        # after the epoch's line: its img/s leaves the save out
        if periodic is not None and (it % periodic.period == 0 or it >= total):
            periodic.step(it - 1, {**arch.checkpoint_state(), "iteration": it})
        if preempt_at and it >= preempt_at and it < total:
            # a preemption after this iteration, saving nothing: the run
            # started again resumes from the last periodic checkpoint
            print(f"preempted at iteration {it}", flush=True)
            break
    return arch, history


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(get_args_parser().parse_args(argv))[1]


if __name__ == "__main__":
    main()
