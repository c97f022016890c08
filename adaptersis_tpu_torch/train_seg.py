"""Train an AdapterSegmentor on the GPU: the port's counterpart of `train.py`
for `--model adapter --decoder feature`.

    python -m adaptersis_tpu_torch.train_seg --arch vit_large --patch_size 14 \\
        --imsize 588 --batch_size_per_gpu 16 --epochs 1 --bf16 --gelu_approx \\
        --synthetic --seed 0 --output_dir out

Each epoch trains on the sampler's order with on-device augmentation, then
validates every `--val_freq` epochs (and after the last), appends one JSON
line of stats to `<output_dir>/log.txt`, prints it, and writes the model's
variables as `<output_dir>/variables.npz` (flax paths, the file `evaluate
--flax_variables` and the JAX package read). `--profile` writes a
torch.profiler table of the first epoch's steps after its first to
`<output_dir>/profile.txt`.

Not ported yet (ROADMAP.md, item M8): checkpoints and resume, real datasets
(`--synthetic` is required), and the other models and decoders.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .data.augment import draw_train_augment, draws_to
from .data.samplers import EpochSampler
from .data.synthetic import SyntheticSeg
from .evaluate import build_model
from .train.convert import save_flax_variables
from .train.trainer import Trainer


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-train")
    p.add_argument("--arch", default="vit_small", type=str)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--imsize", default=224, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--batch_size_per_gpu", default=16, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--gelu_approx", action="store_true", help="tanh GELU in the backbone MLPs")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (required: real datasets are not ported)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--no_clahe", action="store_true")
    p.add_argument("--val_freq", default=1, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler table of epoch 0 to <output_dir>/profile.txt")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--flax_variables", default="", type=str,
                   help=".npz of flax variables (keys 'params/...', 'batch_stats/...')")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dataset(ds: SyntheticSeg, device: torch.device):
    """The whole synthetic set on the device, made once (set-up, not step time)."""
    imgs, masks = zip(*((a, m) for a, m, _ in (ds[i] for i in range(len(ds)))))
    return (torch.from_numpy(np.stack(imgs)).to(device),
            torch.from_numpy(np.stack(masks)).to(device))


def _validate(trainer: Trainer, ds: SyntheticSeg, batch: int, device: torch.device) -> dict:
    sums = {"loss": 0.0, "dice": 0.0, "acc1": 0.0}
    n_images = 0
    for imgs, masks in ds.batches(batch):
        out = trainer.eval_step(torch.from_numpy(imgs).to(device),
                                torch.from_numpy(masks).to(device))
        n = imgs.shape[0]
        n_images += n
        for k in sums:
            sums[k] += float(out[k]) * n
    return {k: v / n_images for k, v in sums.items()}


def profile_table(prof, device: torch.device, steps: int, seconds: float) -> str:
    """The device's activities (kernels, copies, memsets) summed by name per
    step, their total against the window's host time (the idle share), then
    torch's own table of operators."""
    lines = [f"torch.profiler over {steps} train steps on {device}, {seconds:.6f} s of host "
             "time (the profiler's own cost included)"]
    sort = "self_cpu_time_total"
    if device.type == "cuda":
        sort = "self_cuda_time_total"
        total, calls = defaultdict(float), defaultdict(int)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        busy = sum(total.values()) / 1e3
        lines.append(f"device activity {busy:.6f} s = {busy / steps * 1e3:.3f} ms per step; "
                     f"idle share {1.0 - busy / seconds:.4f}")
        lines += [f"{ms / steps:10.3f} ms/step {ms / sum(total.values()):7.2%} "
                  f"{calls[name]:6d} calls  {name[:110]}"
                  for name, ms in sorted(total.items(), key=lambda kv: -kv[1])[:40]]
    lines.append(prof.key_averages().table(sort_by=sort, row_limit=40))
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = get_args_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    if args.imsize % args.patch_size:
        sys.exit(f"error: --imsize {args.imsize} must be divisible by --patch_size "
                 f"{args.patch_size}")
    if not args.synthetic:
        sys.exit("error: real datasets are not ported yet (ROADMAP.md, item M8); "
                 "pass --synthetic")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    B = args.batch_size_per_gpu

    trainer = Trainer(build_model(args).to(device), lr=args.lr, epochs=args.epochs,
                      bf16=args.bf16)
    ds_train = SyntheticSeg(n=8 * B, imsize=args.imsize, num_classes=args.num_classes,
                            seed=args.seed)
    ds_val = SyntheticSeg(n=2 * B, imsize=args.imsize, num_classes=args.num_classes,
                          seed=args.seed + 1)
    train_imgs, train_masks = _dataset(ds_train, device)
    sampler = EpochSampler(len(ds_train), shuffle=True, seed=args.seed)
    generator = torch.Generator()
    history = []
    for epoch in range(args.epochs):
        # per-epoch draws seeded from (seed, epoch), as the JAX trainer folds
        # the epoch into its key: a resumed epoch repeats its augmentations
        generator.manual_seed(args.seed + 1234 + epoch)
        sampler.set_epoch(epoch)
        order = torch.tensor(list(sampler), dtype=torch.long).to(device, non_blocking=True)
        n_steps = len(order) // B
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses, t_start = [], None
        prof = None
        for step in range(n_steps):
            if step == 1:
                _sync(device)
                t_start = time.perf_counter()
                if args.profile and epoch == 0:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.start()
            idx = order[step * B:(step + 1) * B]
            draws = draws_to(draw_train_augment(generator, B, args.imsize,
                                                use_clahe=not args.no_clahe), device)
            losses.append(trainer.train_step(train_imgs[idx], train_masks[idx], draws, epoch))
        _sync(device)
        t_end = time.perf_counter()
        if prof is not None:
            prof.stop()
            (out_dir / "profile.txt").write_text(
                profile_table(prof, device, n_steps - 1, t_end - t_start))
        step_losses = torch.stack(losses).tolist()
        stats = {"train_loss": sum(step_losses) / len(step_losses),
                 "train_lr": trainer.lr_fn(epoch), "epoch": epoch,
                 "train_img_per_s": ((n_steps - 1) * B / (t_end - t_start)
                                     if t_start is not None else None),
                 "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None),
                 "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu")}
        if epoch % args.val_freq == 0 or epoch == args.epochs - 1:
            stats.update({f"test_{k}": v for k, v in
                          _validate(trainer, ds_val, B, device).items()})
        with (out_dir / "log.txt").open("a") as f:
            f.write(json.dumps(stats) + "\n")
        print(json.dumps(stats), flush=True)
        save_flax_variables(out_dir / "variables.npz", trainer.model)
        history.append({**stats, "train_losses": step_losses,
                        "train_losses_finite": all(map(math.isfinite, step_losses))})
    return history


if __name__ == "__main__":
    main()
