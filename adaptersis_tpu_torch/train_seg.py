"""Train a segmentor on the GPU: the port's counterpart of `train.py`, with
`train.py`'s flags: the adapter model (`--model adapter`) with any
`--decoder` (feature, mla, setr), or one of the eval scripts' models
(`--model tap_setr|tap_unet|tap_unet_fuse|tap_masktrans|tap_setr_ete`), with
any `--loss` of the registry.

    python -m adaptersis_tpu_torch.train_seg --arch vit_large --patch_size 14 \\
        --imsize 588 --batch_size_per_gpu 16 --epochs 500 --bf16 --gelu_approx \\
        --dataset robomis --data_path /data/robomis \\
        --pretrained_weights dinov2_vitl14_pretrain.pth --output_dir out

The backbone is a DINOv2 `.pth` (`--pretrained_weights`, `--checkpoint_key`)
or a seeded draw; the data one of the five endoscopy datasets under
`--data_path` (`--dataset`) or synthetic frames (`--synthetic`), read by
`--num_workers` threads with a prefetch and copied to the card through
pinned memory. Each epoch trains on the sampler's order with on-device
augmentation, validates every `--val_freq` epochs (and after the last; with
`--cross_test_path` also on that root's validation split, as `cross_*`),
appends one JSON line of stats to `<output_dir>/log.txt`, prints it with the
epoch's img/s, loader wait and peak memory, and saves
`<output_dir>/checkpoint.pth`: the trainables, the BatchNorm statistics, the
SGD momentum, the next epoch and the best acc1. A run started again with the
same flags and `--output_dir` resumes from it, step for step, and
`--evaluate` validates it. A frozen backbone is not in the checkpoint: it
comes from the same `--pretrained_weights` (or seed) again; `tap_setr_ete`'s
trained one is. After the last
epoch the model's variables are written as `<output_dir>/variables.npz` (flax
paths, the file `evaluate --flax_variables` and the JAX package read).
`--profile` writes a torch.profiler table of the first epoch's steps after
its first to `<output_dir>/profile.txt`. `ASN_STOP_AFTER_EPOCHS=n` stops the
run after n epochs, once their checkpoint is saved (a preemption, for tests).

Per model, as the JAX trainer: the eval-script models train on their raw
logits, with their script's loss where `--loss` is left at "dc" (CE + DC;
the mask transformer's weighted CE + argmax dice) and the mask transformer
on ImageNet-normalised inputs. The port trains on one card: `--fsdp` above
1 (ROADMAP.md, M10) exits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .data.augment import draw_train_augment, draws_to
from .data.datasets import DATASETS
from .data.loader import DataLoader
from .data.samplers import EpochSampler
from .data.synthetic import SyntheticSeg
from .evaluate import DECODERS, MODELS, build_model, data_decoder, input_norm, model_loss
from .evaluate import validation_set
from .losses import get_loss
from .train.checkpoint import restore_checkpoint, save_checkpoint
from .train.convert import save_flax_variables
from .train.trainer import Trainer

# the JAX package's choices, accepted; the port's kernels are fixed
ATTN_IMPLS = ["einsum", "flash", "flash_fwd"]
MSDA_IMPLS = ["gather", "matmul", "pallas"]


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-train")
    # the reference's flags (train.py's first group)
    p.add_argument("--n_last_blocks", default=4, type=int,
                   help="the backbone blocks whose outputs the adapters read")
    p.add_argument("--avgpool_patchtokens", default=False, type=bool,
                   help="the reference's flag, accepted and not acted on")
    p.add_argument("--arch", default="vit_small", type=str)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--imsize", default=224, type=int)
    p.add_argument("--pretrained_weights", default="", type=str,
                   help="a DINOv2 .pth checkpoint for the frozen backbone")
    p.add_argument("--checkpoint_key", default="teacher", type=str,
                   help="the .pth's sub-dict holding the backbone, if it has one")
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--batch_size_per_gpu", default=16, type=int)
    p.add_argument("--dist_url", default="env://", type=str,
                   help="the reference's flag, accepted and not acted on: the port trains on "
                        "one card")
    p.add_argument("--local-rank", "--local_rank", default=0, type=int, dest="local_rank",
                   help="the reference's flag, accepted and not acted on")
    p.add_argument("--data_path", default="/path/to/imagenet/", type=str,
                   help="the dataset's root")
    p.add_argument("--num_workers", default=10, type=int,
                   help="threads decoding the images (with a prefetch of 2 batches)")
    p.add_argument("--val_freq", default=1, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--num_labels", default=1000, type=int,
                   help="the reference's flag, accepted and not acted on (--num_classes sets "
                        "the classes)")
    p.add_argument("--evaluate", dest="evaluate", action="store_true",
                   help="validate <output_dir>'s checkpoint and stop")
    p.add_argument("--config_file", default="", type=str,
                   help="a DINOv2 YAML whose student.arch and student.patch_size override "
                        "--arch and --patch_size")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER,
                   help="key=value overrides of the YAML (e.g. student.arch=vit_large)")
    # the JAX trainer's flags
    p.add_argument("--model", default="adapter", choices=MODELS,
                   help="adapter = the paper's model; tap_* = the reference eval scripts' "
                        "models (frozen taps and a head; tap_setr_ete trains the backbone)")
    p.add_argument("--decoder", default="feature", choices=DECODERS,
                   help="the adapter model's decoder")
    p.add_argument("--dataset", default="robomis", choices=list(DATASETS))
    p.add_argument("--loss", default="dc", type=str,
                   help="a name of the loss registry (losses.LOSSES); with a tap_* model "
                        "'dc' means the script's own loss")
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--no_clahe", action="store_true")
    p.add_argument("--fsdp", default=1, type=int,
                   help="sharding of the frozen backbone: only 1 is ported (ROADMAP.md, M10)")
    p.add_argument("--parity_frozen_head", action="store_true",
                   help="reproduce the reference's accidental decoder-only training: the "
                        "decoder input is detached; the adapters and encoder still take "
                        "weight decay and momentum")
    p.add_argument("--platform", default=None, type=str,
                   help="the JAX package's platform choice, not acted on: --device picks the "
                        "device")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler table of epoch 0 to <output_dir>/profile.txt")
    p.add_argument("--cross_test_path", default="", type=str,
                   help="a second dataset root whose validation split is evaluated too "
                        "(cross_* stats)")
    p.add_argument("--attn_impl", default="einsum", choices=ATTN_IMPLS,
                   help="the JAX package's attention choice, not acted on: the frozen walks "
                        "run the port's attention kernel (K3) on the card")
    p.add_argument("--gelu_approx", action="store_true", help="tanh GELU in the backbone MLPs")
    p.add_argument("--msda_impl", default="gather", choices=MSDA_IMPLS,
                   help="the JAX package's deformable-attention choice, not acted on: the "
                        "port runs its MSDA kernels (K1, K2) on the card")
    # the port's own
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--flax_variables", default="", type=str,
                   help=".npz of flax variables (keys 'params/...', 'batch_stats/...')")
    return p


def _merge_dotlist(cfg: dict, opts) -> dict:
    """OmegaConf's dotlist merge: each `a.b.c=value` sets the nested key,
    the value parsed as a YAML scalar."""
    import yaml

    for item in opts or []:
        if "=" not in item:
            raise SystemExit(f"--opts entry {item!r} is not of the form key=value")
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise SystemExit(f"--opts key {key!r} clashes with a scalar")
        node[parts[-1]] = yaml.safe_load(raw)
    return cfg


def _arch_from_config(args) -> Tuple[str, int]:
    """(arch, patch size): `--config_file`'s student section with `--opts`
    merged over it wins over `--arch` and `--patch_size` (as in DINOv2's
    eval setup)."""
    if not args.config_file and not args.opts:
        return args.arch, args.patch_size
    import yaml

    cfg = {}
    if args.config_file:
        with open(args.config_file) as f:
            cfg = yaml.safe_load(f) or {}
    student = _merge_dotlist(cfg, args.opts).get("student", {})
    return student.get("arch", args.arch), student.get("patch_size", args.patch_size)


def check_args(args) -> None:
    """Exit on what the port does not do, naming ROADMAP.md's item, and on
    an unknown loss."""
    if args.fsdp != 1:
        sys.exit(f"error: --fsdp {args.fsdp}: sharding over several devices is not ported "
                 "yet (ROADMAP.md, M10: data parallelism)")
    get_loss(train_loss(args))


def train_loss(args) -> str:
    """The loss the run trains with: `--loss`, or the eval-script model's
    own where it is left at "dc"; a caller that sets `args.keep_loss`
    keeps `--loss` as it is (and one that sets `args.input_norm` overrides
    the model's input norm: `eval.eval_dinov2_masktrans_inov`)."""
    return args.loss if getattr(args, "keep_loss", False) else model_loss(args.model, args.loss)


class InMemory:
    """A dataset's items made once, in bulk (set-up), and held in host memory."""

    def __init__(self, dataset, num_workers: int = 4):
        with ThreadPoolExecutor(max(1, num_workers)) as pool:
            items = list(pool.map(dataset.__getitem__, range(len(dataset))))
        self.images = np.stack([it[0] for it in items])
        self.masks = np.stack([it[1] for it in items])

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int):
        return self.images[i], self.masks[i], i


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to(t, device: torch.device) -> torch.Tensor:
    """A batch array (or pinned tensor) on `device`, copied without a wait."""
    t = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    return t.to(device, non_blocking=True)


def validate(trainer: Trainer, loader: DataLoader, device: torch.device) -> dict:
    """The eval step's metrics over the loader, each averaged over images."""
    sums, n_images = {}, 0
    for imgs, masks, _ in loader:
        out = trainer.eval_step(_to(imgs, device), _to(masks, device))
        n = imgs.shape[0]
        n_images += n
        for k, v in out.items():
            if k not in ("preds", "logits"):
                sums[k] = sums.get(k, 0.0) + float(v) * n
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


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run(args) -> Tuple[Trainer, List[dict]]:
    """Train (or, with `--evaluate`, validate) as the flags say; returns the
    trainer and one stats dict per epoch run."""
    check_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    args.arch, args.patch_size = _arch_from_config(args)
    if args.imsize % args.patch_size:
        sys.exit(f"error: --imsize {args.imsize} must be divisible by --patch_size "
                 f"{args.patch_size}")
    decoder = data_decoder(args)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    B = args.batch_size_per_gpu

    trainer = Trainer(build_model(args).to(device), lr=args.lr, epochs=args.epochs,
                      bf16=args.bf16, loss=train_loss(args), softmax=args.model == "adapter",
                      input_norm=getattr(args, "input_norm", input_norm(args.model)))
    synthetic = args.synthetic or args.dataset == "synthetic"
    if synthetic:
        ds_train = InMemory(SyntheticSeg(n=8 * B, imsize=args.imsize,
                                         num_classes=args.num_classes, seed=args.seed),
                            args.num_workers)
        ds_val = InMemory(validation_set(args), args.num_workers)
    else:
        ds_train = DATASETS[args.dataset](args.data_path, split="training", imsize=args.imsize)
        ds_val = validation_set(args)
    pin = device.type == "cuda"
    sampler = EpochSampler(len(ds_train), shuffle=True, seed=args.seed)
    train_loader = DataLoader(ds_train, sampler=sampler, batch_size=B,
                              num_workers=args.num_workers, pin_memory=pin)
    val_loader = DataLoader(ds_val, batch_size=B, num_workers=args.num_workers,
                            drop_last=False, pin_memory=pin)
    cross_loader = None
    if args.cross_test_path:
        cross_loader = DataLoader(validation_set(args, root=args.cross_test_path), batch_size=B,
                                  num_workers=args.num_workers, drop_last=False, pin_memory=pin)
    if not len(train_loader) and not args.evaluate:
        sys.exit(f"error: {len(ds_train)} training images, fewer than a batch of {B}")
    print(f"Data loaded with {len(ds_train)} train and {len(ds_val)} val imgs "
          f"(decoder: {decoder}).", flush=True)

    restored = restore_checkpoint(out_dir, map_location=device)
    if restored is not None:
        trainer.load_state_dict(restored)
        print(f"resumed from epoch {trainer.epoch}", flush=True)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    if args.evaluate:
        stats = validate(trainer, val_loader, device)
        print(json.dumps({"epoch": trainer.epoch, **{f"test_{k}": v for k, v in stats.items()}}))
        print(f"Accuracy of the network on the {len(ds_val)} test images: "
              f"{stats['acc1'] * 100:.1f}%", flush=True)
        return trainer, [{"epoch": trainer.epoch, "decoder": decoder, "device": dev_name,
                          **{f"test_{k}": v for k, v in stats.items()}}]

    start_epoch = trainer.epoch
    generator = torch.Generator()
    history = []
    for epoch in range(start_epoch, args.epochs):
        # per-epoch draws seeded from (seed, epoch), as the JAX trainer folds
        # the epoch into its key: a resumed epoch repeats its augmentations
        generator.manual_seed(args.seed + 1234 + epoch)
        sampler.set_epoch(epoch)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses, t_start, waited, prof = [], None, 0.0, None
        batches = iter(train_loader)
        for step in range(len(train_loader)):
            if step == 1:
                _sync(device)
                t_start = time.perf_counter()
                if args.profile and epoch == start_epoch:
                    prof = _profiler(device)
                    prof.start()
            t0 = time.perf_counter()
            imgs, masks, _ = next(batches)
            if step:
                waited += time.perf_counter() - t0
            draws = draws_to(draw_train_augment(generator, B, args.imsize,
                                                use_clahe=not args.no_clahe), device)
            losses.append(trainer.train_step(_to(imgs, device), _to(masks, device), draws,
                                             epoch))
        _sync(device)
        t_end = time.perf_counter()
        if prof is not None:
            prof.stop()
            (out_dir / "profile.txt").write_text(
                profile_table(prof, device, len(losses) - 1, t_end - t_start))
        step_losses = torch.stack(losses).tolist()
        # the log holds what a resumed run reproduces; times go to the printed line
        logged = {"train_loss": sum(step_losses) / len(step_losses),
                  "train_lr": trainer.lr_fn(epoch), "epoch": epoch, "device": dev_name}
        if epoch % args.val_freq == 0 or epoch == args.epochs - 1:
            test = validate(trainer, val_loader, device)
            trainer.best_acc = max(trainer.best_acc, test["acc1"])
            logged.update({f"test_{k}": v for k, v in test.items()})
            if cross_loader is not None:
                logged.update({f"cross_{k}": v for k, v in
                               validate(trainer, cross_loader, device).items()})
        with (out_dir / "log.txt").open("a") as f:
            f.write(json.dumps(logged) + "\n")
        timed = len(losses) - 1
        stats = {**logged,
                 "train_img_per_s": timed * B / (t_end - t_start) if timed else None,
                 "loader_wait_s": waited / timed if timed else None,
                 "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None),
                 "decoder": decoder, "max_acc": trainer.best_acc}
        print(json.dumps(stats), flush=True)
        trainer.epoch = epoch + 1
        save_checkpoint(out_dir, trainer.state_dict())
        history.append({**stats, "train_losses": step_losses,
                        "train_losses_finite": all(map(math.isfinite, step_losses))})
        stop_after = int(os.environ.get("ASN_STOP_AFTER_EPOCHS", "0"))
        if stop_after and epoch + 1 - start_epoch >= stop_after and epoch + 1 < args.epochs:
            # a preemption: the run started again with the same flags resumes
            print(f"preempted after {stop_after} epochs", flush=True)
            return trainer, history
    if trainer.epoch >= args.epochs and history:
        save_flax_variables(out_dir / "variables.npz", trainer.model)
        print(f"Training completed. Top-1 test accuracy: {trainer.best_acc * 100:.1f}",
              flush=True)
    return trainer, history


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(get_args_parser().parse_args(argv))[1]


if __name__ == "__main__":
    main()
