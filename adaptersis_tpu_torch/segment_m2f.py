"""Train the ViT-Adapter + Mask2Former segmentor on the GPU: the port's
counterpart of `segment_m2f.py`, with its flags and defaults.

    python -m adaptersis_tpu_torch.segment_m2f --arch vit_large --imsize 518 \\
        --batch_size_per_gpu 4 --dataset robomis --data_path /data/robomis \\
        --pretrained_weights dinov2_vitl14_pretrain.pth --output_dir out

The model (`models/mask2former.py:Mask2FormerSegmentor`): a frozen DINOv2
backbone (`--arch`, built at img_size 518, exact GELU, fp32) under a
ViTAdapter FPN, then the Mask2Former head (`--num_queries`,
`--feat_channels`, `--num_decoder_layers`). The loss: Hungarian-matched
class, point-sampled mask BCE and dice over every decoder layer
(`models/m2f_loss.py`), the ground truth one binary mask per foreground
class; AdamW (`--lr`, `--weight_decay`) on everything but the backbone, in
fp32. Validation: semantic inference of the last layer, dice and acc1.

The data are the five endoscopy datasets under `--data_path`
(`--dataset`) or synthetic frames (`--synthetic`: 4 batches to train on,
2 to validate). Parameters are a seeded numpy draw (`--seed`), the
backbone's from `--pretrained_weights` (a DINOv2 `.pth`,
`--checkpoint_key`) where given. Each epoch appends one JSON line to
`<output_dir>/log.txt` (the train meters' and the validation meters'
global averages, as `train_*` and `val_*`) and saves
`<output_dir>/m2f_checkpoint.pth` (the trainables, the BatchNorm
statistics, the AdamW state and the next epoch); the same command again
resumes from it. The frozen backbone is not in the checkpoint: it comes
from the same weights or seed again.

Kernels on the card: the backbone's frozen walk (K3, K4, and K6 before
the exact-GELU MLPs; K5 with tanh GELU), the adapters' and the pixel
decoder's deformable attention (K1, K2). `--msda_impl` and `--platform`
are the JAX package's choices, accepted and not acted on. Without a card
it exits unless `--device cpu` is given (the plain paths).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from .data.datasets import DATASETS
from .data.loader import DataLoader
from .data.samplers import EpochSampler
from .data.synthetic import SyntheticSeg
from .losses import dc_loss, pixel_accuracy
from .models.m2f_loss import loss_draws, m2f_total_loss, semantic_to_instances
from .models.mask2former import Mask2FormerSegmentor, mask2former_semantic_inference
from .models.vit import build_backbone
from .train.checkpoint import restore_checkpoint, save_checkpoint
from .train.convert import load_dinov2_backbone, seeded_init_
from .train.trainer import _precast
from .utils.logging import MetricLogger

CHECKPOINT = "m2f_checkpoint"


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("segment-m2f")
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=14, type=int)
    p.add_argument("--imsize", default=518, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--dataset", default="robomis", type=str, choices=list(DATASETS))
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--num_queries", default=100, type=int)
    p.add_argument("--feat_channels", default=256, type=int)
    p.add_argument("--num_decoder_layers", default=9, type=int)
    p.add_argument("--msda_impl", default="gather", choices=["gather", "matmul", "pallas"],
                   help="the JAX package's deformable-attention choice, not acted on: the "
                        "port runs its MSDA kernels (K1, K2) on the card")
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--batch_size_per_gpu", default=4, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--platform", default=None, type=str,
                   help="the JAX package's platform choice, not acted on: --device picks the "
                        "device")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str)
    return p


def build_model(args, **backbone_kw) -> Mask2FormerSegmentor:
    """The model `args` name, on the CPU: a seeded draw, then the pretrained
    backbone (the draw skips the backbone when there is one)."""
    backbone = build_backbone(args.arch, img_size=518, patch_size=args.patch_size,
                              **backbone_kw)
    model = Mask2FormerSegmentor(backbone, args.num_classes, args.num_queries,
                                 args.feat_channels, args.num_decoder_layers)
    seeded_init_(model, args.seed, skip=("adapter.backbone.",) if args.pretrained_weights
                 else ())
    if args.pretrained_weights:
        load_dinov2_backbone(model.backbone, args.pretrained_weights, args.checkpoint_key)
        print(f"loaded pretrained backbone from {args.pretrained_weights} "
              f"(key={args.checkpoint_key})", flush=True)
    return model


class M2FTrainer:
    """The train and eval steps: AdamW (optax's adamw: β 0.9, 0.999, eps
    1e-8, decoupled decay) on every parameter outside the frozen backbone.
    A parameter without a gradient (the injectors, which reach the loss
    only through the frozen blocks) gets a zero one, so that AdamW decays
    it as optax does. With `bf16` the backbone is stored in bf16 (pos_embed
    fp32) and the model runs under autocast; the loss is fp32."""

    BACKBONE = "adapter.backbone."

    def __init__(self, model: Mask2FormerSegmentor, num_classes: int, lr: float = 1e-4,
                 weight_decay: float = 0.05, bf16: bool = False):
        self.model = model
        self.num_classes = num_classes
        self.bf16 = bf16
        self.epoch = 0
        model.backbone.requires_grad_(False)
        if bf16:
            _precast(model.backbone, model.backbone, torch.bfloat16)
        self.params = [p for n, p in model.named_parameters() if not n.startswith(self.BACKBONE)]
        self.optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)

    def autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.params[0].device.type, dtype=torch.bfloat16)

    def instances(self, masks: torch.Tensor):
        """One binary mask per foreground class (G = num_classes slots)."""
        return semantic_to_instances(masks, self.num_classes, self.num_classes)

    def loss(self, x01: torch.Tensor, masks: torch.Tensor, draws
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode forward and the criterion (fp32, or the model's float64):
        (total, the last layer's parts)."""
        self.model.train()
        with self.autocast():
            cls_all, mask_all = self.model(x01)
        gt_masks, gt_labels = self.instances(masks)
        dt = torch.promote_types(cls_all[0].dtype, torch.float32)
        return m2f_total_loss([c.to(dt) for c in cls_all], [m.to(dt) for m in mask_all],
                              gt_masks.to(dt), gt_labels, draws)

    def step(self, imgs_u8: torch.Tensor, masks: torch.Tensor, draws
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One AdamW step on uint8 frames (B, H, W, 3) and semantic masks;
        returns the loss and the last layer's parts as device tensors."""
        total, logs = self.loss(imgs_u8.float() / 255.0, masks, draws)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return total.detach(), {k: v.detach() for k, v in logs.items()}

    def draws(self, generator: torch.Generator, batch: int):
        """The step's random points: one set per prediction."""
        return loss_draws(generator, self.model.head.num_decoder_layers + 1, batch,
                          self.num_classes)

    @torch.no_grad()
    def eval_step(self, imgs_u8: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Semantic inference of the last layer at the input size; dice (1 −
        DC loss) and acc1 over the batch."""
        self.model.eval()
        with self.autocast():
            cls_all, mask_all = self.model(imgs_u8.float() / 255.0)
        seg = mask2former_semantic_inference(cls_all[-1].float(), mask_all[-1].float(),
                                             tuple(imgs_u8.shape[1:3]))
        return {"dice": 1.0 - dc_loss(seg, masks), "acc1": pixel_accuracy(seg, masks)}

    def state_dict(self) -> Dict[str, Any]:
        return {"model": {k: v for k, v in self.model.state_dict().items()
                          if not k.startswith(self.BACKBONE)},
                "optimizer": self.optimizer.state_dict(), "epoch": self.epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        missing, unexpected = self.model.load_state_dict(state["model"], strict=False)
        missing = [k for k in missing if not k.startswith(self.BACKBONE)]
        if missing or unexpected:
            raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                           f"unexpected {unexpected}")
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["epoch"])


def datasets(args):
    if args.synthetic:
        B = args.batch_size_per_gpu
        return (SyntheticSeg(n=4 * B, imsize=args.imsize, num_classes=args.num_classes,
                             seed=args.seed),
                SyntheticSeg(n=2 * B, imsize=args.imsize, num_classes=args.num_classes,
                             seed=args.seed + 1))
    ds = DATASETS[args.dataset]
    return (ds(args.data_path, split="training", imsize=args.imsize),
            ds(args.data_path, split="validation", imsize=args.imsize))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> Tuple[M2FTrainer, List[dict]]:
    """Train as the flags say; returns the trainer and one stats dict per
    epoch run (the logged averages, the step losses, img/s over the steps
    after the first, the peak memory)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    if args.imsize % args.patch_size:
        sys.exit(f"error: --imsize {args.imsize} must be divisible by --patch_size "
                 f"{args.patch_size}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    B = args.batch_size_per_gpu
    trainer = M2FTrainer(build_model(args).to(device), args.num_classes, args.lr,
                         args.weight_decay)
    ds_train, ds_val = datasets(args)
    pin = device.type == "cuda"
    sampler = EpochSampler(len(ds_train), seed=args.seed)
    loader = DataLoader(ds_train, sampler=sampler, batch_size=B,
                        num_workers=args.num_workers, pin_memory=pin)
    val_loader = DataLoader(ds_val, batch_size=B, num_workers=args.num_workers,
                            drop_last=False, pin_memory=pin)
    if not len(loader):
        sys.exit(f"error: {len(ds_train)} training images, fewer than a batch of {B}")

    restored = restore_checkpoint(out_dir, CHECKPOINT, map_location=device)
    if restored is not None:
        trainer.load_state_dict(restored)
        print(f"resumed from epoch {trainer.epoch}", flush=True)
    generator = torch.Generator(device)
    history = []
    for epoch in range(trainer.epoch, args.epochs):
        # the epoch's draws seeded from (seed, epoch): a resumed epoch repeats them
        generator.manual_seed(args.seed + 1234 + epoch)
        sampler.set_epoch(epoch)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        logger, losses, t_start = MetricLogger(), [], None
        for step, (imgs, masks, _) in enumerate(
                logger.log_every(loader, 10, f"Epoch: [{epoch}]")):
            if step == 1:
                _sync(device)
                t_start = time.perf_counter()
            loss, logs = trainer.step(torch.as_tensor(imgs).to(device, non_blocking=True),
                                      torch.as_tensor(masks).to(device, non_blocking=True),
                                      trainer.draws(generator, B))
            losses.append(float(loss))
            logger.update(loss=losses[-1], **{k: float(v) for k, v in logs.items()})
        _sync(device)
        timed = len(losses) - 1
        img_s = timed * B / (time.perf_counter() - t_start) if timed else None
        val = MetricLogger()
        for imgs, masks, _ in val_loader:
            m = trainer.eval_step(torch.as_tensor(imgs).to(device),
                                  torch.as_tensor(masks).to(device))
            val.update(**{k: float(v) for k, v in m.items()})
        print(f"epoch {epoch} train: {logger}  val: {val}", flush=True)
        logged = {"epoch": epoch,
                  **{f"train_{k}": m.global_avg for k, m in logger.meters.items()},
                  **{f"val_{k}": m.global_avg for k, m in val.meters.items()}}
        with (out_dir / "log.txt").open("a") as f:
            f.write(json.dumps(logged) + "\n")
        trainer.epoch = epoch + 1
        save_checkpoint(out_dir, trainer.state_dict(), CHECKPOINT)
        stats = {**logged, "train_losses": losses, "train_img_per_s": img_s,
                 "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None)}
        print(json.dumps({k: v for k, v in stats.items() if k != "train_losses"}), flush=True)
        history.append(stats)
    return trainer, history


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(get_args_parser().parse_args(argv))[1]


if __name__ == "__main__":
    main()
