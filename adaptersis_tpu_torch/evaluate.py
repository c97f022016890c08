"""Evaluate a segmentor on the GPU: the port's counterpart of
`train.py --evaluate` on a model that was not trained by `train_seg` (that
one is `train_seg --evaluate`, which restores its checkpoint). `--model`,
`--decoder` and `--mla_last_block_bug` choose the model as `train_seg`'s
do: the adapter model with any decoder, or an eval-script model.

    python -m adaptersis_tpu_torch.evaluate --arch vit_large --patch_size 14 \\
        --imsize 588 --batch_size_per_gpu 2 --bf16 --gelu_approx \\
        --dataset robomis --data_path /data/robomis \\
        --pretrained_weights dinov2_vitl14_pretrain.pth

Parameters come from a seeded numpy draw (`--seed`), or from the JAX
package's variables saved as one .npz whose keys are flax paths under
"params/" and "batch_stats/" (`--flax_variables`); `--pretrained_weights`
then loads a DINOv2 `.pth` into the backbone. The images are the
validation split of `--dataset` under `--data_path`, or synthetic frames
(`--synthetic`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import native
from .data.datasets import DATASETS
from .data.loader import DataLoader
from .data.synthetic import SyntheticSeg
from .models.layers import TRAINED
from .models.segmentor import AdapterSegmentor
from .models.tap_segmentor import TapSegmentor
from .models.vit import build_backbone
from .train.convert import load_dinov2_backbone, load_flax_variables, seeded_init_
from .train.trainer import cast_for_inference, eval_step


MODELS = ["adapter", "tap_setr", "tap_unet", "tap_unet_fuse", "tap_masktrans", "tap_setr_ete"]
DECODERS = ["feature", "mla", "setr"]
# each eval script's own training loss, taken where --loss is left at "dc"
TAP_LOSSES = {"tap_setr": "ce_dc", "tap_unet": "ce_dc", "tap_unet_fuse": "ce_dc",
              "tap_masktrans": "masktrans", "tap_setr_ete": "ce_dc"}


def input_norm(model: str) -> str:
    """The input normalisation of `--model`: only the mask transformer's
    script normalises (`data/augment.py:apply_input_norm`)."""
    return "imagenet_div255" if model == "tap_masktrans" else "none"


def model_loss(model: str, loss: str) -> str:
    """The train loss of `--model` given `--loss`: the eval-script models
    take their script's loss where --loss is left at "dc" (the JAX
    train.py's rule)."""
    return TAP_LOSSES.get(model, loss) if loss == "dc" else loss


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-evaluate")
    p.add_argument("--model", default="adapter", choices=MODELS,
                   help="the adapter model, or one of the eval scripts' models")
    p.add_argument("--decoder", default="feature", choices=DECODERS,
                   help="the adapter model's decoder")
    p.add_argument("--mla_last_block_bug", action="store_true",
                   help="train_mla.py's fault: the last adapter round re-runs block depth − 2")
    p.add_argument("--arch", default="vit_small", type=str)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--imsize", default=224, type=int)
    p.add_argument("--batch_size_per_gpu", default=16, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--gelu_approx", action="store_true", help="tanh GELU in the backbone MLPs")
    p.add_argument("--pretrained_weights", default="", type=str,
                   help="a DINOv2 .pth checkpoint for the backbone")
    p.add_argument("--checkpoint_key", default="teacher", type=str,
                   help="the .pth's sub-dict holding the backbone, if it has one")
    p.add_argument("--dataset", default="robomis", choices=list(DATASETS))
    p.add_argument("--data_path", default="/path/to/imagenet/", type=str,
                   help="the dataset's root; its validation split is evaluated")
    p.add_argument("--num_workers", default=10, type=int, help="decoding threads")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--val_images", default=0, type=int,
                   help="synthetic validation images (default: 2 batches)")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--flax_variables", default="", type=str,
                   help=".npz of flax variables (keys 'params/...', 'batch_stats/...')")
    return p


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def build_model(args) -> torch.nn.Module:
    """The model `--model` names, on the CPU: flax variables or a seeded
    draw, then the pretrained backbone (the draw skips the backbone when
    there is one). `tap_setr_ete` trains its backbone, so it gets the trained
    block configuration; every other model's frozen walks the deployed one."""
    name = getattr(args, "model", "adapter")
    impls = (dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
             if name == "tap_setr_ete" else {})
    backbone = build_backbone(args.arch, img_size=518, patch_size=args.patch_size,
                              gelu_approx=args.gelu_approx, **impls)
    if name == "adapter":
        model = AdapterSegmentor(backbone, num_classes=args.num_classes,
                                 n_last_blocks=args.n_last_blocks,
                                 decoder_type=getattr(args, "decoder", "feature"),
                                 parity_frozen_head=getattr(args, "parity_frozen_head", False),
                                 mla_last_block_bug=getattr(args, "mla_last_block_bug", False))
    else:
        model = TapSegmentor(backbone, num_classes=args.num_classes,
                             n_last_blocks=args.n_last_blocks, decoder=name[len("tap_"):])
    pretrained = args.pretrained_weights
    if args.flax_variables:
        with np.load(args.flax_variables) as f:
            flat = dict(f)
        load_flax_variables(model, _unflatten(flat, "params"), _unflatten(flat, "batch_stats"))
    else:
        seeded_init_(model, args.seed, skip=("backbone.",) if pretrained else ())
    if pretrained:
        load_dinov2_backbone(model.backbone, pretrained, args.checkpoint_key)
        print(f"loaded pretrained backbone from {pretrained} (key={args.checkpoint_key})",
              flush=True)
    return model


def validation_set(args, root: str = ""):
    """The validation set `args` name: synthetic frames, or the validation
    split of `--dataset` under `root` (default `--data_path`), resized to
    `--imsize`."""
    if args.synthetic or args.dataset == "synthetic":
        return SyntheticSeg(n=getattr(args, "val_images", 0) or 2 * args.batch_size_per_gpu,
                            imsize=args.imsize, num_classes=args.num_classes, seed=args.seed + 1)
    ds = DATASETS[args.dataset](root or args.data_path, split="validation", imsize=args.imsize)
    if not len(ds):
        sys.exit(f"error: no validation images of --dataset {args.dataset} under "
                 f"{root or args.data_path}")
    return ds


def data_decoder(args) -> str:
    """What reads the images: "synthetic", "native" or "pil"."""
    if args.synthetic or args.dataset == "synthetic":
        return "synthetic"
    name = native.decoder()
    if name == "none":
        sys.exit("error: neither the native decoder nor PIL is available: "
                 f"{native.build_error}")
    return name


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    if args.imsize % args.patch_size:
        sys.exit(f"error: --imsize {args.imsize} must be divisible by --patch_size "
                 f"{args.patch_size}")
    decoder = data_decoder(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = cast_for_inference(build_model(args), dtype).to(device).eval()
    ds = validation_set(args)
    loader = DataLoader(ds, batch_size=args.batch_size_per_gpu, num_workers=args.num_workers,
                        drop_last=False)

    sums = {}
    n_images, finite, times, sizes = 0, True, [], []
    for imgs, masks, _ in loader:
        imgs = torch.from_numpy(imgs).to(device)
        masks = torch.from_numpy(masks).to(device)
        t0 = time.perf_counter()
        out = eval_step(model, imgs, masks, input_norm=input_norm(args.model))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        n = imgs.shape[0]
        if tuple(out["logits"].shape) != (n, args.imsize, args.imsize, args.num_classes):
            raise RuntimeError(f"logits of shape {tuple(out['logits'].shape)} for a batch "
                               f"of {n} images of {args.imsize} px")
        finite &= bool(torch.isfinite(out["logits"]).all())
        n_images += n
        sizes.append(n)
        for k, v in out.items():
            if k not in ("preds", "logits"):
                sums[k] = sums.get(k, 0.0) + float(v) * n
    stats = {k: v / n_images for k, v in sums.items()}
    # the first batch carries one-time costs (kernel build, cuDNN autotune)
    steady, steady_n = (times[1:], sizes[1:]) if len(times) > 1 else (times, sizes)
    stats.update(images=n_images, batches=len(times), logits_finite=finite,
                 img_per_s=sum(steady_n) / sum(steady), decoder=decoder,
                 device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"))
    print(json.dumps(stats))
    print(f"Accuracy of the network on the {n_images} test images: "
          f"{stats['acc1'] * 100:.1f}%")
    return stats


if __name__ == "__main__":
    main()
