"""Evaluate an AdapterSegmentor on the GPU: the port's counterpart of
`train.py --evaluate`.

    python -m adaptersis_tpu_torch.evaluate --arch vit_large --patch_size 14 \\
        --imsize 588 --batch_size_per_gpu 2 --bf16 --gelu_approx --synthetic

Parameters come from a seeded numpy draw (`--seed`), or from the JAX
package's variables saved as one .npz whose keys are flax paths under
"params/" and "batch_stats/" (`--flax_variables`). Real datasets wait for the
port's data layer; `--synthetic` is required for now.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.synthetic import SyntheticSeg
from .models.segmentor import AdapterSegmentor
from .models.vit import build_backbone
from .train.convert import load_flax_variables, seeded_init_
from .train.trainer import cast_for_inference, eval_step


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adaptersis-torch-evaluate")
    p.add_argument("--arch", default="vit_small", type=str)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--imsize", default=224, type=int)
    p.add_argument("--batch_size_per_gpu", default=16, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--gelu_approx", action="store_true", help="tanh GELU in the backbone MLPs")
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


def build_model(args) -> AdapterSegmentor:
    backbone = build_backbone(args.arch, img_size=518, patch_size=args.patch_size,
                              gelu_approx=args.gelu_approx)
    model = AdapterSegmentor(backbone, num_classes=args.num_classes,
                             n_last_blocks=args.n_last_blocks)
    if args.flax_variables:
        with np.load(args.flax_variables) as f:
            flat = dict(f)
        load_flax_variables(model, _unflatten(flat, "params"), _unflatten(flat, "batch_stats"))
    else:
        seeded_init_(model, args.seed)
    return model


def main(argv: Optional[List[str]] = None) -> dict:
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
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = cast_for_inference(build_model(args), dtype).to(device).eval()
    ds = SyntheticSeg(n=args.val_images or 2 * args.batch_size_per_gpu, imsize=args.imsize,
                      num_classes=args.num_classes, seed=args.seed + 1)

    sums = {"loss": 0.0, "dice": 0.0, "acc1": 0.0}
    n_images, finite, times, sizes = 0, True, [], []
    for imgs, masks in ds.batches(args.batch_size_per_gpu):
        imgs = torch.from_numpy(imgs).to(device)
        masks = torch.from_numpy(masks).to(device)
        t0 = time.perf_counter()
        out = eval_step(model, imgs, masks)
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
        for k in sums:
            sums[k] += float(out[k]) * n
    stats = {k: v / n_images for k, v in sums.items()}
    # the first batch carries one-time costs (kernel build, cuDNN autotune)
    steady, steady_n = (times[1:], sizes[1:]) if len(times) > 1 else (times, sizes)
    stats.update(images=n_images, batches=len(times), logits_finite=finite,
                 img_per_s=sum(steady_n) / sum(steady),
                 device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"))
    print(json.dumps(stats))
    print(f"Accuracy of the network on the {n_images} test images: "
          f"{stats['acc1'] * 100:.1f}%")
    return stats


if __name__ == "__main__":
    main()
