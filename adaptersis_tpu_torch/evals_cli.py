"""DINOv2's frozen-feature evaluations as one command (counterpart of the
JAX package's `evals_cli.py`):

    python -m adaptersis_tpu_torch.evals_cli linear --arch vit_large --pretrained_weights w.pth --data_path /x
    python -m adaptersis_tpu_torch.evals_cli knn --arch vit_large --nb_knn 10 20 100 200 --synthetic
    python -m adaptersis_tpu_torch.evals_cli logreg --arch vit_large --synthetic

The backbone (`hub.build_model_for_eval`: the deployed ViT in fp32 with
exact GELU; on the card its attention, qkv and LayerNorms run K3, K4 and K6)
gives the last `--n_last_blocks` taps of `imgs / 255` under no_grad; knn
and logreg extract the last tap's cls token of the train and val splits,
linear trains the 52-head probe grid on the taps for `--epochs`. The JAX
CLI's flags, with `--device` (the card unless `--device cpu`) in place of
`--platform`; one process. `--synthetic` evaluates on 4 batches per split
of the seeded synthetic frames, labelled "the mask holds class 1"; else
`--dataset` names a `make_dataset` spec over `--data_path`. `main(argv)`
returns the accuracies, the extraction img/s per split and the card's
peak memory.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import hub
from .data.loader import DataLoader
from .data.loaders import make_dataset
from .data.synthetic import SyntheticSeg
from .evals import LinearProbeGrid, ModelWithIntermediateLayers, extract_features, logreg_sweep
from .evals.knn import eval_knn


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dinov2-evals")
    p.add_argument("mode", choices=["linear", "knn", "logreg"])
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=14, type=int)
    p.add_argument("--imsize", default=56, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--dataset", default="imagefolder", type=str)
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--nb_knn", default=[10, 20, 100, 200], nargs="+", type=int)
    p.add_argument("--temperature", default=0.07, type=float)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--seed", default=0, type=int)
    return p


class _HasClassOne:
    """The synthetic frames labelled "the mask holds class 1"."""

    def __init__(self, ds: SyntheticSeg):
        self.ds = ds

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, i: int):
        img, mask, idx = self.ds[i]
        return img, int((mask == 1).any()), idx


def build_loader(args: argparse.Namespace, split: str) -> DataLoader:
    """The loader of one split ("train" or "val"): 4 batches of synthetic
    frames (`--synthetic`), else the `--dataset` spec over `--data_path`."""
    if args.synthetic:
        ds = SyntheticSeg(n=4 * args.batch_size, imsize=args.imsize,
                          seed=args.seed + (split == "val"))
        return DataLoader(_HasClassOne(ds), batch_size=args.batch_size, num_workers=4)
    ds = make_dataset(f"{args.dataset}:split={split}:root={args.data_path}",
                      imsize=args.imsize)
    return DataLoader(ds, batch_size=args.batch_size, num_workers=8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available (use --device cpu for the plain path)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = hub.build_model_for_eval(args.arch, args.pretrained_weights or None,
                                     args.checkpoint_key, patch_size=args.patch_size,
                                     device=device, seed=args.seed)
    if not args.pretrained_weights:
        print("(random backbone weights — pass --pretrained_weights for real evals)")
    fm = ModelWithIntermediateLayers(model, args.n_last_blocks)

    def taps_of(imgs):
        return fm(torch.as_tensor(imgs).to(device).float() / 255.0)

    rates, feats = {}, {}
    for split in ("train", "val"):
        _sync(device)
        t0 = time.perf_counter()
        feats[split] = extract_features(fm, build_loader(args, split))
        _sync(device)
        rates[split] = len(feats[split][0]) / (time.perf_counter() - t0)
    (train_f, train_y), (val_f, val_y) = feats["train"], feats["val"]
    n_classes = int(max(train_y.max(), val_y.max())) + 1
    out = {"mode": args.mode, "arch": args.arch, "imsize": args.imsize,
           "train_images": len(train_f), "val_images": len(val_f),
           "extract_img_per_s": rates, "num_classes": n_classes}

    if args.mode == "knn":
        accs = eval_knn(train_f, train_y, val_f, val_y, num_classes=n_classes,
                        nb_knn=tuple(args.nb_knn), T=args.temperature)
        for k, a in accs.items():
            print(f"{k}-NN accuracy: {a * 100:.2f}%")
        out["accuracy"] = accs
    elif args.mode == "logreg":
        best, accs = logreg_sweep(train_f, train_y, val_f, val_y, num_classes=n_classes)
        print({f"C={c:g}": f"{a*100:.2f}%" for c, a in accs.items()})
        print(f"best C={best:g}: {accs[best] * 100:.2f}%")
        out.update(accuracy=accs, best=best)
    else:
        grid = LinearProbeGrid(embed_dim=model.embed_dim, n_last_blocks=args.n_last_blocks,
                               num_classes=n_classes)
        grid.init(torch.Generator().manual_seed(args.seed))
        grid.to(device)
        train_loader = build_loader(args, "train")
        for _ in range(args.epochs):
            for imgs, ys, _ in train_loader:
                grid.train_step(taps_of(imgs), torch.from_numpy(np.asarray(ys)))
        taps_b, ys_b = [], []
        for imgs, ys, _ in build_loader(args, "val"):
            taps_b.append(taps_of(imgs))
            ys_b.append(torch.from_numpy(np.asarray(ys)))
        best, accs = grid.evaluate(taps_b, ys_b)
        print(f"best classifier: {best} acc={accs[best] * 100:.2f}%")
        out.update(accuracy=accs, best=best)
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


if __name__ == "__main__":
    main()
