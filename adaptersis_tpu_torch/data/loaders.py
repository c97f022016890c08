"""Dataset specs, samplers and loaders by name (counterpart of the JAX
package's `data/loaders.py`, DINOv2's `data/loaders.py` and
`data/adapters.py`).

  * make_dataset("ImageNet:split=TRAIN:root=/x:extra=/y"): a spec of a
    name and `key=value` parts. ImageNet with an `extra` directory is the
    prepared layout (`ImageNet`); ImageNet without one, imagenet22k and
    imagefolder are `ImageFolderDataset` over <root>/<split>; the
    segmentation datasets of `data/datasets.py` take train/val/test as
    training/validation/validation.
  * SamplerType, make_sampler, make_data_loader: the samplers of
    `data/samplers.py` behind the port's threaded `DataLoader`, which
    streams from infinite samplers.
  * DatasetWithEnumeratedTargets: items as (image, (index, target), index).
"""

from __future__ import annotations

import enum
from typing import Optional

from .datasets import DATASETS
from .imagenet import ImageFolderDataset, ImageNet, ImageNetSplit
from .loader import DataLoader
from .samplers import EpochSampler, InfiniteSampler, ShardedInfiniteSampler


class SamplerType(enum.Enum):
    DISTRIBUTED = 0
    EPOCH = 1
    INFINITE = 2
    SHARDED_INFINITE = 3
    SHARDED_INFINITE_NEW = 4


def _parse_spec(spec: str):
    name, *parts = spec.split(":")
    kwargs = {}
    for p in parts:
        k, _, v = p.partition("=")
        kwargs[k.lower()] = v
    return name, kwargs


def make_dataset(dataset_str: str, imsize: Optional[int] = None, **extra):
    name, kw = _parse_spec(dataset_str)
    split = kw.pop("split", "TRAIN")
    root = kw.pop("root", kw.pop("path", ""))
    lname = name.lower()
    if lname == "imagenet" and (kw.get("extra") or extra.get("extra")):
        return ImageNet(split=ImageNetSplit[split.upper()], root=root,
                        extra=kw.get("extra") or extra.get("extra"), imsize=imsize)
    if lname in ("imagenet", "imagenet22k", "imagefolder"):
        return ImageFolderDataset(root, split=split.lower(), imsize=imsize)
    if lname in DATASETS:
        split_map = {"train": "training", "val": "validation", "test": "validation"}
        return DATASETS[lname](root, split=split_map.get(split.lower(), split), imsize=imsize)
    raise ValueError(f'unknown dataset spec "{dataset_str}"')


def make_sampler(sampler_type: SamplerType, size: int, shuffle: bool = True,
                 seed: int = 0, rank: int = 0, world_size: int = 1, advance: int = 0):
    if sampler_type in (SamplerType.DISTRIBUTED, SamplerType.EPOCH):
        return EpochSampler(size, shuffle=shuffle, seed=seed, rank=rank, world_size=world_size)
    if sampler_type == SamplerType.INFINITE:
        return InfiniteSampler(size, shuffle=shuffle, seed=seed, rank=rank,
                               world_size=world_size, advance=advance)
    return ShardedInfiniteSampler(size, shuffle=shuffle, seed=seed, rank=rank,
                                  world_size=world_size, advance=advance)


def make_data_loader(dataset, batch_size: int, num_workers: int = 4,
                     sampler_type: SamplerType = SamplerType.EPOCH, shuffle: bool = True,
                     seed: int = 0, rank: int = 0, world_size: int = 1,
                     drop_last: bool = True, advance: int = 0) -> DataLoader:
    sampler = make_sampler(sampler_type, len(dataset), shuffle, seed, rank, world_size, advance)
    return DataLoader(dataset, sampler=sampler, batch_size=batch_size,
                      num_workers=num_workers, drop_last=drop_last)


class DatasetWithEnumeratedTargets:
    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, index: int):
        img, target, _ = self._dataset[index]
        return img, (index, target), index
