"""ImageNet-style classification datasets (a numpy + PIL copy of the JAX
package's `data/imagenet.py`, item for item; DINOv2's
`data/datasets/image_net.py`). Every item is (image uint8 (H, W, 3),
class index, dataset index), resized to `imsize` with PIL's BILINEAR.

  * ImageFolderDataset: <root>/<split>/<class_name>/<image>, classes in
    sorted order; an `_entries_<split>.npy` cache in the root makes a
    reopen O(1) (skipped on a read-only root).
  * ImageNetSplit, ImageNet: DINOv2's prepared layout, the train/val tree
    plus an `extra` directory of `entries-<SPLIT>.npy` (a structured array
    read through mmap), `class-ids-<SPLIT>.npy` and `class-names-<SPLIT>.npy`
    that `dump_extra` writes from `labels.txt` (torchvision ImageFolder's
    enumeration order). TEST has no labels (class index u32 −1, target −1).
    `__len__` is the entries' count, not the full split's, so prepared
    subsets load.
"""

from __future__ import annotations

import csv
import io
import os
from enum import Enum
from typing import Optional, Tuple

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _image(f, imsize: Optional[int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(f).convert("RGB")
    if imsize is not None:
        img = img.resize((imsize, imsize), Image.BILINEAR)
    return np.asarray(img, np.uint8)


class ImageFolderDataset:
    def __init__(self, root: str, split: str = "train", imsize: Optional[int] = None):
        self.root = root
        self.split = split
        self.imsize = imsize
        cache = os.path.join(root, f"_entries_{split}.npy")
        if os.path.exists(cache):
            blob = np.load(cache, allow_pickle=True).item()
            self.paths, self.labels, self.classes = blob["paths"], blob["labels"], blob["classes"]
            return
        split_dir = os.path.join(root, split)
        self.classes = sorted(d for d in os.listdir(split_dir)
                              if os.path.isdir(os.path.join(split_dir, d))
                              ) if os.path.isdir(split_dir) else []
        paths, labels = [], []
        for cid, cname in enumerate(self.classes):
            cdir = os.path.join(split_dir, cname)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(_EXTS):
                    paths.append(os.path.join(cdir, f))
                    labels.append(cid)
        self.paths = np.asarray(paths)
        self.labels = np.asarray(labels, np.int32)
        try:
            np.save(cache, {"paths": self.paths, "labels": self.labels,
                            "classes": self.classes}, allow_pickle=True)
        except OSError:
            pass        # a read-only root: no cache

    def __len__(self) -> int:
        return len(self.paths)

    def get_target(self, index: int) -> int:
        return int(self.labels[index])

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int, int]:
        with open(self.paths[index], "rb") as f:
            img = _image(f, self.imsize)
        return img, int(self.labels[index]), index


class ImageNetSplit(Enum):
    """DINOv2's split enum and path scheme."""

    TRAIN = "train"
    VAL = "val"
    TEST = "test"

    @property
    def length(self) -> int:
        return {ImageNetSplit.TRAIN: 1_281_167, ImageNetSplit.VAL: 50_000,
                ImageNetSplit.TEST: 100_000}[self]

    def get_dirname(self, class_id: Optional[str] = None) -> str:
        return self.value if class_id is None else os.path.join(self.value, class_id)

    def get_image_relpath(self, actual_index: int, class_id: Optional[str] = None) -> str:
        dirname = self.get_dirname(class_id)
        if self == ImageNetSplit.TRAIN:
            basename = f"{class_id}_{actual_index}"
        else:
            basename = f"ILSVRC2012_{self.value}_{actual_index:08d}"
        return os.path.join(dirname, basename + ".JPEG")

    def parse_image_relpath(self, image_relpath: str):
        assert self != ImageNetSplit.TEST
        dirname, filename = os.path.split(image_relpath)
        class_id = os.path.split(dirname)[-1]
        basename, _ = os.path.splitext(filename)
        return class_id, int(basename.split("_")[-1])


class ImageNet:
    Split = ImageNetSplit

    def __init__(self, *, split: ImageNetSplit, root: str, extra: str,
                 imsize: Optional[int] = None):
        self.root = root
        self._extra_root = extra
        self._split = split
        self.imsize = imsize
        self._entries = None
        self._class_ids = None
        self._class_names = None

    @property
    def split(self) -> ImageNetSplit:
        return self._split

    def _extra_path(self, name: str) -> str:
        return os.path.join(self._extra_root, name)

    def _load_extra(self, name: str) -> np.ndarray:
        return np.load(self._extra_path(name), mmap_mode="r")

    def _save_extra(self, arr: np.ndarray, name: str) -> None:
        os.makedirs(self._extra_root, exist_ok=True)
        np.save(self._extra_path(name), arr)

    @property
    def _entries_name(self) -> str:
        return f"entries-{self._split.value.upper()}.npy"

    def _get_entries(self) -> np.ndarray:
        if self._entries is None:
            self._entries = self._load_extra(self._entries_name)
        return self._entries

    def _get_class_ids(self) -> np.ndarray:
        assert self._split != ImageNetSplit.TEST, "Class IDs are not available in TEST split"
        if self._class_ids is None:
            self._class_ids = self._load_extra(f"class-ids-{self._split.value.upper()}.npy")
        return self._class_ids

    def _get_class_names(self) -> np.ndarray:
        assert self._split != ImageNetSplit.TEST, "Class names are not available in TEST split"
        if self._class_names is None:
            self._class_names = self._load_extra(f"class-names-{self._split.value.upper()}.npy")
        return self._class_names

    def find_class_id(self, class_index: int) -> str:
        return str(self._get_class_ids()[class_index])

    def find_class_name(self, class_index: int) -> str:
        return str(self._get_class_names()[class_index])

    def get_image_relpath(self, index: int) -> str:
        actual_index = int(self._get_entries()[index]["actual_index"])
        return self._split.get_image_relpath(actual_index, self.get_class_id(index))

    def get_image_data(self, index: int) -> bytes:
        with open(os.path.join(self.root, self.get_image_relpath(index)), "rb") as f:
            return f.read()

    def get_target(self, index: int) -> Optional[int]:
        if self._split == ImageNetSplit.TEST:
            return None
        return int(self._get_entries()[index]["class_index"])

    def get_targets(self) -> Optional[np.ndarray]:
        if self._split == ImageNetSplit.TEST:
            return None
        return self._get_entries()["class_index"]

    def get_class_id(self, index: int) -> Optional[str]:
        entries = self._get_entries()
        return None if self._split == ImageNetSplit.TEST else str(entries[index]["class_id"])

    def get_class_name(self, index: int) -> Optional[str]:
        entries = self._get_entries()
        return None if self._split == ImageNetSplit.TEST else str(entries[index]["class_name"])

    def __len__(self) -> int:
        return len(self._get_entries())

    def __getitem__(self, index: int):
        img = _image(io.BytesIO(self.get_image_data(index)), self.imsize)
        t = self.get_target(index)
        return img, (-1 if t is None else t), index

    def _load_labels(self):
        """labels.txt: `class_id,class_name` rows."""
        path = os.path.join(self.root, "labels.txt")
        try:
            with open(path) as f:
                return [(r[0], r[1]) for r in csv.reader(f)]
        except OSError as e:
            raise RuntimeError(f'can not read labels file "{path}"') from e

    def _enumerate_samples(self):
        """Sorted class directories, sorted files: torchvision ImageFolder's
        order, which assigns the class indices."""
        split_dir = os.path.join(self.root, self._split.get_dirname())
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        for class_index, class_id in enumerate(classes):
            for fname in sorted(os.listdir(os.path.join(split_dir, class_id))):
                yield os.path.join(self._split.value, class_id, fname), class_index

    def dump_extra(self) -> None:
        split = self._split
        if split == ImageNetSplit.TEST:
            dtype = np.dtype([("actual_index", "<u4"), ("class_index", "<u4"),
                              ("class_id", "U1"), ("class_name", "U1")])
            entries = np.empty(split.length, dtype=dtype)
            for i in range(split.length):
                entries[i] = (i + 1, np.uint32(-1), "", "")
            self._save_extra(entries, self._entries_name)
            return
        labels = self._load_labels()
        class_names = dict(labels)
        samples = list(self._enumerate_samples())
        max_id = max((len(c) for c, _ in labels), default=1)
        max_name = max((len(n) for _, n in labels), default=1)
        dtype = np.dtype([("actual_index", "<u4"), ("class_index", "<u4"),
                          ("class_id", f"U{max_id}"), ("class_name", f"U{max_name}")])
        entries = np.empty(len(samples), dtype=dtype)
        for i, (relpath, class_index) in enumerate(samples):
            class_id, actual_index = split.parse_image_relpath(relpath)
            entries[i] = (actual_index, class_index, class_id, class_names[class_id])
        self._save_extra(entries, self._entries_name)
        max_index = int(entries["class_index"].max())
        class_ids = np.empty(max_index + 1, dtype=f"U{max_id}")
        names = np.empty(max_index + 1, dtype=f"U{max_name}")
        for e in entries:
            class_ids[e["class_index"]] = e["class_id"]
            names[e["class_index"]] = e["class_name"]
        self._save_extra(class_ids, f"class-ids-{split.value.upper()}.npy")
        self._save_extra(names, f"class-names-{split.value.upper()}.npy")
