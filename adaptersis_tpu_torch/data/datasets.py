"""The five endoscopy datasets and the synthetic one (a copy of the JAX
package's `data/datasets.py`, item for item). Every dataset returns
(image uint8 (H, W, 3), mask int32 (H, W), index) as numpy arrays; scaling
to [0, 1] and the augmentation run on the device in the train step.

Reading: the frame is decoded to RGB and resized to `imsize` with PIL's
BILINEAR, the mask resized with NEAREST, before the mask decode. The native
path (`data/native.py`) gives the same bits; it refuses label formats it
cannot store losslessly in uint8 (16-bit gray, true RGB), and those files,
as every file when the library is missing, go through PIL, which is
imported only then.

Mask decode rules:
  * Robomis: images/<split>/*.png + annotations/<split>/<same name>, mask > 0;
  * EndoVis2017: instrument_dataset_{1..8} train / {1..10} test, binary
    (mask > 0) or instrument labels (mask // 32);
  * EndoVis2018: seq_{1..15} train / seq_{1..4} test, left_frames/ and
    labels/, the mask as PIL's "L" (always read through PIL);
  * CholecSeg8k: images/<split> and annotations/<split>, the stored ids;
  * AutoLaparo: imgs/<split> and masks/<split>, the stored ids (the
    reference's class cannot run; this follows its evident intent).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from . import native
from .synthetic import SyntheticSeg


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding the dataset needs PIL or the native decoder "
                           f"(data/native.py: {native.build_error or 'not built'})") from e
    return Image


class SegDataset:
    """Indexable (image, mask, index) over `img_files` and `mask_files`."""

    img_files: List[str]
    mask_files: List[str]
    imsize: Optional[int] = None
    use_native: bool = True

    def __len__(self) -> int:
        return len(self.img_files)

    def _decode_mask_array(self, mask: np.ndarray) -> np.ndarray:
        """The label ids of a mask's stored values (the native path)."""
        raise NotImplementedError

    def _decode_mask(self, mask) -> np.ndarray:
        """The label ids of a PIL mask."""
        return self._decode_mask_array(np.asarray(mask))

    def _native_item(self, index: int):
        if (not self.use_native or self.imsize is None
                or type(self)._decode_mask_array is SegDataset._decode_mask_array
                or not native.available()):
            return None
        size = (self.imsize, self.imsize)
        img = native.load_image(self.img_files[index], size, "rgb", "bilinear")
        raw = native.load_image(self.mask_files[index], size, "gray", "nearest")
        if img is None or raw is None:
            return None
        return img, self._decode_mask_array(raw).astype(np.int32), index

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, int]:
        fast = self._native_item(index)
        if fast is not None:
            return fast
        Image = _pil()
        with open(self.img_files[index], "rb") as f:
            img = Image.open(f).convert("RGB")
        with open(self.mask_files[index], "rb") as f:
            mask = Image.open(f)
            mask.load()
        if self.imsize is not None:
            img = img.resize((self.imsize, self.imsize), resample=Image.BILINEAR)
            mask = mask.resize((self.imsize, self.imsize), resample=Image.NEAREST)
        return np.asarray(img, np.uint8), self._decode_mask(mask).astype(np.int32), index


def _pairs(img_glob: str, mask_dir: str) -> Tuple[List[str], List[str]]:
    imgs = sorted(glob.glob(img_glob))
    return imgs, [os.path.join(mask_dir, os.path.basename(p)) for p in imgs]


def _is_train(split: str) -> bool:
    return split.lower() in ("training", "train")


class Robomis(SegDataset):
    """Robust-MIS 2019, binary."""

    def __init__(self, dir_main: str, split: str, imsize: Optional[int] = None):
        self.imsize = imsize
        self.img_files, self.mask_files = _pairs(
            os.path.join(dir_main, "images", split, "*.png"),
            os.path.join(dir_main, "annotations", split))

    def _decode_mask_array(self, mask: np.ndarray) -> np.ndarray:
        return (mask > 0).astype(np.int32)


class EndoVis2017(SegDataset):
    """EndoVis 2017: binary, or the instrument labels stored as id·32."""

    def __init__(self, dir_main: str, split: str, imsize: Optional[int] = None,
                 problem_type: str = "binary"):
        self.imsize = imsize
        self.problem_type = problem_type
        n, sub = (8, "train") if _is_train(split) else (10, "test")
        mdir = "binary_masks" if problem_type == "binary" else "instruments_masks"
        self.img_files, self.mask_files = [], []
        for i in range(1, n + 1):
            root = os.path.join(dir_main, sub, f"instrument_dataset_{i}")
            imgs, masks = _pairs(os.path.join(root, "images", "*"), os.path.join(root, mdir))
            self.img_files += imgs
            self.mask_files += masks

    def _decode_mask_array(self, m: np.ndarray) -> np.ndarray:
        if self.problem_type == "binary":
            return (m > 0).astype(np.int32)
        return (m // 32).astype(np.int32)


class EndoVis2018(SegDataset):
    """EndoVis 2018: seq_{1..15} train, seq_{1..4} test."""

    def __init__(self, dir_main: str, split: str, imsize: Optional[int] = None):
        self.imsize = imsize
        seqs, sub = (range(1, 16), "train") if _is_train(split) else (range(1, 5), "test")
        self.img_files, self.mask_files = [], []
        for i in seqs:
            root = os.path.join(dir_main, sub, f"seq_{i}")
            imgs, masks = _pairs(os.path.join(root, "left_frames", "*"),
                                 os.path.join(root, "labels"))
            self.img_files += imgs
            self.mask_files += masks

    def _decode_mask(self, mask) -> np.ndarray:
        return np.asarray(mask.convert("L"), np.int32)


class CholecSeg8k(SegDataset):
    """CholecSeg8k as `data/process/cholec8k.py` writes it."""

    def __init__(self, dir_main: str, split: str, imsize: Optional[int] = None):
        self.imsize = imsize
        self.img_files, self.mask_files = _pairs(
            os.path.join(dir_main, "images", split, "*.png"),
            os.path.join(dir_main, "annotations", split))

    def _decode_mask_array(self, m: np.ndarray) -> np.ndarray:
        return m.astype(np.int32)

    def _decode_mask(self, mask) -> np.ndarray:
        return np.asarray(mask.convert("L"), np.int32)


class AutoLaparo(SegDataset):
    """AutoLaparo task 3: imgs/ and masks/ with train, val and test splits."""

    def __init__(self, dir_main: str, split: str, imsize: Optional[int] = None):
        self.imsize = imsize
        self.img_files, self.mask_files = _pairs(os.path.join(dir_main, "imgs", split, "*"),
                                                 os.path.join(dir_main, "masks", split))

    def _decode_mask_array(self, m: np.ndarray) -> np.ndarray:
        return m.astype(np.int32)

    def _decode_mask(self, mask) -> np.ndarray:
        return np.asarray(mask.convert("L"), np.int32)


DATASETS = {
    "robomis": Robomis,
    "endovis2017": EndoVis2017,
    "endovis2018": EndoVis2018,
    "cholecseg8k": CholecSeg8k,
    "autolaparo": AutoLaparo,
    "synthetic": SyntheticSeg,
}
