"""Shared helpers of the offline dataset converters (the JAX package's
`data/process/`): each converter reads a dataset's raw release and writes
the layout `data/datasets.py` reads, label-id PNG masks and a JSON index.
They run on the host only; PIL is imported when a file is read or written."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def pil_image():
    from PIL import Image
    return Image


def write_mask(path: str, mask: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pil_image().fromarray(mask.astype(np.uint8), mode="L").save(path)


def write_rgb(src: str, dst: str) -> None:
    """Re-encode `src` as an RGB PNG at `dst`."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    pil_image().open(src).convert("RGB").save(dst)


def write_index(path: str, entries: List[Dict[str, str]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(entries, f, indent=2)


def read_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pil_image().open(f).convert("RGB"))


def read_mask_gray(path: str) -> np.ndarray:
    """The stored values of a mask; channel 0 of a colour one (the
    reference's converters read cv2.imread's first channel)."""
    with open(path, "rb") as f:
        img = pil_image().open(f)
        img.load()
    arr = np.asarray(img)
    return arr[:, :, 0] if arr.ndim == 3 else arr
