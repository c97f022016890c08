"""EndoVis 2017 converter: each instrument_dataset_N's raw masks store
class_id · factor (binary 255, parts 85, instruments 32); this writes the
label ids into binary_masks/, parts_masks/ and instruments_masks/ beside
its images/ (8 train or 10 test datasets, by whether "train" is in the
root's path), and a JSON index into the root.

    python -m adaptersis_tpu_torch.data.process.endovis2017 <root> [index.json]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import read_mask_gray, write_index, write_mask

BINARY_FACTOR = 255
PARTS_FACTOR = 85
INSTRUMENTS_FACTOR = 32


def process(root_dir: str, data_file: str = "index.json"):
    n = 8 if "train" in root_dir else 10
    entries = []
    for i in range(1, n + 1):
        base = os.path.join(root_dir, f"instrument_dataset_{i}")
        image_dir = os.path.join(base, "images")
        if not os.path.isdir(image_dir):
            continue
        for image_file in sorted(os.listdir(image_dir)):
            image_path = os.path.join(image_dir, image_file)
            png = os.path.splitext(image_file)[0] + ".png"
            for kind, factor in (("binary", BINARY_FACTOR), ("parts", PARTS_FACTOR),
                                 ("instruments", INSTRUMENTS_FACTOR)):
                raw_path = os.path.join(base, f"{kind}_masks_raw", png)
                if not os.path.exists(raw_path):
                    raw_path = os.path.join(base, "ground_truth", f"{kind}_masks", png)
                if not os.path.exists(raw_path):
                    continue
                out = os.path.join(base, f"{kind}_masks", png)
                write_mask(out, (read_mask_gray(raw_path) // factor).astype(np.uint8))
                entries.append({"img_path": image_path, "mask_path": out, "type": kind})
    write_index(os.path.join(root_dir, data_file), entries)
    return entries


if __name__ == "__main__":
    process(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "index.json")
