"""Robust-MIS 2019 converter: <root>/{Training,Testing}/**/*_img.png with
their *_label.png → <out>/images/<split>/*.png and
<out>/annotations/<split>/*.png, the binary instrument mask label > 0.
DATA_TYPE (train or test, default train) selects the split.

    python -m adaptersis_tpu_torch.data.process.robustmis2019 <raw> <out>
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from .common import read_mask_gray, write_index, write_mask, write_rgb

SPLIT_DIRS = {"train": "Training", "test": "Testing"}
SPLIT_OUT = {"train": "training", "test": "validation"}


def process(root_dir: str, out_dir: str, data_type: str | None = None):
    data_type = data_type or os.getenv("DATA_TYPE", "train")
    image_dir = os.path.join(root_dir, SPLIT_DIRS[data_type])
    out_split = SPLIT_OUT[data_type]
    entries = []
    for image_path in sorted(glob.glob(os.path.join(image_dir, "**", "*_img.png"),
                                       recursive=True)):
        mask = read_mask_gray(image_path.replace("_img.png", "_label.png"))
        name = os.path.relpath(image_path, image_dir).replace(os.sep, "_")
        name = name.replace("_img.png", ".png")
        img_out = os.path.join(out_dir, "images", out_split, name)
        write_rgb(image_path, img_out)
        mask_out = os.path.join(out_dir, "annotations", out_split, name)
        write_mask(mask_out, (mask > 0).astype(np.uint8))
        entries.append({"img_path": img_out, "mask_path": mask_out})
    write_index(os.path.join(out_dir, f"index_{out_split}.json"), entries)
    return entries


if __name__ == "__main__":
    process(sys.argv[1], sys.argv[2])
