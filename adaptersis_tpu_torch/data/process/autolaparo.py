"""AutoLaparo task 3 converter: 10 classes by gray level (background 0,
uterus 180, and four instruments each with a manipulator and a shaft
level) → <out>/imgs/<split>/ and <out>/masks/<split>/ with class ids, and
a JSON index. DATA_TYPE (default train) names the split.

    python -m adaptersis_tpu_torch.data.process.autolaparo <raw> <out>
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from .common import read_mask_gray, write_index, write_mask, write_rgb

GRAY2CLASS = {
    0: 0,     # background
    180: 1,   # uterus
    20: 2,    # grasping forceps manipulator
    40: 3,    # grasping forceps shaft
    60: 4,    # ligasure manipulator
    80: 5,    # ligasure shaft
    100: 6,   # dissecting grasping forceps manipulator
    120: 7,   # dissecting grasping forceps shaft
    140: 8,   # electric hook manipulator
    160: 9,   # electric hook shaft
}


def process(root_dir: str, out_dir: str, data_type: str | None = None):
    data_type = data_type or os.getenv("DATA_TYPE", "train")
    img_dir = os.path.join(root_dir, "autolaparo", "imgs", data_type)
    entries = []
    for image_path in sorted(glob.glob(os.path.join(img_dir, "*"))):
        mask_path = image_path.replace(os.path.join("autolaparo", "imgs"),
                                       os.path.join("autolaparo", "masks"))
        mask_path = os.path.splitext(mask_path)[0] + ".png"
        if not os.path.exists(mask_path):
            continue
        raw = read_mask_gray(mask_path)
        mask = np.zeros(raw.shape, np.uint8)
        for gray, cid in GRAY2CLASS.items():
            mask[raw == gray] = cid
        name = os.path.basename(os.path.splitext(image_path)[0]) + ".png"
        img_out = os.path.join(out_dir, "imgs", data_type, name)
        write_rgb(image_path, img_out)
        mask_out = os.path.join(out_dir, "masks", data_type, name)
        write_mask(mask_out, mask)
        entries.append({"img_path": img_out, "mask_path": mask_out})
    write_index(os.path.join(out_dir, f"index_{data_type}.json"), entries)
    return entries


if __name__ == "__main__":
    process(sys.argv[1], sys.argv[2])
