"""CholecSeg8k converter: the 13-class watershed masks decoded by their gray
levels, videos split into training and validation as in "Class-wise
confidence-aware active learning" → <out>/images/<split>/ and
<out>/annotations/<split>/, and a JSON index.

    python -m adaptersis_tpu_torch.data.process.cholec8k <raw> <out>
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from .common import read_mask_gray, write_index, write_mask, write_rgb

CLASS_LIST = [
    "black_background", "abdominal_wall", "liver", "gastrointestinal_tract",
    "fat", "grasper", "connective_tissue", "blood", "cystic_duct",
    "l_hook_electrocautery", "gallbladder", "hepatic_vein", "liver_ligament",
]

# each class's gray level in the watershed masks
CLASS2GRAY = {
    "black_background": 50, "abdominal_wall": 11, "liver": 21,
    "gastrointestinal_tract": 13, "fat": 12, "grasper": 31,
    "connective_tissue": 23, "blood": 24, "cystic_duct": 25,
    "l_hook_electrocautery": 32, "gallbladder": 22, "hepatic_vein": 33,
    "liver_ligament": 5,
}

TRAIN_VIDEOS = ["video01", "video09", "video17", "video18", "video20", "video24",
                "video25", "video26", "video27", "video28", "video35", "video37",
                "video43"]
TEST_VIDEOS = ["video12", "video48", "video52", "video55"]


def decode_watershed(mask: np.ndarray) -> np.ndarray:
    out = np.zeros(mask.shape, np.uint8)
    for cid, cname in enumerate(CLASS_LIST):
        out[mask == CLASS2GRAY[cname]] = cid
    return out


def process(root_dir: str, out_dir: str):
    entries = []
    for split, videos in (("training", TRAIN_VIDEOS), ("validation", TEST_VIDEOS)):
        for video in videos:
            for img_path in sorted(glob.glob(os.path.join(root_dir, video, "*", "*_endo.png"))):
                ws_path = img_path.replace("_endo.png", "_endo_watershed_mask.png")
                if not os.path.exists(ws_path):
                    continue
                name = f"{video}_{os.path.basename(img_path)}"
                img_out = os.path.join(out_dir, "images", split, name)
                write_rgb(img_path, img_out)
                mask_out = os.path.join(out_dir, "annotations", split, name)
                write_mask(mask_out, decode_watershed(read_mask_gray(ws_path)))
                entries.append({"img_path": img_out, "mask_path": mask_out})
    write_index(os.path.join(out_dir, "index.json"), entries)
    return entries


if __name__ == "__main__":
    process(sys.argv[1], sys.argv[2])
