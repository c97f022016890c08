"""EndoVis 2018 converter: each sequence's RGB-coded labels (id = R + 256·G
+ 256²·B, mapped to the 7 instrument classes through its labels.json) →
train/seq_N/labels/ with integer class ids, and a JSON index into the root.

    python -m adaptersis_tpu_torch.data.process.endovis2018 <root> [index.json]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from .common import read_image, write_index, write_mask

LABELS = [
    {"name": "bipolar_forceps", "classid": 1},
    {"name": "prograsp_forceps", "classid": 2},
    {"name": "large_needle_driver", "classid": 3},
    {"name": "monopolar_curved_scissors", "classid": 4},
    {"name": "ultrasound_probe", "classid": 5},
    {"name": "suction_instrument", "classid": 6},
    {"name": "clip_applier", "classid": 7},
]
LABEL_NAME2ID = {x["name"]: x["classid"] for x in LABELS}

SEQ_RELEASES = {
    **{str(s): "miccai_challenge_2018_release_1" for s in (1, 2, 3, 4)},
    **{str(s): "miccai_challenge_release_2" for s in (5, 6, 7)},
    **{str(s): "miccai_challenge_release_3" for s in (9, 10, 11, 12)},
    **{str(s): "miccai_challenge_release_4" for s in (13, 14, 15, 16)},
}


def rgb2id(color: np.ndarray) -> np.ndarray:
    c = color.astype(np.int32)
    return c[:, :, 0] + 256 * c[:, :, 1] + 256 * 256 * c[:, :, 2]


def _colour_ids(mapping_path: str) -> dict:
    color2id = {}
    if os.path.exists(mapping_path):
        with open(mapping_path) as f:
            for item in json.load(f):
                name = item.get("name", "").lower().replace(" ", "_")
                if name in LABEL_NAME2ID:
                    col = item["color"]
                    color2id[col[0] + 256 * col[1] + 256 * 256 * col[2]] = LABEL_NAME2ID[name]
    return color2id


def process(root_dir: str, data_file: str = "index.json"):
    entries = []
    for seq, release in SEQ_RELEASES.items():
        labels_dir = os.path.join(root_dir, "train_val", release, f"seq_{seq}", "labels")
        if not os.path.isdir(labels_dir):
            continue
        color2id = _colour_ids(os.path.join(os.path.dirname(labels_dir), "labels.json"))
        out_dir = os.path.join(root_dir, "train", f"seq_{seq}", "labels")
        for f_ in sorted(os.listdir(labels_dir)):
            ids = rgb2id(read_image(os.path.join(labels_dir, f_)))
            mask = np.zeros(ids.shape, np.uint8)
            for packed, cid in color2id.items():
                mask[ids == packed] = cid
            out = os.path.join(out_dir, f_)
            write_mask(out, mask)
            entries.append({"mask_path": out, "seq": seq})
    write_index(os.path.join(root_dir, data_file), entries)
    return entries


if __name__ == "__main__":
    process(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "index.json")
