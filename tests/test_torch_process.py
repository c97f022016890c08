"""The port's offline dataset converters (`adaptersis_tpu_torch/data/process/`)
against the JAX package's on tiny raw trees in each release's layout: the
output trees hold the same files with the same bytes, and the JSON indexes
the same entries (their paths taken relative to each tree). Also each
converter's command line, and the port's reader on the converted tree."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import adaptersis_tpu.data.process.autolaparo as jax_autolaparo
import adaptersis_tpu.data.process.cholec8k as jax_cholec8k
import adaptersis_tpu.data.process.endovis2017 as jax_endovis2017
import adaptersis_tpu.data.process.endovis2018 as jax_endovis2018
import adaptersis_tpu.data.process.robustmis2019 as jax_robustmis2019
from adaptersis_tpu_torch.data.datasets import Robomis
from adaptersis_tpu_torch.data.process import (autolaparo, cholec8k, endovis2017, endovis2018,
                                               robustmis2019)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save(path, a, mode=None, **kw):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a, mode).save(path, **kw)


def _frame(rng):
    return rng.integers(0, 256, (18, 26, 3)).astype(np.uint8)


def raw_tree(root, name, rng):
    if name == "robustmis2019":
        for split in ("Training", "Testing"):
            for proc, i in (("Proctocolectomy/1", 10), ("Sigmoid/4", 20)):
                _save(root / split / proc / f"{i}_img.png", _frame(rng))
                _save(root / split / proc / f"{i}_label.png",
                      rng.integers(0, 4, (18, 26)).astype(np.uint8), "L")
    elif name == "endovis2017":
        for i in (1, 3):
            base = root / "train" / f"instrument_dataset_{i}"
            _save(base / "images" / "frame000.jpg", _frame(rng), quality=90)
            ids = rng.integers(0, 8, (18, 26)).astype(np.uint8)
            _save(base / "binary_masks_raw" / "frame000.png", (ids > 0).astype(np.uint8) * 255,
                  "L")
            _save(base / "ground_truth" / "instruments_masks" / "frame000.png", ids * 32, "L")
            _save(base / "ground_truth" / "parts_masks" / "frame000.png",
                  np.minimum(ids, 3) * 85, "L")
    elif name == "endovis2018":
        seq = root / "train_val" / "miccai_challenge_2018_release_1" / "seq_2"
        colours = {"bipolar_forceps": [0, 255, 0], "clip_applier": [0, 0, 255],
                   "kidney": [255, 0, 0]}
        (seq / "labels").mkdir(parents=True)
        (seq / "labels.json").write_text(json.dumps(
            [{"name": k.replace("_", " "), "color": v} for k, v in colours.items()]))
        for f in ("frame000.png", "frame001.png"):
            pick = rng.integers(0, 4, (18, 26))
            table = np.asarray([[0, 0, 0]] + list(colours.values()), np.uint8)
            _save(seq / "labels" / f, table[pick])
    elif name == "cholec8k":
        for video in ("video01", "video12"):
            d = root / video / f"{video}_00080"
            _save(d / "frame_80_endo.png", _frame(rng))
            levels = np.asarray([50, 11, 21, 31, 5, 33], np.uint8)
            _save(d / "frame_80_endo_watershed_mask.png",
                  levels[rng.integers(0, 6, (18, 26))], "L")
    elif name == "autolaparo":
        for i in range(2):
            _save(root / "autolaparo" / "imgs" / "train" / f"{i:05d}.jpg", _frame(rng),
                  quality=90)
            levels = np.asarray([0, 180, 20, 40, 160, 99], np.uint8)
            _save(root / "autolaparo" / "masks" / "train" / f"{i:05d}.png",
                  levels[rng.integers(0, 6, (18, 26))], "L")
    return root


# (port, JAX, where it writes: "out" a new tree, else in place under that
# part of the raw tree)
CONVERTERS = {
    "robustmis2019": (robustmis2019, jax_robustmis2019, "out"),
    "endovis2017": (endovis2017, jax_endovis2017, "train"),
    "endovis2018": (endovis2018, jax_endovis2018, "."),
    "cholec8k": (cholec8k, jax_cholec8k, "out"),
    "autolaparo": (autolaparo, jax_autolaparo, "out"),
}


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json") and f != "labels.json":
                text = open(path).read().replace(str(root) + os.sep, "")
                out[rel] = json.loads(text)
            else:
                out[rel] = open(path, "rb").read()
    return out


def _run(mod, raw, out, where, **kw):
    if where == "out":
        return mod.process(str(raw), str(out), **kw)
    shutil.copytree(raw, out)
    return mod.process(str(out / where), **kw)


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_output_equals_the_jax_converters(tmp_path, name):
    mine, ref, where = CONVERTERS[name]
    raw = raw_tree(tmp_path / "raw", name, np.random.default_rng(len(name)))
    kws = [{"data_type": "train"}, {"data_type": "test"}] if name == "robustmis2019" else [{}]
    for kw in kws:
        tag = kw.get("data_type", "")
        a = _run(mine, raw, tmp_path / f"port{tag}", where, **kw)
        b = _run(ref, raw, tmp_path / f"jax{tag}", where, **kw)
        assert len(a) == len(b) > 0
        ta, tb = _tree(tmp_path / f"port{tag}"), _tree(tmp_path / f"jax{tag}")
        assert set(ta) == set(tb)
        for k in ta:
            assert ta[k] == tb[k], k


def test_converted_robustmis_tree_reads_back(tmp_path):
    raw = raw_tree(tmp_path / "raw", "robustmis2019", np.random.default_rng(1))
    robustmis2019.process(str(raw), str(tmp_path / "out"), data_type="train")
    ds = Robomis(str(tmp_path / "out"), "training")
    assert len(ds) == 2
    img, mask, _ = ds[0]
    label = np.asarray(Image.open(raw / "Training" / "Proctocolectomy" / "1" / "10_label.png"))
    np.testing.assert_array_equal(mask, (label > 0).astype(np.int32))
    assert img.shape == (18, 26, 3)


def test_converters_run_as_modules(tmp_path):
    raw = raw_tree(tmp_path / "raw", "cholec8k", np.random.default_rng(2))
    res = subprocess.run([sys.executable, "-m", "adaptersis_tpu_torch.data.process.cholec8k",
                          str(raw), str(tmp_path / "out")], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(json.loads((tmp_path / "out" / "index.json").read_text())) == 2
