"""EndoVis 2018, CholecSeg8k and AutoLaparo from a raw tree in each release's
layout, through the port's converter, into both packages' `train_multi_class`
run up to its training loader (`--dataset <name> --num_labels C --num_classes
C`): both read the same files and the same labels, every label in [0, C).
AutoLaparo's split names are read as the JAX reader reads them. Also the
port's own repair: a run whose training or validation labels exceed
`--num_classes` stops with a message before the card sees the batch."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import adaptersis_tpu.data as jax_data
import adaptersis_tpu.train as jax_train
from adaptersis_tpu.data.datasets import DATASETS as JAX_DATASETS
from adaptersis_tpu_torch import evaluate, train_multi_class, train_seg
from adaptersis_tpu_torch.data.datasets import DATASETS
from adaptersis_tpu_torch.data.process import autolaparo, cholec8k, endovis2018
from adaptersis_tpu_torch.models.decoders import LogitConv
from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = {"endovis2018": 8, "cholecseg8k": 13, "autolaparo": 10}
EV18_COLOURS = {"bipolar forceps": [0, 255, 0], "clip applier": [0, 0, 255],
                "kidney": [255, 0, 0]}       # the kidney maps to the background
CHOLEC_GRAY = [50, 11, 21, 13, 12, 31, 23, 24, 25, 32, 22, 33, 5]
AUTOLAPARO_GRAY = [0, 180, 20, 40, 60, 80, 100, 120, 140, 160]
TRAIN, VAL = 4, 2


def _save(path, a, mode=None, **kw):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a, mode).save(path, **kw)


def _frame(rng):
    return rng.integers(0, 256, (30, 44, 3)).astype(np.uint8)


def _ids(rng, classes):
    """Label ids over the frame, the highest class among them."""
    ids = rng.integers(0, classes, (30, 44)).astype(np.uint8)
    ids[0, 0] = classes - 1
    return ids


def converted_tree(root, name, rng, splits=("training", "validation")):
    """A raw tree of `name` in its release's layout, converted by the port's
    converter; returns the root the readers take. EndoVis 2018's converter
    writes each training sequence's labels under train/seq_N/labels:
    the sequence's left_frames go beside them, and the held-out sequence
    (3) under test/seq_1. AutoLaparo's runs once per split, under the
    names `splits`."""
    raw = root / "raw"
    if name == "endovis2018":
        release = raw / "train_val" / "miccai_challenge_2018_release_1"
        table = np.asarray([[0, 0, 0], *EV18_COLOURS.values()], np.uint8)
        for k in range(TRAIN + VAL):
            seq = release / f"seq_{1 + k // (TRAIN // 2) if k < TRAIN else 3}"
            _save(seq / "left_frames" / f"frame{k:03d}.png", _frame(rng))
            _save(seq / "labels" / f"frame{k:03d}.png", table[rng.integers(0, 4, (30, 44))])
            (seq / "labels.json").write_text(json.dumps(
                [{"name": n, "color": c} for n, c in EV18_COLOURS.items()]))
        endovis2018.process(str(raw))
        for seq in (1, 2, 3):
            os.symlink(release / f"seq_{seq}" / "left_frames",
                       raw / "train" / f"seq_{seq}" / "left_frames")
        (raw / "test").mkdir()
        os.rename(raw / "train" / "seq_3", raw / "test" / "seq_1")
        return raw
    out = root / "converted"
    if name == "cholecseg8k":
        gray = np.asarray(CHOLEC_GRAY, np.uint8)
        for k, video in enumerate(["video01"] * TRAIN + ["video12"] * VAL):
            d = raw / video / f"{video}_{80 * (k + 1):05d}"
            _save(d / f"frame_{80 * (k + 1)}_endo.png", _frame(rng))
            _save(d / f"frame_{80 * (k + 1)}_endo_watershed_mask.png",
                  np.repeat(gray[_ids(rng, 13)][..., None], 3, -1))
        cholec8k.process(str(raw), str(out))
        return out
    gray = np.asarray(AUTOLAPARO_GRAY, np.uint8)
    for split, n in zip(splits, (TRAIN, VAL)):
        for k in range(n):
            _save(raw / "autolaparo" / "imgs" / split / f"{k:05d}.jpg", _frame(rng), quality=90)
            _save(raw / "autolaparo" / "masks" / split / f"{k:05d}.png",
                  gray[_ids(rng, 10)], "L")
        autolaparo.process(str(raw), str(out), data_type=split)
    return out


class _AtTheLoader(Exception):
    """Raised by a stand-in DataLoader: the trainer has built its sets."""


def _flags(name, root, out):
    C = str(CLASSES[name])
    return ["--arch", "vit_test", "--patch_size", "14", "--imsize", "28", "--dataset", name,
            "--num_labels", C, "--num_classes", C, "--data_path", str(root),
            "--batch_size_per_gpu", "2", "--output_dir", str(out)]


def _training_sets(flags, monkeypatch):
    """The training set each package's `train_multi_class` builds from
    `flags`, and the classes of its model."""
    got = {}

    def loader(side):
        def first_set(dataset, **kw):
            got.setdefault(side, dataset)     # the first loader a trainer makes
            raise _AtTheLoader
        return first_set

    def jax_trainer(model, cfg, **kw):
        got["jax classes"] = model.num_classes
        return object()

    def port_trainer(model, **kw):
        got["port model"] = model
        return object()

    monkeypatch.setattr(jax_train, "Trainer", jax_trainer)
    monkeypatch.setattr(jax_data, "DataLoader", loader("jax"))
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(sys, "argv", ["train_multi_class.py", "--platform", "cpu"] + flags)
    with pytest.raises(_AtTheLoader):
        runpy.run_path(os.path.join(REPO, "train_multi_class.py"), run_name="__main__")
    monkeypatch.setattr(train_seg, "Trainer", port_trainer)
    monkeypatch.setattr(train_seg, "DataLoader", loader("port"))
    with pytest.raises(_AtTheLoader):
        train_multi_class.main(flags + ["--device", "cpu"])
    return got


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_converted_tree_trains_on_the_same_labels_in_both_packages(tmp_path, monkeypatch, name):
    root = converted_tree(tmp_path, name, np.random.default_rng(len(name)))
    got = _training_sets(_flags(name, root, tmp_path / "out"), monkeypatch)
    mine, ref, C = got["port"], got["jax"], CLASSES[name]
    assert type(mine).__name__ == type(ref).__name__
    assert mine.img_files == ref.img_files and mine.mask_files == ref.mask_files
    assert len(mine) == TRAIN
    labels = set()
    for i in range(TRAIN):
        a, b = mine[i], ref[i]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        labels.update(np.unique(a[1]).tolist())
    assert labels <= set(range(C)) and C - 1 in labels
    assert got["jax classes"] == C
    assert [m.out_channels for m in got["port model"].modules()
            if isinstance(m, LogitConv)] == [C]
    val = DATASETS[name](str(root), "validation", imsize=28)
    assert len(val) == VAL == len(JAX_DATASETS[name](str(root), "validation", imsize=28))


def test_autolaparo_reads_the_split_names_the_converter_wrote_as_the_jax_reader(tmp_path):
    """A tree converted with DATA_TYPE train and val: both readers find its
    frames under those names and none under the trainers' "training" and
    "validation" (the JAX package's quirk; the recipe converts with
    DATA_TYPE training and validation)."""
    root = converted_tree(tmp_path, "autolaparo", np.random.default_rng(5), ("train", "val"))
    for split, name, n in (("training", "train", TRAIN), ("validation", "val", VAL)):
        mine = DATASETS["autolaparo"](str(root), name, imsize=28)
        assert len(mine) == n
        assert mine.mask_files == JAX_DATASETS["autolaparo"](str(root), name).mask_files
        assert len(DATASETS["autolaparo"](str(root), split)) == 0
        assert len(JAX_DATASETS["autolaparo"](str(root), split)) == 0


def test_validation_labels_beyond_the_classes_stop_before_a_forward(tmp_path):
    """The validation and cross-test metrics check each batch's labels on
    the host before the model sees it: CholecSeg8k's 13 classes against 8
    stop with the message, against 13 every batch is stepped."""
    root = converted_tree(tmp_path, "cholecseg8k", np.random.default_rng(9))
    loader = evaluate.val_loader(DATASETS["cholecseg8k"](str(root), "validation", imsize=28),
                                 2, 0, False)
    steps = []

    def step(imgs, masks, valid):
        steps.append(imgs.shape[0])
        return {"acc1": torch.zeros(())}

    with pytest.raises(SystemExit, match=r"labels in \[0, 12\], outside \[0, 8\)"):
        evaluate.sharded_metrics(step, loader, torch.device("cpu"), 8)
    assert not steps
    evaluate.sharded_metrics(step, loader, torch.device("cpu"), 13)
    assert sum(steps) == VAL


def test_labels_beyond_the_classes_stop_the_run_before_a_step(tmp_path):
    """CholecSeg8k's 13 classes under train_multi_class's default 8: the
    host's check stops the run with a message before the first step (on
    the card the loss would stop the process at a device-side assert)."""
    root = converted_tree(tmp_path, "cholecseg8k", np.random.default_rng(7))
    flags = [f for f in _flags("cholecseg8k", root, tmp_path / "out")]
    for flag in ("--num_labels", "--num_classes"):
        i = flags.index(flag)
        del flags[i:i + 2]
    steps = []
    plain = train_seg.Trainer.train_step
    try:
        train_seg.Trainer.train_step = lambda *a, **kw: steps.append(1)
        with pytest.raises(SystemExit, match=r"labels in \[0, 12\], outside \[0, 8\)"):
            train_multi_class.main(flags + ["--device", "cpu", "--epochs", "1"])
    finally:
        train_seg.Trainer.train_step = plain
    assert not steps
    evaluate.check_labels(np.asarray([[0, 7]]), 8)
    with pytest.raises(SystemExit, match="outside"):
        evaluate.check_labels(np.asarray([[-1, 0]]), 8)
