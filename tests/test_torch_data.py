"""The port's dataset readers and loader against the JAX package's, on tiny
trees in each of the five datasets' layouts written with PIL: every sample
(frame, mask, index) bit for bit, through the native decoder and through
PIL; EndoVis 2017's instrument labels (stored as id · 32), and the binary
labels both packages' `train_multi_class` trains its 8 classes on; a 16-bit mask,
which the native path refuses (both packages then read it with PIL); the
loader's batches for the same EpochSampler; a worker's error raised in the
consumer; and the port's PNG writer read back by PIL."""

import os
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

from adaptersis_tpu.data.datasets import DATASETS as JAX_DATASETS
from adaptersis_tpu.data.loader import DataLoader as JaxDataLoader
from adaptersis_tpu.data.samplers import EpochSampler as JaxEpochSampler
from adaptersis_tpu_torch.data import native
from adaptersis_tpu_torch.data.datasets import DATASETS, EndoVis2017, SyntheticSeg
from adaptersis_tpu_torch.data.loader import DataLoader
from adaptersis_tpu_torch.data.png_writer import write_png
from adaptersis_tpu_torch.data.samplers import EpochSampler

IMSIZE = 28


def _frame(rng, h=30, w=44):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def _save(path, a, mode=None, **kw):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a, mode).save(path, **kw)


def make_tree(root, name, rng):
    """Two training and two validation samples of dataset `name`, frames of
    30 × 44 (resized to 28²), masks of the layout's kind."""
    for split in ("training", "validation"):
        for i in range(2):
            ids = rng.integers(0, 8, (30, 44)).astype(np.uint8)
            if name == "robomis":
                _save(root / "images" / split / f"{i}.png", _frame(rng))
                _save(root / "annotations" / split / f"{i}.png", (ids > 3).astype(np.uint8) * 255,
                      "L")
            elif name == "endovis2017":
                d = root / ("train" if split == "training" else "test") / "instrument_dataset_2"
                _save(d / "images" / f"{i}.jpg", _frame(rng), quality=90)
                _save(d / "binary_masks" / f"{i}.jpg", (ids > 3).astype(np.uint8) * 255, "L")
                _save(d / "instruments_masks" / f"{i}.jpg", ids * 32, "L")
            elif name == "endovis2018":
                d = root / ("train" if split == "training" else "test") / "seq_3"
                _save(d / "left_frames" / f"{i}.png", _frame(rng))
                _save(d / "labels" / f"{i}.png", np.repeat(ids[..., None] * 30, 3, -1))
            elif name == "cholecseg8k":
                _save(root / "images" / split / f"{i}.png", _frame(rng))
                _save(root / "annotations" / split / f"{i}.png", ids, "L")
            elif name == "autolaparo":
                sub = "train" if split == "training" else "val"
                _save(root / "imgs" / sub / f"{i}.png", _frame(rng))
                pal = Image.fromarray(ids, "P")
                pal.putpalette([c for k in range(256) for c in (k, 255 - k, k // 2)])
                (root / "masks" / sub).mkdir(parents=True, exist_ok=True)
                pal.save(root / "masks" / sub / f"{i}.png")
    return root


SPLITS = {"autolaparo": ("train", "val")}


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", ["robomis", "endovis2017", "endovis2018", "cholecseg8k",
                                  "autolaparo"])
def test_samples_equal_the_jax_readers(tmp_path, name, use_native):
    root = make_tree(tmp_path, name, np.random.default_rng(len(name)))
    if use_native:
        assert native.available(), native.build_error
    for split in SPLITS.get(name, ("training", "validation")):
        for imsize in (IMSIZE, None):
            mine = DATASETS[name](str(root), split, imsize=imsize)
            ref = JAX_DATASETS[name](str(root), split, imsize=imsize)
            mine.use_native = ref.use_native = use_native
            assert len(mine) == len(ref) == 2
            assert mine.mask_files == ref.mask_files
            for i in range(2):
                got = mine[i]
                assert got[0].shape == ((imsize, imsize, 3) if imsize else (30, 44, 3))
                _same(got, ref[i])


def test_native_path_equals_pil_at_the_frame_size(tmp_path):
    """A Robust-MIS frame (960 × 540) read at 588 px: the port's native path
    gives the JAX package's PIL-path sample bit for bit. (The JAX package's
    native NEAREST takes (x + ½)·in/out in closed form, where PIL accumulates
    in/out pixel by pixel; they part on masks at this size.)"""
    rng = np.random.default_rng(9)
    _save(tmp_path / "images" / "training" / "0.png", _frame(rng, 540, 960))
    _save(tmp_path / "annotations" / "training" / "0.png",
          np.where(rng.uniform(size=(540, 960)) < 0.3, 255, 0).astype(np.uint8), "L")
    mine = DATASETS["robomis"](str(tmp_path), "training", imsize=588)
    ref = JAX_DATASETS["robomis"](str(tmp_path), "training", imsize=588)
    ref.use_native = False
    assert native.available(), native.build_error
    _same(mine[0], ref[0])


def test_endovis2017_instrument_labels(tmp_path):
    root = make_tree(tmp_path, "endovis2017", np.random.default_rng(1))
    for use_native in (True, False):
        ds = EndoVis2017(str(root), "training", imsize=None, problem_type="instruments")
        ref = JAX_DATASETS["endovis2017"](str(root), "training", imsize=None,
                                          problem_type="instruments")
        ds.use_native = ref.use_native = use_native
        with open(ds.mask_files[0], "rb") as f:
            stored = np.asarray(Image.open(f))
        _, mask, _ = ds[0]
        np.testing.assert_array_equal(mask, stored // 32)
        assert mask.max() <= 7
        _same(ds[0], ref[0])


class _AtTheLoader(Exception):
    """Raised by a stand-in DataLoader: the trainer has built its sets."""


def test_train_multi_class_trains_on_binary_masks_in_both_packages(tmp_path, monkeypatch):
    """Under `train_multi_class`'s defaults (8 classes, --dataset
    endovis2017) both packages' trainers build EndoVis 2017's training set
    with the reader's default problem type, "binary": the same labels read
    from binary_masks/, all in {0, 1}, while the head has 8 outputs. Each
    trainer runs up to its training loader."""
    import adaptersis_tpu.data as jax_data
    import adaptersis_tpu.models as jax_models
    from adaptersis_tpu_torch import train_multi_class, train_seg
    from adaptersis_tpu_torch.models.decoders import LogitConv

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = make_tree(tmp_path / "endovis2017", "endovis2017", np.random.default_rng(3))
    flags = ["--arch", "vit_test", "--patch_size", "14", "--imsize", str(IMSIZE),
             "--data_path", str(root), "--batch_size_per_gpu", "2",
             "--output_dir", str(tmp_path / "out")]
    got = {}

    def loader(side):
        def first_set(dataset, **kw):
            got[side] = dataset            # the first loader a trainer makes: training
            raise _AtTheLoader
        return first_set

    def recorded(side, build):
        def wrap(*a, **kw):
            got[side] = build(*a, **kw)
            return got[side]
        return wrap

    monkeypatch.setattr(jax_data, "DataLoader", loader("jax"))
    monkeypatch.setattr(jax_models, "AdapterSegmentor",
                        recorded("jax model", jax_models.AdapterSegmentor))
    monkeypatch.syspath_prepend(repo)
    monkeypatch.setattr(sys, "argv", ["train_multi_class.py", "--platform", "cpu"] + flags)
    with pytest.raises(_AtTheLoader):
        runpy.run_path(os.path.join(repo, "train_multi_class.py"), run_name="__main__")
    monkeypatch.setattr(train_seg, "DataLoader", loader("port"))
    monkeypatch.setattr(train_seg, "build_model", recorded("port model", train_seg.build_model))
    with pytest.raises(_AtTheLoader):
        train_multi_class.main(flags + ["--device", "cpu"])

    mine, ref = got["port"], got["jax"]
    assert isinstance(mine, EndoVis2017) and mine.problem_type == ref.problem_type == "binary"
    assert mine.mask_files == ref.mask_files and len(mine) == 2
    assert {os.path.basename(os.path.dirname(f)) for f in mine.mask_files} == {"binary_masks"}
    labels = set()
    for i in range(len(mine)):
        _same(mine[i], ref[i])
        labels.update(np.unique(mine[i][1]).tolist())
    assert labels == {0, 1}
    assert got["jax model"].num_classes == 8
    assert [m.out_channels for m in got["port model"].modules()
            if isinstance(m, LogitConv)] == [8]


def test_a_16_bit_mask_goes_through_pil(tmp_path):
    root = make_tree(tmp_path, "cholecseg8k", np.random.default_rng(2))
    path = root / "annotations" / "training" / "0.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 13, (30, 44)).astype(np.uint16),
                    "I;16").save(path)
    assert native.load_image(str(path), (IMSIZE, IMSIZE), "gray", "nearest") is None
    ds = DATASETS["cholecseg8k"](str(root), "training", imsize=IMSIZE)
    ref = JAX_DATASETS["cholecseg8k"](str(root), "training", imsize=IMSIZE)
    _same(ds[0], ref[0])
    ref.use_native = False
    _same(ds[0], ref[0])


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_the_jax_loader(tmp_path, drop_last):
    root = make_tree(tmp_path, "robomis", np.random.default_rng(4))
    for i in range(2, 7):      # 7 training frames: a short last batch
        _save(root / "images" / "training" / f"{i}.png", _frame(np.random.default_rng(i)))
        _save(root / "annotations" / "training" / f"{i}.png",
              np.full((30, 44), 255 * (i % 2), np.uint8), "L")
    mine = DATASETS["robomis"](str(root), "training", imsize=IMSIZE)
    ref = JAX_DATASETS["robomis"](str(root), "training", imsize=IMSIZE)
    for epoch in (0, 3):
        s, r = EpochSampler(len(mine), seed=5), JaxEpochSampler(len(ref), seed=5)
        s.set_epoch(epoch)
        r.set_epoch(epoch)
        got = list(DataLoader(mine, sampler=s, batch_size=3, num_workers=3, drop_last=drop_last))
        want = list(JaxDataLoader(ref, sampler=r, batch_size=3, num_workers=2,
                                  drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for a, b in zip(got, want):
            _same(a, b)
            assert a[0].dtype == np.uint8 and a[1].dtype == np.int32 and a[2].dtype == np.int32


def test_a_worker_error_is_raised_in_the_consumer():
    class Broken(SyntheticSeg):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("truncated file 5")
            return super().__getitem__(i)

    loader = DataLoader(Broken(n=8, imsize=IMSIZE), batch_size=2, num_workers=2)
    seen = []
    with pytest.raises(OSError, match="truncated file 5"):
        for batch in loader:
            seen.append(batch[2].tolist())
    assert seen == [[0, 1], [2, 3]]


@pytest.mark.parametrize("shape", [(30, 44), (17, 5, 3), (540, 960, 3)])
def test_png_writer_reads_back_through_pil(tmp_path, shape):
    a = np.random.default_rng(6).integers(0, 256, shape).astype(np.uint8)
    write_png(tmp_path / "a.png", a)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), a)
    if len(shape) == 3:
        got = native.load_image(str(tmp_path / "a.png"), shape[:2], "rgb")
        np.testing.assert_array_equal(got, a)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", a.astype(np.uint16))
