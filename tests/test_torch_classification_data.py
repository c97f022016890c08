"""The port's classification data (`data/imagenet.py`, `imagenet22k.py`,
`loaders.py`, `samplers.InfiniteSampler`) against the JAX package's, item
for item, on trees built under `tmp_path` as the JAX package's own tests
build them: an image-folder tree (its `_entries_<split>.npy` cache, then a
reopen from it), DINOv2's prepared ImageNet layout (`dump_extra` on both
sides, the same caches, every item), per-class ImageNet-22k tarballs with
their blocks logs (a gzipped member, the known-corrupt one dropped), the
dataset specs of `make_dataset`, and the samplers' indices, bit-equal
across ranks and `advance`."""

import gzip
import io
import itertools
import os

import numpy as np
import pytest
from PIL import Image

from adaptersis_tpu.data import imagenet as jin
from adaptersis_tpu.data import imagenet22k as j22
from adaptersis_tpu.data import loaders as jl
from adaptersis_tpu.data import samplers as js
from adaptersis_tpu_torch.data import imagenet as tin
from adaptersis_tpu_torch.data import imagenet22k as t22
from adaptersis_tpu_torch.data import loaders as tl
from adaptersis_tpu_torch.data import samplers as ts
from test_imagenet22k import _jpeg_bytes, _make_corpus

CLASSES = [("n01440764", "tench"), ("n01443537", "goldfish"),
           ("n01484850", "great white shark")]


def same_items(a, b, n_items):
    assert len(a) == len(b) == n_items
    for i in range(n_items):
        (ia, ya, xa), (ib, yb, xb) = a[i], b[i]
        assert ia.dtype == ib.dtype == np.uint8 and ia.shape == ib.shape
        np.testing.assert_array_equal(ia, ib)
        assert (ya, xa) == (yb, xb)


@pytest.fixture
def folder_tree(tmp_path):
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 2)):
        for c in ("cat", "dog"):
            d = tmp_path / split / c
            d.mkdir(parents=True)
            for j in range(n):
                Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8)).save(
                    d / f"{j}.png")
            (d / "notes.txt").write_text("not an image")
    return tmp_path


@pytest.mark.parametrize("imsize", [None, 16])
def test_image_folder(folder_tree, imsize):
    ours = tin.ImageFolderDataset(str(folder_tree), "train", imsize=imsize)
    assert os.path.exists(folder_tree / "_entries_train.npy")
    theirs = jin.ImageFolderDataset(str(folder_tree), "train", imsize=imsize)   # from the cache
    reopened = tin.ImageFolderDataset(str(folder_tree), "train", imsize=imsize)
    assert ours.classes == theirs.classes == reopened.classes == ["cat", "dog"]
    same_items(ours, theirs, 6)
    same_items(reopened, theirs, 6)
    assert [ours.get_target(i) for i in range(6)] == [0, 0, 0, 1, 1, 1]


@pytest.fixture
def prepared_tree(tmp_path):
    """DINOv2's prepared layout, as tests/test_imagenet_ref_layout.py builds it."""
    rng = np.random.default_rng(0)
    root = tmp_path / "imagenet"
    root.mkdir()
    (root / "labels.txt").write_text("".join(f"{cid},{name}\n" for cid, name in CLASSES))
    for ci, (cid, _) in enumerate(CLASSES):
        d = root / "train" / cid
        d.mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.integers(0, 256, (24, 24, 3), np.uint8)).save(
                d / f"{cid}_{ci * 10 + j}.JPEG")
    for k, (cid, _) in enumerate(CLASSES[:2], start=1):
        d = root / "val" / cid
        d.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), np.uint8)).save(
            d / f"ILSVRC2012_val_{k:08d}.JPEG")
    return str(root), tmp_path


@pytest.mark.parametrize("split, n_items", [("TRAIN", 6), ("VAL", 2)])
def test_prepared_imagenet(prepared_tree, split, n_items):
    root, tmp = prepared_tree
    extras = {}
    for name, mod in (("ours", tin), ("theirs", jin)):
        extras[name] = str(tmp / f"extra_{name}")
        mod.ImageNet(split=mod.ImageNetSplit[split], root=root, extra=extras[name]).dump_extra()
    for f in sorted(os.listdir(extras["theirs"])):
        a, b = (np.load(os.path.join(extras[k], f)) for k in ("ours", "theirs"))
        assert a.dtype == b.dtype and a.tolist() == b.tolist(), f
    ours = tin.ImageNet(split=tin.ImageNetSplit[split], root=root, extra=extras["ours"],
                        imsize=16)
    theirs = jin.ImageNet(split=jin.ImageNetSplit[split], root=root, extra=extras["theirs"],
                          imsize=16)
    same_items(ours, theirs, n_items)
    for i in range(n_items):
        assert ours.get_image_relpath(i) == theirs.get_image_relpath(i)
        assert ours.get_image_data(i) == theirs.get_image_data(i)
        assert (ours.get_class_id(i), ours.get_class_name(i)) == \
            (theirs.get_class_id(i), theirs.get_class_name(i))
    assert ours.get_targets().tolist() == theirs.get_targets().tolist()
    assert [ours.find_class_name(c) for c in range(len(set(ours.get_targets())))] == \
        [theirs.find_class_name(c) for c in range(len(set(theirs.get_targets())))]


def test_split_scheme():
    for s in ("TRAIN", "VAL", "TEST"):
        a, b = tin.ImageNetSplit[s], jin.ImageNetSplit[s]
        assert (a.length, a.get_dirname("n1"), a.get_image_relpath(7, "n123")) == \
            (b.length, b.get_dirname("n1"), b.get_image_relpath(7, "n123"))
    assert tin.ImageNetSplit.TRAIN.parse_image_relpath("train/n123/n123_7.JPEG") == ("n123", 7)


def test_imagenet22k(tmp_path):
    jp = {f"s{i}": _jpeg_bytes(i) for i in range(5)}
    _make_corpus(str(tmp_path / "in22k"), {
        "n001": [("n001_0.JPEG", jp["s0"]), ("n001_1.JPEG", jp["s1"])],
        "n002": [("n002_0.JPEG", jp["s2"]), ("n002_1.JPEG", gzip.compress(jp["s3"])),
                 ("n06470073_47249.JPEG", jp["s4"])]})
    root = str(tmp_path / "in22k")
    e_ours, i_ours = t22.build_cache(root, str(tmp_path / "extra_ours"))
    e_theirs, i_theirs = j22.build_cache(root, str(tmp_path / "extra_theirs"))
    assert e_ours.dtype == e_theirs.dtype and e_ours.tolist() == e_theirs.tolist()
    assert i_ours.tolist() == i_theirs.tolist() == ["n001", "n002"]
    for imsize in (None, 4):
        ours = t22.ImageNet22k(root, str(tmp_path / "extra_ours"), imsize=imsize)
        theirs = j22.ImageNet22k(root, str(tmp_path / "extra_theirs"), imsize=imsize)
        same_items(ours, theirs, 4)
        assert ours.get_targets().tolist() == theirs.get_targets().tolist() == [0, 0, 1, 1]
        assert [ours.get_image_data(i) for i in range(4)] == \
            [theirs.get_image_data(i) for i in range(4)]
    # gunzipped in place
    assert ours.get_image_data(3)[:len(jp["s3"])] == jp["s3"]
    # the default cache directory, built on first use
    assert len(t22.ImageNet22k(root)) == 4 and os.path.exists(tmp_path / "in22k" / "extra")
    with pytest.raises(RuntimeError, match="NULs"):
        (tmp_path / "bad").mkdir()
        (tmp_path / "bad" / "x.log").write_text("block 0: a.JPEG\n")
        t22._parse_blocks_log(str(tmp_path / "bad" / "x.log"))


def test_make_dataset_specs(prepared_tree, folder_tree):
    root, tmp = prepared_tree
    extra = str(tmp / "extra")
    tin.ImageNet(split=tin.ImageNetSplit.TRAIN, root=root, extra=extra).dump_extra()
    ds = tl.make_dataset(f"ImageNet:split=TRAIN:root={root}:extra={extra}", imsize=16)
    assert isinstance(ds, tin.ImageNet) and len(ds) == 6
    want = jl.make_dataset(f"ImageNet:split=TRAIN:root={root}:extra={extra}", imsize=16)
    same_items(ds, want, 6)
    ds = tl.make_dataset(f"ImageNet:split=TRAIN:root={root}", imsize=16, extra=extra)
    assert isinstance(ds, tin.ImageNet)
    for spec in ("imagefolder", "ImageNet", "imagenet22k"):
        ds = tl.make_dataset(f"{spec}:split=VAL:root={folder_tree}", imsize=8)
        assert isinstance(ds, tin.ImageFolderDataset) and ds.split == "val" and len(ds) == 4
        same_items(ds, jl.make_dataset(f"{spec}:split=VAL:root={folder_tree}", imsize=8), 4)
    robomis = tl.make_dataset(f"robomis:split=val:root={folder_tree}", imsize=8)
    assert type(robomis).__name__ == "Robomis" and len(robomis) == 0
    with pytest.raises(ValueError, match="unknown dataset spec"):
        tl.make_dataset("coco:root=/x")


def test_enumerated_targets_and_loader(folder_tree):
    ds = tl.DatasetWithEnumeratedTargets(tin.ImageFolderDataset(str(folder_tree), "val"))
    img, (index, target), idx = ds[3]
    assert (index, target, idx) == (3, 1, 3) and img.shape == (20, 24, 3) and len(ds) == 4
    loader = tl.make_data_loader(tin.ImageFolderDataset(str(folder_tree), "train"),
                                 batch_size=2, num_workers=2, shuffle=True, seed=3)
    want = jl.make_data_loader(jin.ImageFolderDataset(str(folder_tree), "train"),
                               batch_size=2, num_workers=2, shuffle=True, seed=3)
    got = [(i.copy(), y.copy(), x.copy()) for i, y, x in loader]
    assert len(got) == len(want) == 3
    for (a, b, c), (d, e, f) in zip(got, want):
        np.testing.assert_array_equal(a, d)
        np.testing.assert_array_equal(b, e)
        np.testing.assert_array_equal(c, f)


@pytest.mark.parametrize("kind", list(tl.SamplerType))
@pytest.mark.parametrize("shuffle", [True, False])
def test_samplers_bit_equal(kind, shuffle):
    """Each sampler type's indices, the port's against the JAX package's,
    for every rank of 3 over a size not divisible by 3, from the start and
    after `advance` (the infinite ones: their first 3 passes)."""
    assert [t.name for t in tl.SamplerType] == [t.name for t in jl.SamplerType]
    size = 17
    for rank, advance in itertools.product(range(3), (0, 5, 40)):
        kw = dict(shuffle=shuffle, seed=7, rank=rank, world_size=3, advance=advance)
        a = tl.make_sampler(kind, size, **kw)
        b = jl.make_sampler(jl.SamplerType[kind.name], size, **kw)
        assert type(a).__name__ == type(b).__name__
        n_take = len(b) if hasattr(b, "__len__") else 3 * size
        assert list(itertools.islice(a, n_take)) == list(itertools.islice(b, n_take))


def test_infinite_sampler_streams():
    """InfiniteSampler alone: the ranks' streams interleave into the
    one-rank stream, and advance skips advance // W of a rank's yields."""
    one = list(itertools.islice(ts.InfiniteSampler(11, seed=4), 66))
    ranks = [list(itertools.islice(ts.InfiniteSampler(11, seed=4, rank=r, world_size=2), 33))
             for r in range(2)]
    assert one[0::2] == ranks[0] and one[1::2] == ranks[1]
    assert sorted(one[:11]) == list(range(11)) and one[:11] != one[11:22]
    skipped = list(itertools.islice(ts.InfiniteSampler(11, seed=4, rank=1, world_size=2,
                                                       advance=6), 30))
    assert skipped == ranks[1][3:33]
    assert list(itertools.islice(js.InfiniteSampler(11, seed=4, rank=1, world_size=2,
                                                    advance=6), 30)) == skipped
