"""Checkpoint and resume in the port, on the CPU. `train_seg` on a tiny
Robust-MIS tree (PNG frames of 96 × 72 read at 56 px) with a seeded DINOv2
`.pth` backbone: two epochs in one run against one epoch, a preemption
(`ASN_STOP_AFTER_EPOCHS`) and a resume end with the same checkpoint, the
same variables and the same `log.txt`, bit for bit, and `--evaluate` on it
gives the logged acc1. `pretrain` preempted (`ASN_PREEMPT_AT`) and resumed
from its `last_checkpoint` ends as the run that never stopped, bit for bit.
`PeriodicCheckpointer` keeps the newest saves, writes the tag and
`model_final`; a save killed mid-write leaves the previous checkpoint."""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from adaptersis_tpu_torch import pretrain, train_seg
from adaptersis_tpu_torch.train import checkpoint as ckpt
from adaptersis_tpu_torch.train.checkpoint import (PeriodicCheckpointer, restore_checkpoint,
                                                   save_checkpoint)
from torch_parity import dinov2_state_dict

TINY_VIT = dict(img_size=518, patch_size=14, embed_dim=64, depth=5, num_heads=4)


@pytest.fixture(scope="module")
def robomis(tmp_path_factory):
    """A Robust-MIS tree of 6 training and 2 validation frames, and a seeded
    vit_test `.pth` under "teacher" with DINOv2's prefixes."""
    root = tmp_path_factory.mktemp("robomis")
    rng = np.random.default_rng(0)
    for split, n in (("training", 6), ("validation", 2)):
        for sub in ("images", "annotations"):
            (root / sub / split).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (72, 96, 3)).astype(np.uint8)).save(
                root / "images" / split / f"{i:03d}.png")
            blob = np.zeros((72, 96), np.uint8)
            y, x = rng.integers(10, 60), rng.integers(10, 80)
            blob[y - 10:y + 10, x - 12:x + 12] = 255
            Image.fromarray(blob, "L").save(root / "annotations" / split / f"{i:03d}.png")
    sd = dinov2_state_dict(TINY_VIT, 1)
    torch.save({"teacher": {f"module.backbone.{k}": v for k, v in sd.items()}},
               root / "dinov2.pth")
    return root


def _argv(root, out):
    return ["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
            "--batch_size_per_gpu", "2", "--epochs", "2", "--device", "cpu",
            "--dataset", "robomis", "--data_path", str(root), "--num_workers", "2",
            "--pretrained_weights", str(root / "dinov2.pth"), "--output_dir", str(out)]


def test_train_seg_resumes_bit_identically(robomis, tmp_path, monkeypatch):
    full = train_seg.main(_argv(robomis, tmp_path / "full"))
    assert [h["epoch"] for h in full] == [0, 1]
    assert all(h["train_losses_finite"] and len(h["train_losses"]) == 3 for h in full)
    assert {h["decoder"] for h in full} <= {"native", "pil"}
    monkeypatch.setenv("ASN_STOP_AFTER_EPOCHS", "1")
    first = train_seg.main(_argv(robomis, tmp_path / "resumed"))
    assert [h["epoch"] for h in first] == [0]
    assert not (tmp_path / "resumed" / "variables.npz").exists()
    monkeypatch.delenv("ASN_STOP_AFTER_EPOCHS")
    second = train_seg.main(_argv(robomis, tmp_path / "resumed"))
    assert [h["epoch"] for h in second] == [1]
    assert second[0]["train_losses"] == full[1]["train_losses"]
    a = restore_checkpoint(tmp_path / "full")
    b = restore_checkpoint(tmp_path / "resumed")
    assert a["epoch"] == b["epoch"] == 2 and a["best_acc"] == b["best_acc"]
    assert set(a["model"]) == set(b["model"]) and not any(k.startswith("backbone.")
                                                          for k in a["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    moms = [(s["momentum_buffer"], t["momentum_buffer"])
            for s, t in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values())]
    assert moms and all(torch.equal(x, y) for x, y in moms)
    assert filecmp.cmp(tmp_path / "full" / "log.txt", tmp_path / "resumed" / "log.txt",
                       shallow=False)
    with np.load(tmp_path / "full" / "variables.npz") as f, \
            np.load(tmp_path / "resumed" / "variables.npz") as g:
        assert set(f) == set(g)
        for k in f:
            np.testing.assert_array_equal(f[k], g[k], err_msg=k)
    # the backbone is the .pth's, unchanged by training
    sd = dinov2_state_dict(TINY_VIT, 1)
    with np.load(tmp_path / "full" / "variables.npz") as f:
        np.testing.assert_array_equal(f["params/backbone/pos_embed"], sd["pos_embed"].numpy())
    # a finished run started again trains nothing more
    assert train_seg.main(_argv(robomis, tmp_path / "full")) == []
    # --evaluate validates the checkpoint: the last logged acc1
    ev = train_seg.main(_argv(robomis, tmp_path / "full") + ["--evaluate"])
    assert ev[0]["epoch"] == 2 and ev[0]["test_acc1"] == full[-1]["test_acc1"]


def test_pretrain_resumes_bit_identically(tmp_path, monkeypatch):
    argv = ["--device", "cpu", "--arch", "vit_test", "--global_crops_size", "28",
            "--local_crops_size", "14", "--local_crops_number", "2", "--batch_size_per_gpu", "2",
            "--dino_out_dim", "64", "--epochs", "2", "--steps_per_epoch", "2",
            "--warmup_epochs", "0", "--synthetic", "--saveckp_freq", "1"]
    parse = pretrain.get_args_parser().parse_args
    full, hist = pretrain.run(parse(argv + ["--output_dir", str(tmp_path / "full")]))
    assert [h["epoch"] for h in hist] == [0, 1]
    monkeypatch.setenv("ASN_PREEMPT_AT", "3")
    cut, _ = pretrain.run(parse(argv + ["--output_dir", str(tmp_path / "resumed")]))
    assert cut.step == 3
    assert (tmp_path / "resumed" / "last_checkpoint").read_text() == "model_0000001"
    monkeypatch.delenv("ASN_PREEMPT_AT")
    resumed, hist = pretrain.run(parse(argv + ["--output_dir", str(tmp_path / "resumed")]))
    assert [h["epoch"] for h in hist] == [1]
    a, b = full.checkpoint_state(), resumed.checkpoint_state()
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["mu"] + a["nu"], b["mu"] + b["nu"]):
        assert torch.equal(x, y)
    for d in ("full", "resumed"):
        assert (tmp_path / d / "last_checkpoint").read_text() == "model_final"
        final = restore_checkpoint(tmp_path / d, "model_final")
        assert final["iteration"] == 4
    final = restore_checkpoint(tmp_path / "full", "model_final")
    for k, v in a["model"].items():
        assert torch.equal(final["model"][k], v), k


def test_periodic_checkpointer_retention(tmp_path):
    pc = PeriodicCheckpointer(tmp_path, period=2, max_iter=11, max_to_keep=3)
    assert pc.last_name() == ""
    for it in range(11):
        pc.step(it, {"it": it})
        if (it + 1) % 2 == 0:
            assert pc.last_name() == f"model_{it:07d}"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["last_checkpoint", "model_0000005.pth", "model_0000007.pth",
                     "model_0000009.pth", "model_final.pth"]
    assert pc.last_name() == "model_final"
    assert restore_checkpoint(tmp_path, "model_final")["it"] == 10
    assert restore_checkpoint(tmp_path, "model_0000009")["it"] == 9
    assert restore_checkpoint(tmp_path, "model_0000001") is None


def test_a_save_killed_mid_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    save_checkpoint(tmp_path, {"epoch": 1, "w": torch.arange(4.0)})
    real_save = torch.save

    def killed(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 half a zip")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(tmp_path, {"epoch": 2, "w": torch.zeros(4)})
    monkeypatch.setattr(ckpt.torch, "save", real_save)
    state = restore_checkpoint(tmp_path)
    assert state["epoch"] == 1 and torch.equal(state["w"], torch.arange(4.0))
    assert os.listdir(tmp_path) == ["checkpoint.pth"]
