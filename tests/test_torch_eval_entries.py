"""The reference eval scripts' entry points in both packages, each run up to
its training loader: the JAX package's wrappers (`eval/eval_dinov2_*.py`,
through runpy with `--platform cpu`) against the port's
`adaptersis_tpu_torch.eval.eval_dinov2_*` on the same flags. Both build the
same model class and decoder with the same classes and taps, train on
frames of the same size, with the same loss and input normalisation, and
train the backbone in the same script only. The one documented difference
(eval_dinov2_masktrans_inov: the port follows the reference script's dice
loss on /255 inputs, where the JAX wrapper's train.py swaps in the mask
transformer's loss and normalisation) is asserted as a difference."""

import importlib
import os
import runpy
import sys

import pytest
import torch

import adaptersis_tpu.data as jax_data
import adaptersis_tpu.train as jax_train
from adaptersis_tpu_torch import train_seg
from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("eval_dinov2_setr", "eval_dinov2_unet", "eval_dinov2_or_unet_fuse",
           "eval_dinov2_masktrans", "eval_dinov2_masktrans_inov", "eval_dinov2_setr_cross_ete")
# eval_dinov2_masktrans_inov: (loss, input norm) of the JAX wrapper, of the port
INOV = {"jax": ("masktrans", "imagenet_div255"), "port": ("dc", "none")}


class _AtTheLoader(Exception):
    """Raised by a stand-in DataLoader: the trainer has built its sets."""


def _jax_run(name, flags, monkeypatch):
    """The JAX wrapper up to its training loader: its model, trainer
    configuration and training set."""
    got = {}

    def trainer(model, cfg, **kw):
        got.update(model=model, cfg=cfg)
        return object()

    def loader(dataset, **kw):
        got["dataset"] = dataset
        raise _AtTheLoader

    monkeypatch.setattr(jax_train, "Trainer", trainer)
    monkeypatch.setattr(jax_data, "DataLoader", loader)
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(os.path.join(REPO, "eval"))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--platform", "cpu"] + flags)
    with pytest.raises(_AtTheLoader):
        runpy.run_path(os.path.join(REPO, "eval", f"{name}.py"), run_name="__main__")
    model, cfg = got["model"], got["cfg"]
    return {"class": type(model).__name__, "decoder": model.decoder,
            "num_classes": model.num_classes, "n_last_blocks": model.n_last_blocks,
            "imsize": got["dataset"].imsize, "loss": cfg.loss, "input_norm": cfg.input_norm,
            "train_backbone": cfg.train_backbone}


def _port_run(name, flags, monkeypatch):
    """The port's entry point up to its training loader: the same."""
    got = {}

    def trainer(model, **kw):
        got.update(model=model, **kw)
        return object()

    def loader(dataset, **kw):
        got["dataset"] = dataset
        raise _AtTheLoader

    monkeypatch.setattr(train_seg, "Trainer", trainer)
    monkeypatch.setattr(train_seg, "DataLoader", loader)
    mod = importlib.import_module(f"adaptersis_tpu_torch.eval.{name}")
    with pytest.raises(_AtTheLoader):
        mod.main(flags + ["--device", "cpu"])
    model, imsize = got["model"], got["dataset"].images.shape[1]
    with torch.no_grad():  # the classes the head gives, on one small frame
        classes = model.eval()(torch.zeros(1, 56, 56, 3)).shape[-1]
    return {"class": type(model).__name__, "decoder": model.decoder, "num_classes": classes,
            "n_last_blocks": model.n_last_blocks, "imsize": imsize, "loss": got["loss"],
            "input_norm": got["input_norm"], "train_backbone": model.train_backbone}


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_point_builds_what_the_jax_wrapper_builds(tmp_path, monkeypatch, name):
    flags = ["--arch", "vit_test", "--patch_size", "14", "--batch_size_per_gpu", "1",
             "--synthetic", "--output_dir", str(tmp_path)]
    ref = _jax_run(name, flags, monkeypatch)
    mine = _port_run(name, flags, monkeypatch)
    assert ref["class"] == mine["class"] == "TapSegmentor"
    assert ref["imsize"] == mine["imsize"] == {"eval_dinov2_masktrans": 392,
                                               "eval_dinov2_masktrans_inov": 588}.get(name, 224)
    assert ref["train_backbone"] == mine["train_backbone"] == (name.endswith("_ete"))
    if name == "eval_dinov2_masktrans_inov":
        assert (ref["loss"], ref["input_norm"]) == INOV["jax"]
        assert (mine["loss"], mine["input_norm"]) == INOV["port"]
        ref.update(loss=mine["loss"], input_norm=mine["input_norm"])
    assert mine == ref
    assert (mine["num_classes"], mine["n_last_blocks"]) == (2, 4)
