"""The port's `train_seg` command line against `train.py`'s: every option
string of `train.py`'s parser is accepted, and `--device` and
`--flax_variables` are the only additions; `--config_file` and `--opts`
pick the arch as `train.py`'s `_arch_from_config` does; a malformed
`--opts` exits; every `--model` and `--decoder` trains a tiny epoch on the
CPU, and `--fsdp` above 1 exits naming its ROADMAP.md item; `train_mla`,
`train_multi_class` and the six `eval.eval_dinov2_*` entry points take
their scripts' defaults; `tap_setr_ete`'s trained backbone goes into the
checkpoint and a resumed run restores it bit for bit; `evaluate` reads a
dataset without `--synthetic` and evaluates every model."""

import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from adaptersis_tpu_torch import evaluate, train_mla, train_multi_class, train_seg
from adaptersis_tpu_torch import eval as eval_entry
from adaptersis_tpu_torch.train.checkpoint import restore_checkpoint
from adaptersis_tpu_torch.train.trainer import Trainer

from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch", "vit_test", "--patch_size", "14", "--imsize", "56", "--device", "cpu",
        "--batch_size_per_gpu", "2"]


def _train_py():
    """The repository's train.py, loaded by path."""
    if "repo_train" not in sys.modules:
        spec = importlib.util.spec_from_file_location("repo_train",
                                                      os.path.join(ROOT, "train.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["repo_train"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["repo_train"]


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_train_seg_accepts_every_train_py_option():
    ref, mine = _options(_train_py().get_args_parser()), _options(train_seg.get_args_parser())
    assert set(ref) <= set(mine)
    assert set(mine) - set(ref) == {"--device", "--flax_variables"}
    for opt, a in ref.items():
        b = mine[opt]
        assert (b.dest, b.default, b.nargs, b.choices) == (a.dest, a.default, a.nargs,
                                                           a.choices), opt
        assert type(b) is type(a), opt
    for opt, b in mine.items():
        assert b.help or opt in ("-h", "--arch", "--patch_size", "--imsize", "--epochs", "--lr",
                                 "--batch_size_per_gpu", "--val_freq", "--output_dir",
                                 "--dataset", "--num_classes", "--seed", "--no_clahe",
                                 "--device"), opt


def test_help_says_what_the_port_does_with_the_tpu_choices():
    text = " ".join(train_seg.get_args_parser().format_help().split())
    for words in ("--attn_impl", "--msda_impl", "--platform", "--fsdp", "--avgpool_patchtokens",
                  "--dist_url", "--local_rank", "--num_labels"):
        assert words in text
    assert text.count("not acted on") >= 5
    # the segmentor variants and data parallelism are ported: no item is left
    assert "M10" not in text and "M11" not in text
    assert "divide the world size" in text and "tcp://host:port" in text


@pytest.mark.parametrize("argv, want", [
    ([], ("vit_small", 16)),
    (["--opts", "student.arch=vit_large", "student.patch_size=14"], ("vit_large", 14)),
    (["--config_file", "CONFIG"], ("vit_base", 14)),
    (["--config_file", "CONFIG", "--opts", "student.arch=vit_test"], ("vit_test", 14)),
])
def test_config_file_and_opts_pick_the_arch(tmp_path, argv, want):
    cfg = tmp_path / "vitb14.yaml"
    cfg.write_text("student:\n  arch: vit_base\n  patch_size: 14\ntrain:\n  lr: 1\n")
    argv = [str(cfg) if a == "CONFIG" else a for a in argv]
    for mod in (train_seg, _train_py()):
        args = mod.get_args_parser().parse_args(argv)
        assert mod._arch_from_config(args) == want


@pytest.mark.parametrize("opts", [["student.arch"], ["student=1", "student.arch=vit_test"]])
def test_malformed_opts_exit(opts):
    args = train_seg.get_args_parser().parse_args(["--opts", *opts])
    with pytest.raises(SystemExit, match="--opts"):
        train_seg._arch_from_config(args)


@pytest.mark.parametrize("flags, item", [
    (["--loss", "tversky"], "M11"), (["--loss", "masktrans"], "M11"),
    (["--decoder", "mla"], "M11"), (["--decoder", "setr"], "M11"),
    (["--model", "tap_setr"], "M11"), (["--model", "tap_masktrans"], "M11"),
    (["--fsdp", "2"], "M10")])
def test_unported_choices_exit_naming_their_item(tmp_path, flags, item):
    """M11's choices (the losses, decoders and models that were not ported)
    train a tiny epoch now; M10 is ported too, so --fsdp 2 exits only
    because 2 does not divide a single process's world size of 1."""
    argv = TINY + ["--synthetic", "--epochs", "1", "--output_dir", str(tmp_path)] + flags
    if item == "M10":
        with pytest.raises(SystemExit, match="--fsdp 2 does not divide the world size 1"):
            train_seg.main(argv)
        return
    _trains_a_tiny_epoch(train_seg.main(argv), tmp_path)


def _trains_a_tiny_epoch(hist, out) -> None:
    stats = hist[0]
    assert len(stats["train_losses"]) == 8 and stats["train_losses_finite"]
    for k in ("train_loss", "test_loss", "test_dice", "test_acc1"):
        assert np.isfinite(stats[k]), k
    assert len((out / "log.txt").read_text().splitlines()) == 1
    assert (out / "variables.npz").exists()


@pytest.mark.parametrize("model", ["tap_unet", "tap_unet_fuse", "tap_setr_ete"])
def test_every_model_trains_a_tiny_epoch(tmp_path, model):
    """The models the test above does not run (it runs tap_setr and
    tap_masktrans, the mla and setr decoders)."""
    _trains_a_tiny_epoch(train_seg.main(TINY + ["--synthetic", "--epochs", "1", "--model", model,
                                                "--output_dir", str(tmp_path)]), tmp_path)


def test_per_model_defaults():
    """train.py's per-model rules: a tap_* model takes its script's loss
    where --loss is left at "dc"; the mask transformer's inputs are
    ImageNet-normalised."""
    parse = train_seg.get_args_parser().parse_args
    want = {"adapter": "dc", "tap_setr": "ce_dc", "tap_unet": "ce_dc", "tap_unet_fuse": "ce_dc",
            "tap_masktrans": "masktrans", "tap_setr_ete": "ce_dc"}
    for model, loss in want.items():
        assert train_seg.train_loss(parse(["--model", model])) == loss
        assert train_seg.train_loss(parse(["--model", model, "--loss", "tversky"])) == "tversky"
        assert evaluate.input_norm(model) == ("imagenet_div255" if model == "tap_masktrans"
                                              else "none")


def test_train_mla_forces_the_mla_decoder(tmp_path):
    hist = train_mla.main(TINY + ["--synthetic", "--epochs", "1", "--output_dir", str(tmp_path),
                                  "--decoder", "feature", "--mla_last_block_bug"])
    _trains_a_tiny_epoch(hist, tmp_path)
    args = train_mla.get_args_parser().parse_args(["--mla_last_block_bug"])
    assert args.mla_last_block_bug and not train_mla.get_args_parser().parse_args(
        []).mla_last_block_bug
    with np.load(tmp_path / "variables.npz") as f:
        assert "params/decoder/mlahead/head2_a/conv/kernel" in f


def test_train_multi_class_defaults():
    args = train_multi_class.parse_args([])
    assert (args.num_classes, args.loss, args.dataset) == (8, "iou_multi", "endovis2017")
    args = train_multi_class.parse_args(["--num_labels", "5", "--num_classes", "3", "--loss",
                                         "ce", "--dataset", "cholecseg8k"])
    assert (args.num_classes, args.loss, args.dataset) == (3, "ce", "cholecseg8k")


EVAL_ENTRIES = {  # module → (--model, imsize, the loss the run trains with, input norm)
    "eval_dinov2_setr": ("tap_setr", 224, "ce_dc", "none"),
    "eval_dinov2_unet": ("tap_unet", 224, "ce_dc", "none"),
    "eval_dinov2_or_unet_fuse": ("tap_unet_fuse", 224, "ce_dc", "none"),
    "eval_dinov2_masktrans": ("tap_masktrans", 392, "masktrans", "imagenet_div255"),
    "eval_dinov2_masktrans_inov": ("tap_masktrans", 588, "dc", "none"),
    "eval_dinov2_setr_cross_ete": ("tap_setr_ete", 224, "ce_dc", "none"),
}


@pytest.mark.parametrize("name", sorted(EVAL_ENTRIES))
def test_eval_entry_points_take_their_defaults(name):
    mod = importlib.import_module(f"adaptersis_tpu_torch.eval.{name}")
    model, imsize, loss, norm = EVAL_ENTRIES[name]
    args = eval_entry.parse_args(mod.MODEL, mod.DEFAULTS, mod.FIXED, [])
    assert (args.model, args.imsize, train_seg.train_loss(args)) == (model, imsize, loss)
    assert getattr(args, "input_norm", evaluate.input_norm(args.model)) == norm
    # a flag given on the command line wins over the entry point's default
    args = eval_entry.parse_args(mod.MODEL, mod.DEFAULTS, mod.FIXED, ["--imsize", "56"])
    assert args.imsize == 56


def test_eval_entry_point_runs(tmp_path):
    from adaptersis_tpu_torch.eval import eval_dinov2_masktrans_inov as inov
    hist = inov.main(TINY + ["--synthetic", "--epochs", "1", "--output_dir", str(tmp_path)])
    _trains_a_tiny_epoch(hist, tmp_path)


def test_setr_ete_checkpoint_holds_the_backbone(tmp_path, monkeypatch):
    """tap_setr_ete trains its backbone: the checkpoint holds it, a resumed
    run restores it bit for bit, and ends where the run that never stopped
    ends."""
    def argv(out):
        return TINY + ["--synthetic", "--model", "tap_setr_ete", "--epochs", "2",
                       "--output_dir", str(out)]

    train_seg.main(argv(tmp_path / "full"))
    monkeypatch.setenv("ASN_STOP_AFTER_EPOCHS", "1")
    train_seg.main(argv(tmp_path / "resumed"))
    state = restore_checkpoint(tmp_path / "resumed")
    backbone = {k: v for k, v in state["model"].items() if k.startswith("backbone.")}
    args = train_seg.get_args_parser().parse_args(argv(tmp_path / "resumed"))
    seeded = evaluate.build_model(args).state_dict()
    assert backbone and set(backbone) == {k for k in seeded if k.startswith("backbone.")}
    assert any(not torch.equal(v, seeded[k]) for k, v in backbone.items())
    trainer = Trainer(evaluate.build_model(args), loss="ce_dc", softmax=False)
    trainer.load_state_dict(state)
    for k, v in trainer.model.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(v, backbone[k]), k
    monkeypatch.delenv("ASN_STOP_AFTER_EPOCHS")
    train_seg.main(argv(tmp_path / "resumed"))
    with np.load(tmp_path / "full" / "variables.npz") as a, \
            np.load(tmp_path / "resumed" / "variables.npz") as b:
        assert set(a) == set(b) and any(k.startswith("params/backbone/") for k in a)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    logs = [[json.loads(line) for line in (tmp_path / d / "log.txt").read_text().splitlines()]
            for d in ("full", "resumed")]
    assert logs[0] == logs[1]


def test_evaluate_reads_a_dataset_without_synthetic(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        for sub, a, mode in (("images", rng.integers(0, 256, (40, 60, 3)), None),
                             ("annotations", (rng.uniform(size=(40, 60)) < 0.3) * 255, "L")):
            (tmp_path / sub / "validation").mkdir(parents=True, exist_ok=True)
            Image.fromarray(a.astype(np.uint8), mode).save(
                tmp_path / sub / "validation" / f"{i}.png")
    stats = evaluate.main(TINY + ["--dataset", "robomis", "--data_path", str(tmp_path),
                                  "--num_workers", "2"])
    assert stats["images"] == 3 and stats["batches"] == 2 and stats["logits_finite"]
    assert stats["decoder"] in ("native", "pil")
    with pytest.raises(SystemExit, match="no validation images"):
        evaluate.main(TINY + ["--dataset", "robomis", "--data_path", str(tmp_path / "none")])


@pytest.mark.parametrize("flags", [["--model", m] for m in evaluate.MODELS[1:]]
                         + [["--decoder", d] for d in evaluate.DECODERS[1:]]
                         + [["--decoder", "mla", "--mla_last_block_bug"]])
def test_evaluate_runs_every_model(flags):
    stats = evaluate.main(TINY + ["--synthetic"] + flags)
    assert stats["logits_finite"] and stats["images"] == 4
    assert all(np.isfinite(stats[k]) for k in ("loss", "dice", "acc1"))
