"""The port's `train_seg` command line against `train.py`'s: every option
string of `train.py`'s parser is accepted, and `--device` and
`--flax_variables` are the only additions; `--config_file` and `--opts`
pick the arch as `train.py`'s `_arch_from_config` does; a malformed
`--opts` exits; unported models, decoders, losses and `--fsdp` above 1 exit
naming their ROADMAP.md item; `evaluate` reads a dataset without
`--synthetic`."""

import importlib.util
import os
import sys

import numpy as np
import pytest
from PIL import Image

from adaptersis_tpu_torch import evaluate, train_seg

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
    assert text.count("not acted on") >= 6
    assert "M10" in text and "M11" in text


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
    with pytest.raises(SystemExit, match=item):
        train_seg.main(TINY + ["--synthetic", "--output_dir", str(tmp_path)] + flags)


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
