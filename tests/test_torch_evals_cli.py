"""The port's `evals_cli` in its three modes on the CPU at vit_test width,
on a seeded `.pth` written under the test's temporary directory: the JAX
CLI's flags (with --device), 4 synthetic batches a split, and each mode's
printed lines and returned accuracies. On the synthetic set, where every
frame holds class 1, every accuracy is 1 on both sides: the CLI's glue is
held against the JAX CLI's in test_torch_evals_cli_glue.py, the
arithmetic beneath (taps, k-NN, the probe grid, the L-BFGS sweep) in
test_torch_evals.py and test_torch_logreg.py."""

import contextlib
import io
import re

import pytest
import torch

from adaptersis_tpu_torch import evals_cli
from torch_parity import dinov2_state_dict, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

VIT = dict(img_size=518, patch_size=14, embed_dim=64, depth=5, num_heads=4)   # vit_test


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "backbone.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in dinov2_state_dict(VIT, 7).items()}},
               path)
    return str(path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = main(argv)
    return got, out.getvalue().splitlines()


@pytest.mark.parametrize("mode", ["knn", "logreg", "linear"])
def test_evals_cli(pth, mode):
    argv = [mode, "--arch", "vit_test", "--imsize", "56", "--batch_size", "8", "--epochs", "1",
            "--nb_knn", "5", "10", "--pretrained_weights", pth, "--synthetic"]
    got, lines = _run(evals_cli.main, argv + ["--device", "cpu"])
    assert (got["train_images"], got["val_images"], got["mode"]) == (32, 32, mode)
    assert got["num_classes"] == 2
    assert all(v > 0 for v in got["extract_img_per_s"].values())
    acc = got["accuracy"]
    if mode == "knn":
        assert lines == [f"{k}-NN accuracy: {acc[k] * 100:.2f}%" for k in (5, 10)]
        assert all(a == 1.0 for a in acc.values())
    elif mode == "logreg":
        assert len(acc) == 9 and got["best"] == max(acc, key=acc.get)
        assert all(a == 1.0 for a in acc.values())
        assert lines == [str({f"C={c:g}": f"{a * 100:.2f}%" for c, a in acc.items()}),
                         f"best C={got['best']:g}: {acc[got['best']] * 100:.2f}%"]
    else:
        assert len(acc) == 52 and got["best"] == max(acc, key=acc.get)
        assert re.fullmatch(r"best classifier: classifier_(1|4)_blocks_avgpool_(True|False)"
                            r"_lr_\d_\d{5} acc=\d+\.\d\d%", lines[0]) and len(lines) == 1
