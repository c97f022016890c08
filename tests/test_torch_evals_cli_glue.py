"""The port's `evals_cli` glue against the JAX CLI's, on the CPU at
vit_test width, on the same seeded `.pth` and flags: what each CLI hands
its harness in each mode (the features and labels of both splits, which
carry the 1/255 scaling, the tap and token pooled and the label rule; the
class count; k and T; the probe grid's widths and every train and val
batch's taps). The harnesses are stubbed on both sides: their arithmetic
is held against the JAX package in test_torch_evals.py and
test_torch_logreg.py, and the CLI's printed lines in
test_torch_evals_cli.py. The JAX CLI runs once, its features replayed into
its knn and logreg modes, so that it costs one XLA compile of the
backbone."""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import adaptersis_tpu.evals as jax_evals
import adaptersis_tpu.evals.knn as jax_knn
from adaptersis_tpu_torch import evals_cli
from test_torch_evals_cli import VIT, _run
from torch_parity import dinov2_state_dict, n, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli_glue") / "backbone.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in dinov2_state_dict(VIT, 7).items()}},
               path)
    return str(path)


# fp32 on both sides, as test_torch_evals.py's taps
ATOL = 2e-5


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "repo_evals_cli", Path(__file__).resolve().parents[1] / "evals_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Harness:
    """Stands in for the harnesses of either CLI (`eval_knn`,
    `logreg_sweep`, `LinearProbeGrid`) and records what the CLI hands them."""

    def __init__(self):
        self.calls = {}

    def eval_knn(self, train_f, train_y, val_f, val_y, **kw):
        self.calls["knn"] = kw
        return {k: 1.0 for k in kw["nb_knn"]}

    def logreg_sweep(self, train_f, train_y, val_f, val_y, **kw):
        self.calls["logreg"] = kw
        return 1.0, {1.0: 1.0}

    def grid(self, **kw):
        rec = self.calls["linear"] = {"kw": kw, "train": [], "val": []}

        class Grid:
            def init(self, rng):
                pass

            def to(self, device):
                return self

            def train_step(self, taps, ys):
                rec["train"].append((taps, ys))

            def evaluate(self, taps_b, ys_b):
                rec["val"] = list(zip(taps_b, ys_b))
                return "head", {"head": 1.0}

        return Grid()


def _argv(mode, pth):
    return [mode, "--arch", "vit_test", "--imsize", "56", "--batch_size", "8", "--epochs", "1",
            "--nb_knn", "5", "10", "--temperature", "0.1", "--pretrained_weights", pth,
            "--synthetic"]


def _record_extraction(extract, store):
    def wrapped(*a, **kw):
        out = extract(*a, **kw)
        store.append(tuple(n(x) if isinstance(x, torch.Tensor) else np.asarray(x) for x in out))
        return out
    return wrapped


@pytest.fixture(scope="module")
def jax_runs(pth):
    """The JAX CLI in linear mode (features extracted, taps of every batch),
    then knn and logreg with those features replayed: {mode: (features,
    harness calls)}."""
    cli, mp = _jax_cli(), pytest.MonkeyPatch()
    feats, out = [], {}
    try:
        harness = _Harness()
        mp.setattr(jax_evals, "extract_features", _record_extraction(
            jax_evals.extract_features, feats))
        mp.setattr(jax_evals, "LinearProbeGrid", harness.grid)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(cli.get_args_parser().parse_args(_argv("linear", pth)))
        out["linear"] = harness.calls
        replay = iter(feats * 2)
        mp.setattr(jax_evals, "extract_features", lambda fm, loader: next(replay))
        mp.setattr(jax_evals, "logreg_sweep", harness.logreg_sweep)
        mp.setattr(jax_knn, "eval_knn", harness.eval_knn)
        for mode in ("knn", "logreg"):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(cli.get_args_parser().parse_args(_argv(mode, pth)))
        out["knn"] = out["logreg"] = harness.calls
    finally:
        mp.undo()
    return feats, out


def _assert_taps(got, want):
    assert len(got) == len(want)
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(n(gp), np.asarray(wp), atol=ATOL, rtol=0)
        np.testing.assert_allclose(n(gc), np.asarray(wc), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["knn", "logreg", "linear"])
def test_evals_cli_matches_jax_cli(pth, jax_runs, monkeypatch, mode):
    want_feats, want_calls = jax_runs
    feats, harness = [], _Harness()
    monkeypatch.setattr(evals_cli, "extract_features", _record_extraction(
        evals_cli.extract_features, feats))
    monkeypatch.setattr(evals_cli, "eval_knn", harness.eval_knn)
    monkeypatch.setattr(evals_cli, "logreg_sweep", harness.logreg_sweep)
    monkeypatch.setattr(evals_cli, "LinearProbeGrid", harness.grid)
    _run(evals_cli.main, _argv(mode, pth) + ["--device", "cpu"])
    assert len(feats) == len(want_feats) == 2                     # train, val
    for (gf, gy), (wf, wy) in zip(feats, want_feats):
        assert gf.shape == wf.shape == (32, 64)
        np.testing.assert_allclose(gf, wf, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(gy, wy)
    got, want = harness.calls[mode], want_calls[mode][mode]
    if mode != "linear":
        assert got == want
        return
    assert got["kw"] == want["kw"]
    assert len(got["train"]) == len(want["train"]) == 4 and len(got["val"]) == 4
    for split in ("train", "val"):
        for (gt, gy), (wt, wy) in zip(got[split], want[split]):
            _assert_taps(gt, wt)
            np.testing.assert_array_equal(n(gy), np.asarray(wy))
