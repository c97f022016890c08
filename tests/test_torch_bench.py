"""The port's entry points of the deployed configuration, `bench` (train
step) and `bench_infer` (forward + argmax), on the CPU at a tiny size, and
its own copy of the JAX package's analytic FLOP count."""

import json
import math

import pytest
import torch

import adaptersis_tpu.utils.flops as jax_flops
from adaptersis_tpu_torch import bench, bench_infer
from adaptersis_tpu_torch.utils import flops

TINY = ["--device", "cpu", "--arch", "vit_test", "--imsize", "56", "--batch", "2",
        "--steps", "1", "--repeats", "1"]


def _one_json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_runs_on_cpu(capsys):
    res = bench.main(TINY)
    assert _one_json_line(capsys) == res
    assert res["metric"] == "vitl14_588_adapter_train_images_per_sec_per_gpu"
    assert res["unit"] == "img/s/gpu" and res["device"] == "cpu" and res["batch"] == 2
    assert math.isfinite(res["value"]) and res["value"] > 0 and math.isfinite(res["loss"])
    assert res["spread"] == [res["value"], res["value"]]
    # device metrics are not made up from a CPU run
    assert res["mfu"] is None and res["peak_mem_gib"] is None


def test_bench_profile_on_cpu(capsys):
    """`--profile`: the same JSON line, then torch.profiler's table of 3
    more steps."""
    res = bench.main(TINY + ["--profile"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == res
    assert set(res) == {"metric", "value", "unit", "spread", "mfu", "peak_mem_gib", "device",
                        "batch", "world_size", "global_img_per_s", "loss"}
    assert lines[1].startswith("torch.profiler over 3 train steps on cpu")
    assert any("aten::" in x for x in lines[2:])


def test_bench_infer_runs_on_cpu(capsys):
    res = bench_infer.main(TINY)
    assert _one_json_line(capsys) == res
    assert res["metric"] == "vit_test_56_adapter_inference_images_per_sec_per_gpu"
    assert res["unit"] == "img/s/gpu" and res["device"] == "cpu" and res["batch"] == 2
    assert math.isfinite(res["value"]) and res["value"] > 0
    assert res["ms_batch"] == pytest.approx(1000 * 2 / res["value"])


@pytest.mark.parametrize("mod", [bench, bench_infer], ids=["bench", "bench_infer"])
def test_entry_points_require_a_gpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(["--arch", "vit_test", "--imsize", "56"])


def test_unknown_card_has_no_peak():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError, match="no known dense bf16 peak"):
        bench.peak_bf16_flops("Some Other Card")


@pytest.mark.parametrize("name,args", [
    ("vit_block_flops", (1765, 1024)),
    ("vit_block_flops", (197, 384, 4.0)),
    ("msda_flops", (1764, 6949, 1024)),
    ("msda_flops", (6949, 1764, 1024, 8, 1, 4)),
    ("adapter_round_flops", (1764, 6949, 1024)),
    ("encoder_flops", (588,)),
    ("encoder_flops", (140, 16, 128)),
    ("decoder_flops", (42, 42, 1024)),
    ("decoder_flops", (8, 8, 128, 2, (128, 32, 16, 16, 8))),
])
def test_flops_match_jax(name, args):
    assert getattr(flops, name)(*args) == getattr(jax_flops, name)(*args)


@pytest.mark.parametrize("batch,imsize,E,depth", [(16, 588, 1024, 24), (2, 140, 384, 12)])
def test_train_step_flops_count_the_unpadded_walks(batch, imsize, E, depth):
    """The port counts the clean walk at 1 + hp·wp tokens and the adapter
    walk at hp·wp; the JAX package counts both at the 128-padded length."""
    n = (imsize // 14) ** 2
    pad = -(-(n + 1) // 128) * 128
    block = jax_flops.vit_block_flops
    diff = batch * depth * (block(n + 1, E) + block(n, E) - 2 * block(pad, E))
    got = flops.train_step_flops(batch, imsize, embed_dim=E, depth=depth)
    want = jax_flops.train_step_flops(batch, imsize, embed_dim=E, depth=depth)
    assert got - want == pytest.approx(diff, rel=1e-9)
    assert diff < 0
