"""BENCHMARK.json against the contract it is written to, and the harness
finding a new configuration, mix, metric and cell by name alone."""

import json
import re
import shutil

import pytest

from benchmark.manifest import Manifest, ROOT
from benchmark.run import run
from tiny import tiny_manifest

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = DATA["end_to_end"] + DATA["per_layer"]
CELLS = [w["name"] for w in DATA["workloads"]]


def cells_of(metric: dict):
    return metric.get("workloads", CELLS)


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "-m", "benchmark.run"]
    assert DATA["paths"] == ["benchmark"]
    assert 1 <= DATA["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", DATA["configs"] + DATA["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_name_and_unit_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (DATA["configs"], DATA["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", DATA["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metric_cells_report_what_it_moves(metric):
    moved = next(m for m in DATA["end_to_end"] if m["name"] == metric["moves"])
    for cell in cells_of(metric):
        assert cell in cells_of(moved), (metric["name"], cell)
    reader = Manifest().reader(metric["name"])
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (metric["unit"], metric["layer"],
                                                           metric["moves"])
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")


def test_layers_named_alike():
    layers = {}
    for m in DATA["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", DATA["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_bounds_and_readers(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert Manifest().reader(metric["name"]).UNIT == metric["unit"]


@pytest.mark.parametrize("cell", DATA["workloads"], ids=lambda e: e["name"])
def test_every_cell_has_its_files_and_metrics(cell):
    m = Manifest()
    assert cell["chips"] == 1
    assert m.config(cell["config"])["name"] == cell["config"]
    mix = m.mix(cell["traffic"])
    assert (ROOT / "benchmark" / "traffic" / f"{mix['driver']}.py").exists()
    assert m.limits(cell["name"])
    e2e = [e["name"] for e in m.metrics(cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert m.metrics(cell["name"], True)


@pytest.mark.parametrize("config", DATA["configs"], ids=lambda e: e["name"])
def test_every_config_has_a_cell_and_its_file(config):
    assert any(w["config"] == config["name"] for w in DATA["workloads"])
    assert config["file"].startswith("benchmark/configs/")
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["source"] == config["source"] and config["reduced"] == []
    assert set(config) == {"name", "source", "file", "reduced", "why"}


def test_a_new_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """Add a configuration, a mix, a per-layer metric and a cell as files
    and entries alone; the harness finds and runs them."""
    m = tiny_manifest(tmp_path)
    bench = tmp_path / "benchmark"
    cfg = json.loads((tmp_path / "benchmark/configs/adaptersis_vitl14_588_bf16.json").read_text())
    cfg.update(name="dummy_cfg", imsize=56)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "mixes" / "clips16_closed1.json").read_text())
    mix.update(frames=2)
    (bench / "mixes" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "frames_per_request.dummy.py").write_text(
        'UNIT = "img"\nLAYER = "entry: the step call the window drives"\n'
        'MOVES = "serve_img_per_s"\nPROBES = ()\n\n\ndef read(r):\n'
        '    return r.window["units"] / r.window["steps"]\n')
    shutil.copy(bench / "limits" / "serve.deployed_bf16.json", bench / "limits" / "dummy.cell.json")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "dummy_cfg", "source": "x", "reduced": [], "why": "x",
                            "file": "benchmark/configs/dummy_cfg.json"})
    data["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    for e in data["end_to_end"]:
        if "serve.deployed_bf16" in e.get("workloads", []):
            e["workloads"].append("dummy.cell")
    data["per_layer"] = [{"name": "frames_per_request.dummy", "unit": "img",
                          "better": "higher", "source": "program_counter",
                          "layer": "entry: the step call the window drives",
                          "moves": "serve_img_per_s", "workloads": ["dummy.cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = Manifest(tmp_path, bench)
    assert [e["name"] for e in m.metrics("dummy.cell", True)] == ["frames_per_request.dummy"]
    out = run(["--workload", "dummy.cell", "--seed", "2147483999", "--seconds", "0.5"],
              require_cuda=False, manifest=m)
    assert out["correct"] and set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    r = m.reader("frames_per_request.dummy")
    assert r.read(type("R", (), {"window": {"units": 6, "steps": 3}})) == 2
