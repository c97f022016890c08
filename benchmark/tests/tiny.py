"""Tiny copies of the benchmark's cells for the CPU tests: the same
BENCHMARK.json, metrics and limits, with each configuration cut to a
vit_test backbone (width 64, depth 5, 4 heads) at 112 px and each mix to a
few images."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.manifest import Manifest, ROOT

BENCH = ROOT / "benchmark"
TINY = dict(arch="vit_test", embed_dim=64, depth=5, num_heads=4, imsize=112,
            pos_embed_img_size=42)
MIXES = {"train": dict(batch=4, pool=2, traced_steps=2, profiled_steps=2),
         "serve": dict(frames=4, clips=2, warmup_requests=1, checked_requests=2,
                       traced_steps=2, profiled_steps=2)}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "mixes" / f"{name}.json").read_text())
    mix.update(MIXES[mix["driver"]])
    return mix


def tiny_manifest(tmp: Path) -> Manifest:
    """A checkout in `tmp` whose files are the benchmark's, each
    configuration and mix cut to the tiny sizes."""
    bench = tmp / "benchmark"
    for sub in ("metrics", "limits"):
        shutil.copytree(BENCH / sub, bench / sub)
    (bench / "configs").mkdir(parents=True)
    (bench / "mixes").mkdir()
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in data["configs"]:
        (tmp / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    for w in data["workloads"]:
        (bench / "mixes" / f"{w['traffic']}.json").write_text(json.dumps(tiny_mix(w["traffic"])))
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return Manifest(tmp, bench)
