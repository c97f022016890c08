"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`mixes/<traffic>.json`, whose `driver` names the module under `traffic/`
that generates it); its limits are `limits/<cell>.json`. Every metric is a
reader of its own, `metrics/<metric>.py`. So a configuration, a mix, a
metric or a cell is added by adding files and entries, without editing a
file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "mixes" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())["limits"]

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on):
        those that list it, or list no cells."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        """The module `metrics/<metric>.py` (names may hold dots)."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.traffic.{name}")


def probe(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.probes.{name}")
