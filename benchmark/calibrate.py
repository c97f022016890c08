"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes: the program's numbers against the fp32 reference on
every seed, and on the first `--control-seeds` of them the control's (the
reference put in the program's place in the configuration's `control`
precision) and the planted faults' (the reference put in the program's
place with the fault: half a batch or clip left out, a train step that
leaves its state unchanged, a served answer altered).

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,... \
        --control-seeds 3 [--seconds 3]

Training's readings need no window; a serving cell runs a short one at the
cell's own load and samples its requests as a run does. One JSON line per
reading on standard output, and the lot in `chiprun_out/calibrate_<cell>.jsonl`.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from .manifest import Manifest, driver
from .reference.precision import PRECISIONS
from .run import foreign_modules, set_cache_dirs


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    m = Manifest()
    set_cache_dirs(m.root)
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device")
    cell = m.cell(args.workload)
    cfg, mix = m.config(cell["config"]), m.mix(cell["traffic"])
    out = Path("chiprun_out") / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    with out.open("a") as f:
        def emit(rec):
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            drv = driver(mix["driver"]).Driver(cfg, mix, seed, torch.device("cuda", 0))
            drv.setup()
            if drv.kind == "serve":
                drv.window(args.seconds)
            drv.free()
            t1 = time.perf_counter()
            nums, ref = drv.numbers()
            t2 = time.perf_counter()
            emit({"cell": args.workload, "seed": seed, "side": "program", "numbers": nums,
                  "setup_s": t1 - t0, "reference_s": t2 - t1, "look": getattr(drv, "look", None)})
            if k >= args.control_seeds:
                continue
            sides = [("control", {"prec": PRECISIONS[cfg["control"]]})]
            if drv.kind == "train":
                sides += [("half", {"rows": slice(0, mix["batch"] // 2)}),
                          ("unchanged", {"update": False})]
            else:
                sides += [("half", {"fault": "half"}), ("altered", {"fault": "altered"})]
            for side, kw in sides:
                nums, _ = drv.numbers(program_side=False, ref=ref, **kw)
                emit({"cell": args.workload, "seed": seed, "side": side, "numbers": nums,
                      "look": getattr(drv, "look", None)})
            del drv, ref
            torch.cuda.empty_cache()
    found = foreign_modules(__import__("sys").modules)
    if found:
        raise SystemExit(f"error: JAX modules loaded: {found}")


if __name__ == "__main__":
    main()
