"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`) names a
configuration and a traffic mix; the mix names its driver. The run:

  1. refuses to run without as many CUDA cards as the cell asks for;
  2. set-up: inputs, seeded weights and the program built on the card, and
     the driver's warm-up, which drives the first steps through the
     window's own call (`setup_s` runs from the process's start to here);
  3. measures for `--seconds`;
  4. with `--trace 1`, runs the probes' steps and a short torch.profiler
     stretch, and reads the per-layer metrics;
  5. reads the peak memory, frees the program's state and compares what
     the timed path produced with the plain fp32 reference, each number
     against its limit (`limits/<cell>.json`);
  6. refuses to print a result if any module of JAX or of the JAX package
     was loaded, and prints the numbers compared on standard error and the
     result as the last line of standard output.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Iterable, List, Optional  # noqa: E402

from .counts import flops  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "adaptersis_tpu")
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def foreign_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FOREIGN})


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc has no answer."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its kernels into `build/kernels/` there itself."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(root / "build" / "inductor")
    os.environ["USE_FLAX"] = "0"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Readings:
    """Everything a metric reader reads: the window, set-up, memory, the
    probes' spans, the profiler's reduction and the frozen counts."""

    def __init__(self, driver, cfg: dict, window: dict, setup_s: float,
                 peak_bytes: Optional[int], device_kind: str):
        self.kind = driver.kind
        self.window = window
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.spans: Dict[str, Optional[float]] = {}
        self.profile: Optional[dict] = None
        self.flops_per_step = driver.flops_per_step()
        c = cfg
        per = driver.units_per_step
        self.walk_flops_per_step = flops.walk_flops(per, c["imsize"], c["patch_size"],
                                                    c["embed_dim"], c["depth"], c["mlp_ratio"])
        self.walk_bytes_per_step = flops.walk_bytes(per, 2 if c["precision"] == "bf16" else 4,
                                                    c["imsize"], c["patch_size"],
                                                    c["embed_dim"], c["depth"], c["mlp_ratio"])
        peaks = json.loads(PEAKS.read_text()).get(device_kind, {})
        self.peak_flops = peaks.get(c["peak"])
        self.hbm_bytes_per_s = peaks.get("hbm_bytes_per_s")

    @property
    def steps_per_s(self) -> float:
        return self.window["steps"] / self.window["seconds"]


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers the cell compares, those its limits name, each beside
    its limit; a limit for a number the run does not give is an error."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the run gives no number {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def run(argv: Optional[List[str]] = None, require_cuda: bool = True, manifest=None) -> dict:
    """One run; returns the result (also printed). `require_cuda` False
    lets the CPU tests drive the rest of a run on the CPU."""
    args = parse(argv)
    from .manifest import Manifest, driver, probe
    m = manifest or Manifest()
    set_cache_dirs(m.root)
    import torch
    age_imported = process_age_s()

    cell = m.cell(args.workload)
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"error: {args.workload} needs {cell['chips']} CUDA device(s), found {have}",
                  file=sys.stderr)
            sys.exit(2)
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(device)
    else:
        device, kind = torch.device("cpu"), "cpu"
    cfg, mix, limits = m.config(cell["config"]), m.mix(cell["traffic"]), m.limits(cell["name"])
    drv = driver(mix["driver"]).Driver(cfg, mix, args.seed, device)
    drv.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    parts = {"imports": age_imported, **drv.setup_parts}
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" total {setup_s:.3f}",
          file=sys.stderr)
    window = drv.window(args.seconds)
    attempted, failed = drv.attempted_failed()
    r = Readings(drv, cfg, window, setup_s, None, kind)
    wanted = m.metrics(cell["name"], bool(args.trace))
    readers = {e["name"]: m.reader(e["name"]) for e in wanted}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1}
    if args.trace:
        from . import trace
        needed = sorted({p for mod in readers.values() for p in getattr(mod, "PROBES", ())})
        spans = {p: probe(p).install(drv) for p in needed}
        try:
            for _ in range(mix["traced_steps"]):
                drv.step()
                for s in spans.values():
                    s.mark_step()
            r.spans = {p: s.ms_per_step() for p, s in spans.items()}
        finally:
            for s in spans.values():
                s.remove()
        r.profile = trace.profile(drv.step, mix["profiled_steps"])
        device_info.update(busy_s=r.profile["busy_s"], window_s=r.profile["window_s"])
        limit_w = power_limit()
        device_info["power_limit"] = limit_w
        print(f"power limit {limit_w}, peak {cfg['peak']} {r.peak_flops}", file=sys.stderr)
    if cuda:
        torch.cuda.synchronize()
        r.peak_bytes = torch.cuda.max_memory_allocated(device)
        device_info["memory_peak_bytes"] = r.peak_bytes
    metrics = {}
    for e in wanted:
        value = readers[e["name"]].read(r)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    drv.free()
    t_ref = time.perf_counter()
    numbers, _ = drv.numbers()
    print(f"comparison {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = check_lines(numbers, limits)
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    found = foreign_modules(sys.modules)
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        sys.exit(3)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = {"device_ops": r.profile["device_ops"],
                               "idle_gaps": r.profile["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    run()


if __name__ == "__main__":
    main()
