"""Quality-parity harness: the port's counterpart of `tools/quality_parity.py`
(BASELINE.md's protocol, steps 1-3). One command from a dataset to the
reference comparison: `train_seg` with its flags, then a table of the last
validation's dice, acc1 (ch_iou and isi_iou in a multi-class run) and loss
beside optional reference numbers, each flagged FAIL when it is worse than
the reference by more than `--tolerance` (default 0.003, the 0.3-point
north-star bar).

    python -m adaptersis_tpu_torch.quality_parity --dataset robomis \\
        --data_path /data/robomis --arch vit_large --patch_size 14 --imsize 588 \\
        --epochs 500 --bf16 --gelu_approx --pretrained_weights dinov2_vitl14_pretrain.pth \\
        --reference_json ref_metrics.json --output_dir parity

    # a dry run on the CPU (synthetic frames, seconds)
    python -m adaptersis_tpu_torch.quality_parity --device cpu --synthetic --epochs 1 \\
        --arch vit_test --patch_size 14 --imsize 56 --batch_size_per_gpu 2 \\
        --output_dir parity_dry

The reference JSON holds {"dice": 0.91, "acc1": 0.97, ...}: no published
numbers exist (BASELINE.md), so it is measured once by training the
reference. The last `test_*` row of `<output_dir>/log.txt` is compared; a
metric passes within the tolerance or when it is better (`loss` is lower
is better), and one without a reference reads "—". Writes
`<output_dir>/parity.json` (metrics, reference, tolerance, parity_ok) and
`parity.md` (the table, also printed), and exits 1 when a reference was
given and a metric FAILs. Under torchrun rank 0 alone compares, as it alone
writes `log.txt`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from . import train_seg
from .parallel.dist import is_main_process

METRIC_KEYS = ("dice", "acc1", "ch_iou", "isi_iou", "loss")
LOWER_IS_BETTER = {"loss"}


def get_args_parser() -> argparse.ArgumentParser:
    p = train_seg.get_args_parser()
    p.add_argument("--reference_json", default="", type=str,
                   help="JSON of reference metrics to compare against")
    p.add_argument("--tolerance", default=0.003, type=float,
                   help="max |ours − reference| per metric (fraction; 0.003 = 0.3 pt, the "
                        "BASELINE.md north star)")
    return p


def final_metrics(output_dir: str) -> dict:
    """The last epoch's test_* metrics from the trainer's log.txt JSONL."""
    rows = [json.loads(line) for line in
            (Path(output_dir) / "log.txt").read_text().splitlines() if line.strip()]
    tests = [r for r in rows if any(k.startswith("test_") for k in r)]
    if not tests:
        raise SystemExit("no test_* rows in log.txt — did validation run?")
    return {k[len("test_"):]: v for k, v in tests[-1].items() if k.startswith("test_")}


def compare(ours: dict, ref: dict, tolerance: float) -> Tuple[List[tuple], bool]:
    """(metric, ours, reference, Δ, verdict) for each of `METRIC_KEYS` the
    run reports, and whether none FAILs."""
    rows, ok = [], True
    for k in METRIC_KEYS:
        if k not in ours:
            continue
        r = ref.get(k)
        delta = None if r is None else ours[k] - r
        if delta is None:
            verdict = "—"
        else:
            better = ours[k] < r if k in LOWER_IS_BETTER else ours[k] > r
            verdict = "PASS" if abs(delta) <= tolerance or better else "FAIL"
        ok &= verdict != "FAIL"
        rows.append((k, ours[k], r, delta, verdict))
    return rows, ok


def table(rows: List[tuple]) -> str:
    lines = ["| metric | ours | reference | Δ | verdict |", "|---|---|---|---|---|"]
    for k, o, r, d, v in rows:
        lines.append(f"| {k} | {o:.4f} | {'' if r is None else f'{r:.4f}'} | "
                     f"{'' if d is None else f'{d:+.4f}'} | {v} |")
    return "\n".join(lines)


def report(output_dir: str, ref: dict, tolerance: float) -> dict:
    """Compare `output_dir`'s final metrics with `ref`, print the table and
    write parity.json and parity.md; returns parity.json's content."""
    ours = final_metrics(output_dir)
    rows, ok = compare(ours, ref, tolerance)
    text = table(rows)
    print(text)
    out = {"metrics": ours, "reference": ref, "tolerance": tolerance, "parity_ok": ok}
    (Path(output_dir) / "parity.json").write_text(json.dumps(out, indent=2))
    (Path(output_dir) / "parity.md").write_text(text + "\n")
    return out


def main(argv: Optional[List[str]] = None) -> Optional[dict]:
    args = get_args_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    train_seg.run(args)
    if not is_main_process():
        return None
    ref = json.loads(Path(args.reference_json).read_text()) if args.reference_json else {}
    out = report(args.output_dir, ref, args.tolerance)
    if ref and not out["parity_ok"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
