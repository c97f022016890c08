"""Serving throughput of the port's deployed configuration: the counterpart
of the JAX package's `tools/bench_infer.py`.

    python -m adaptersis_tpu_torch.bench_infer    # ViT-L/14 @ 588 px, batch 16

An AdapterSegmentor cast to bf16 for inference (`cast_for_inference`:
pos_embed stays fp32) with seeded weights: each step takes one fixed batch
of uint8 images from `np.random.default_rng(0)`, staged on the device,
divides by 255, runs the forward (kernels K1, K3, K4, K5, K6) and takes the
argmax mask as uint8. 2 warm-up steps, then `--repeats` windows of
`--steps` steps, each ending in a synchronise on the last mask; the median
window is reported.

Prints one JSON line: metric, value (img/s), unit, ms_batch, batch, spread
(the slowest and fastest window) and the device's name.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from .bench import build_model, device_name, get_args_parser, setup, timed_windows
from .train.trainer import cast_for_inference


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_args_parser("adaptersis-torch-bench-infer").parse_args(argv)
    device = setup(args)
    model = cast_for_inference(build_model(args), torch.bfloat16).to(device).eval()
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (args.batch, args.imsize, args.imsize, 3),
                                         np.uint8)).to(device)

    @torch.no_grad()
    def step() -> torch.Tensor:
        logits = model(imgs.float() / 255.0)
        return logits.argmax(dim=-1).to(torch.uint8)[0, 0, 0]

    rates = timed_windows(step, args)
    value = sorted(rates)[len(rates) // 2]
    result = {"metric": f"{args.arch}_{args.imsize}_adapter_inference_images_per_sec_per_gpu",
              "value": value, "unit": "img/s/gpu", "ms_batch": 1000.0 * args.batch / value,
              "batch": args.batch, "spread": [min(rates), max(rates)],
              "device": device_name(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
