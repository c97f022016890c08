#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (adaptersis_tpu_torch): builds the CUDA
kernels from this checkout, checks each against its plain PyTorch version,
drives the serving path end to end, and times the kernels.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, one result line each:
  1. device, power limit, kernel build and its time;
  2. forward-only attention kernel vs flash_fwd_plain, bf16 and fp32,
     B=2 H=16 Dh=64, N = 1765 and 1764 (the clean and the adapter walk);
  3. deformable-attention kernel vs msda_plain at the CAViT and CACNN
     geometries of ViT-L/14 at 588 px, bf16 values, points partly outside;
  4. a narrow whole model (fp32, TF32 off), seeded: CPU (plain paths) vs
     CUDA (kernels), logits and metrics;
  5. `adaptersis_tpu_torch.evaluate` at full width: vit_large, 588 px, bf16,
     synthetic data; metrics finite, kernel launches counted per forward;
  6. kernel vs plain time at the shapes of phases 2-3 (CUDA events).
Then a JSON line of the kernels, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

FLASH_SHAPES = [(2, 16, 1765, 64), (2, 16, 1764, 64)]
# (name, value shape (B, S, M, D), Lq, level shapes, P) at ViT-L/14 @ 588 px
MSDA_CASES = [
    ("cavit", (2, 6949, 8, 128), 1764, [(73, 73), (36, 36), (18, 18)], 4),
    ("cacnn", (2, 1764, 8, 128), 6949, [(42, 42)], 4),
]
FULL_BATCH, FULL_BATCHES = 2, 4


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def flash_inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    # scores of std ≈ 2.25: peaked rows, so a mishandled key or tail shows
    q, k, v = (torch.randn(shape, generator=g) * s for s in (1.5, 1.5, 1.0))
    return [x.to(torch.bfloat16).cuda() for x in (q, k, v)]


def msda_inputs(vshape, Lq, shapes, P, seed):
    g = torch.Generator().manual_seed(seed)
    B, S, M, D = vshape
    L = len(shapes)
    value = torch.randn(vshape, generator=g).to(torch.bfloat16)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=g) * 1.2 - 0.1
    aw = torch.softmax(torch.randn((B, Lq, M, L * P), generator=g), -1)
    return value.cuda(), loc.cuda(), aw.reshape(B, Lq, M, L, P).cuda()


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "adaptersis_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no adaptersis_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch import evaluate
    from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.ops import _build, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.train.convert import seeded_init_
    from adaptersis_tpu_torch.train.trainer import eval_step

    # every comparison below is against fp32 math: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device and build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    lib_path = _build.build(force=True)
    _build.library()
    build_s = time.perf_counter() - t0
    say("device", name=name, count=torch.cuda.device_count(),
        nvidia_smi=smi[0] if smi else "unavailable", torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, library=lib_path.name)

    # ---- 2. forward-only attention vs plain, on the card; the plain version
    # runs on the same inputs in fp32. bf16 (the tensor-core path): P is
    # rounded to bf16 before P·V (≤ 2⁻⁹·max|v|) and the output to bf16
    # (≤ 2⁻⁹·|o|), so bound 2⁻⁸·(max|o| + max|v|). fp32 (the CUDA-core path):
    # summation order and exp rounding only, bound 1e-5·(max|o| + max|v|)
    flash_err = 0.0
    for dtype, rel in ((torch.bfloat16, 2.0 ** -8), (torch.float32, 1e-5)):
        for i, shape in enumerate(FLASH_SHAPES):
            q, k, v = (x.to(dtype) for x in flash_inputs(shape, seed=i))
            out = ff.flash_fwd(q, k, v, 0.125)
            torch.cuda.synchronize()
            ref = ff.flash_fwd_plain(q.float(), k.float(), v.float(), 0.125)
            err = (out.float() - ref).abs().max().item()
            bound = rel * (ref.abs().max().item() + v.float().abs().max().item())
            say("flash_fwd_check", dtype=str(dtype), shape=list(shape), max_abs_err=err,
                bound=bound)
            if not err <= bound:
                fail(f"flash_fwd kernel disagrees with plain at {shape} {dtype}: "
                     f"{err} > {bound}")
            if dtype == torch.bfloat16:
                flash_err = max(flash_err, err)

    # ---- 3. deformable attention vs plain, on the card
    # both accumulate the same fp32 products of the same bf16 values; only
    # the order differs (≤ 48 terms of |aw·v| with Σaw = 1): 1e-5·max|v|
    msda_err = 0.0
    for i, (case, vshape, Lq, shapes, P) in enumerate(MSDA_CASES):
        value, loc, aw = msda_inputs(vshape, Lq, shapes, P, seed=10 + i)
        out = mc.msda_fwd(value, loc, aw, shapes)
        torch.cuda.synchronize()
        ref = mc.msda_plain(value, loc, aw, shapes)
        err = (out - ref).abs().max().item()
        bound = 1e-5 * max(1.0, value.float().abs().max().item())
        outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        say("msda_check", case=case, value=list(vshape), Lq=Lq, levels=shapes,
            points_outside=outside, max_abs_err=err, bound=bound)
        if not err <= bound:
            fail(f"msda kernel disagrees with plain ({case}): {err} > {bound}")
        msda_err = max(msda_err, err)

    # ---- 4. narrow whole model: CPU plain paths vs CUDA kernels, fp32
    vit_kw = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2,
                  gelu_approx=True)
    model = seeded_init_(AdapterSegmentor(DinoVisionTransformer(**vit_kw),
                                          encoder_inplanes=16,
                                          decoder_features=(128, 32, 16, 16, 8)), seed=0)
    ds = SyntheticSeg(n=2, imsize=112, seed=5)
    imgs, masks = next(ds.batches(2))
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    cpu = eval_step(model.eval(), imgs, masks)
    ff.launches = mc.launches = 0
    gpu = eval_step(copy.deepcopy(model).cuda(), imgs.cuda(), masks.cuda())
    torch.cuda.synchronize()
    # 5 + 2 + 3 attention calls (clean walk, adapter prefix, 3 more blocks), 8 MSDA
    small_launches = (ff.launches, mc.launches)
    scale = cpu["logits"].abs().max().item()
    err = (gpu["logits"].cpu() - cpu["logits"]).abs().max().item()
    bound = 1e-4 * scale        # fp32 on both; conv and GEMM orders differ
    metric_err = max(abs(float(gpu[k]) - float(cpu[k])) for k in ("loss", "dice"))
    say("small_slice", logits=list(cpu["logits"].shape), max_abs_err=err, bound=bound,
        metric_err=metric_err, launches={"flash_fwd": small_launches[0],
                                         "msda_fwd": small_launches[1]})
    if not err <= bound:
        fail(f"small slice: CUDA logits differ from CPU by {err} > {bound}")
    if not metric_err <= 1e-4 * max(1.0, float(cpu["loss"])):
        fail(f"small slice: CUDA metrics differ from CPU by {metric_err}")
    if small_launches != (10, 8):
        fail(f"small slice: kernel launches {small_launches}, expected (10, 8)")
    del model, cpu, gpu

    # ---- 5. the serving path at full width through its entry point
    ff.launches = mc.launches = 0
    stats = evaluate.main(["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
                           "--batch_size_per_gpu", str(FULL_BATCH),
                           "--val_images", str(FULL_BATCH * FULL_BATCHES),
                           "--bf16", "--gelu_approx", "--synthetic", "--seed", "0"])
    launches = {"flash_fwd": ff.launches, "msda_fwd": mc.launches}
    fwd = stats["batches"]
    say("full_width", arch="vit_large", imsize=588, dtype="bf16", batch=FULL_BATCH,
        forwards=fwd, launches=launches,
        per_forward={k: v / fwd for k, v in launches.items()},
        loss=stats["loss"], dice=stats["dice"], acc1=stats["acc1"],
        logits_finite=stats["logits_finite"], img_per_s=stats["img_per_s"], device=name)
    if not stats["logits_finite"]:
        fail("full width: non-finite logits")
    if not all(math.isfinite(stats[k]) for k in ("loss", "dice", "acc1")):
        fail(f"full width: non-finite metrics {stats}")
    if launches != {"flash_fwd": 48 * fwd, "msda_fwd": 8 * fwd}:
        fail(f"full width: launches {launches}, expected 48 and 8 per forward × {fwd}")

    # ---- 6. kernel vs plain time at the main-path shapes (plain in bf16 too)
    saved = (ff.launches, mc.launches)
    times = {}
    for shape in FLASH_SHAPES:
        q, k, v = flash_inputs(shape, seed=0)
        times[f"flash_fwd N={shape[2]}"] = (cuda_ms(lambda: ff.flash_fwd(q, k, v, 0.125)),
                                            cuda_ms(lambda: ff.flash_fwd_plain(q, k, v, 0.125)))
    for i, (case, vshape, Lq, shapes, P) in enumerate(MSDA_CASES):
        value, loc, aw = msda_inputs(vshape, Lq, shapes, P, seed=10 + i)
        times[f"msda_fwd {case}"] = (cuda_ms(lambda: mc.msda_fwd(value, loc, aw, shapes)),
                                     cuda_ms(lambda: mc.msda_plain(value, loc, aw, shapes)))
    ff.launches, mc.launches = saved
    say("kernel_times", device=name, nvidia_smi=smi[0] if smi else "unavailable",
        ms={k: {"kernel": a, "plain": b} for k, (a, b) in times.items()})

    def mean(prefix, i):
        vals = [v[i] for k, v in times.items() if k.startswith(prefix)]
        return sum(vals) / len(vals)

    # per-call means over the forward's mix: 24 calls at each N; 4 of each MSDA case
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "adaptersis_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "adaptersis_tpu/ops/flash_fwd.py:73", "launches": launches["flash_fwd"],
         "max_abs_err": flash_err, "ms": mean("flash_fwd", 0), "plain_ms": mean("flash_fwd", 1)},
        {"name": "msda_fwd", "route": "cuda", "source": "adaptersis_tpu_torch/csrc/msda_fwd.cu",
         "replaces": "adaptersis_tpu/ops/msda_pallas.py:477", "launches": launches["msda_fwd"],
         "max_abs_err": msda_err, "ms": mean("msda_fwd", 0), "plain_ms": mean("msda_fwd", 1)},
    ]}), flush=True)
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
