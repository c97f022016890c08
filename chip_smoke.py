#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (adaptersis_tpu_torch): builds the CUDA
kernels from this checkout, checks each against its plain PyTorch version,
drives the serving and the training path end to end, and times the kernels.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, one result line each:
  1. device, power limit, kernel build and its time;
  2. K3 forward-only attention vs flash_fwd_plain, bf16 and fp32, H=16
     Dh=64, N = 1765 and 1764 (the clean and the adapter walk), at batch 2
     (the serving path's) and 16 (the training path's);
  3. K1 deformable-attention forward vs msda_plain at the CAViT and CACNN
     geometries of ViT-L/14 at 588 px, batch 2 and 16, bf16 values, points
     partly outside;
  4. K2 deformable-attention backward vs autograd of msda_plain at the same
     geometries and batches, with a seeded fp32 incoming gradient;
  5. a narrow whole model (fp32, TF32 off), seeded: CPU (plain paths) vs
     CUDA (kernels), eval logits and metrics;
  6. the narrow model's training step, CPU vs CUDA: the augmentation (and
     CLAHE at 588 px), then on one augmented batch (made on the CPU) per
     step the loss, every trainable's gradient
     (non-zero on the card), the BatchNorm statistics, the parameters after
     2 SGD steps, and the kernel launches per step;
  7. the serving path at full width: `adaptersis_tpu_torch.evaluate`,
     vit_large, 588 px, bf16, batch 2, synthetic data; launches per forward
     (48 attention, 7 MSDA: the last round's CACNN output reaches no
     output and is not computed);
  8. the training path at full width: `adaptersis_tpu_torch.train_seg`,
     vit_large, 588 px, bf16, batch 16, one epoch of 8 steps, then
     validation; finite losses, every trainable changed, launches per step
     (48 attention, 7 MSDA forward, 7 MSDA backward), img/s and peak memory;
  9. kernel, plain and library times at the bf16 shapes of phases 2-4 (CUDA
     events), and each kernel's bound from the same inputs. The kernels line
     gives the training path's (batch 16) numbers.
Then a JSON line of the kernels, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import copy
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

FULL_BATCH, FULL_BATCHES = 2, 4        # the serving path's batch
TRAIN_BATCH = 16                        # the training path's batch
FLASH_SHAPES = [(B, 16, N, 64) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)]
# (name, value shape (B, S, M, D), Lq, level shapes, P) at ViT-L/14 @ 588 px
MSDA_CASES = [(f"{case} B={B}", (B, S, 8, 128), Lq, shapes, 4)
              for B in (FULL_BATCH, TRAIN_BATCH)
              for case, S, Lq, shapes in (("cavit", 6949, 1764, [(73, 73), (36, 36), (18, 18)]),
                                          ("cacnn", 1764, 6949, [(42, 42)]))]
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


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
    grad = torch.randn((B, Lq, M * D), generator=g)
    return value.cuda(), loc.cuda(), aw.reshape(B, Lq, M, L, P).cuda(), grad.cuda()


def valid_corners(loc, shapes) -> int:
    """Bilinear corners inside their level: the work MSDA does on this data."""
    n = 0
    for lvl, (H, W) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * W - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * H - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                n += int(((x0 + dx >= 0) & (x0 + dx < W) & (y0 + dy >= 0)
                          & (y0 + dy < H)).sum())
    return n


def bound_ms(nbytes: float, flops: float, kind: str):
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM bandwidth, or operations over
    the peak rate of their type, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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


def narrow_model():
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.train.convert import seeded_init_
    vit_kw = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2,
                  gelu_approx=True)
    return seeded_init_(AdapterSegmentor(DinoVisionTransformer(**vit_kw), encoder_inplanes=16,
                                         decoder_features=(128, 32, 16, 16, 8)), seed=0)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "adaptersis_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no adaptersis_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch import evaluate, train_seg
    from adaptersis_tpu_torch.data.augment import (
        apply_train_augment, draw_train_augment, draws_to)
    from adaptersis_tpu_torch.data.clahe import clahe_rgb
    from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
    from adaptersis_tpu_torch.ops import _build, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.train.convert import state_dict_to_flax
    from adaptersis_tpu_torch.train.trainer import Trainer, eval_step

    # every comparison below is against fp32 math: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts():
        ff.launches = mc.launches = mc.bwd_launches = 0

    def counts():
        return {"flash_fwd": ff.launches, "msda_fwd": mc.launches, "msda_bwd": mc.bwd_launches}

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
    with torch.no_grad():
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

    # ---- 3. deformable attention forward vs plain, on the card
    # both accumulate the same fp32 products of the same bf16 values; only
    # the order differs (≤ 48 terms of |aw·v| with Σaw = 1): 1e-5·max|v|
    msda_err = 0.0
    with torch.no_grad():
        for i, (case, vshape, Lq, shapes, P) in enumerate(MSDA_CASES):
            value, loc, aw, _ = msda_inputs(vshape, Lq, shapes, P, seed=10 + i)
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

    # ---- 4. deformable attention backward vs autograd of the plain version.
    # dvalue comes out in bf16 (the value's dtype): rounding to nearest is at
    # most half an ulp, ≤ 2⁻⁸·|dv|, on fp32 sums whose atomics run in a
    # changing order (≈ 1e-7 relative), so 2⁻⁸·max|dv|. dloc and daw are the
    # same fp32 products summed in another order: 1e-5 of their largest value
    bwd_err = 0.0
    for i, (case, vshape, Lq, shapes, P) in enumerate(MSDA_CASES):
        value, loc, aw, grad = msda_inputs(vshape, Lq, shapes, P, seed=20 + i)
        got = mc.msda_bwd(value, loc, aw, grad, shapes)
        torch.cuda.synchronize()
        leaves = [value.float().requires_grad_(), loc.clone().requires_grad_(),
                  aw.clone().requires_grad_()]
        want = torch.autograd.grad(mc.msda_plain(*leaves, shapes), leaves, grad)
        errs = {}
        for gname, g, w, rel in zip(("dvalue", "dloc", "daw"), got, want,
                                    (2.0 ** -8, 1e-5, 1e-5)):
            err = (g.float() - w).abs().max().item()
            bound = rel * w.abs().max().item()
            errs[gname] = {"max_abs_err": err, "bound": bound}
            if not err <= bound:
                fail(f"msda backward kernel disagrees with plain ({case}, {gname}): "
                     f"{err} > {bound}")
            bwd_err = max(bwd_err, err)
        if got[0].dtype != value.dtype:
            fail(f"msda backward returned dvalue in {got[0].dtype}, value is {value.dtype}")
        say("msda_bwd_check", case=case, value=list(vshape), Lq=Lq, levels=shapes, **errs)
        del value, loc, aw, grad, got, want, leaves
        torch.cuda.empty_cache()

    # ---- 5. narrow whole model: CPU plain paths vs CUDA kernels, fp32
    model = narrow_model()
    ds = SyntheticSeg(n=2, imsize=112, seed=5)
    imgs, masks = next(ds.batches(2))
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    cpu = eval_step(model.eval(), imgs, masks)
    reset_counts()
    gpu = eval_step(copy.deepcopy(model).cuda(), imgs.cuda(), masks.cuda())
    torch.cuda.synchronize()
    # 5 + 2 + 3 attention calls (clean walk, adapter prefix, 3 more blocks),
    # 4 CAViT + 3 CACNN MSDA calls
    small_launches = counts()
    scale = cpu["logits"].abs().max().item()
    err = (gpu["logits"].cpu() - cpu["logits"]).abs().max().item()
    bound = 1e-4 * scale        # fp32 on both; conv and GEMM orders differ
    metric_err = max(abs(float(gpu[k]) - float(cpu[k])) for k in ("loss", "dice"))
    say("small_slice", logits=list(cpu["logits"].shape), max_abs_err=err, bound=bound,
        metric_err=metric_err, launches=small_launches)
    if not err <= bound:
        fail(f"small slice: CUDA logits differ from CPU by {err} > {bound}")
    if not metric_err <= 1e-4 * max(1.0, float(cpu["loss"])):
        fail(f"small slice: CUDA metrics differ from CPU by {metric_err}")
    if small_launches != {"flash_fwd": 10, "msda_fwd": 7, "msda_bwd": 0}:
        fail(f"small slice: kernel launches {small_launches}, expected 10, 7 and 0")
    del model, cpu, gpu

    # ---- 6. narrow training step: CPU plain paths vs CUDA kernels, fp32
    base = narrow_model()
    trainers = {dev: Trainer(copy.deepcopy(base).to(dev), lr=0.05, epochs=4)
                for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(7)

    def compare_u8(a, b, max_255, share, what):
        diff = (a.float() - b.float().cpu()).abs() * (255.0 if a.is_floating_point() else 1.0)
        got = {"max_255": diff.max().item(), "share": (diff > 0.5).float().mean().item()}
        aug_diff[what] = got
        if not (got["max_255"] <= max_255 + 1e-3 and got["share"] < share):
            fail(f"narrow train step: {what} differs between CPU and CUDA: {got}")

    # the augmentation on the card against the CPU. Without CLAHE every
    # stage rounds to uint8, and an ulp of difference between the card's
    # and the CPU's pow can round a value on .5 the other way: ≤ 1/255 on
    # < 0.1 % of values. CLAHE at the main path's 588 px (tiles of 74²
    # pixels) goes through five pow/cbrt calls per pixel and two roundings
    # to 8 bits: where an ulp rounds a pixel's 8-bit L the other way, CLAHE
    # maps it through the neighbouring LUT entry, up to one histogram bin
    # (≤ clip·area/256 + 1 counts) × 255/area ≈ 4 levels away: ≤ 8 levels,
    # on < 1 % of values (0.11 % was measured on an H100; a wrong tile,
    # LUT or blend moves most of them)
    aug_diff = {}
    imgs, masks = (torch.from_numpy(a) for a in next(SyntheticSeg(n=2, imsize=112,
                                                                  seed=9).batches(2)))
    draws = draw_train_augment(gen, 2, 112, use_clahe=False)
    x, y = apply_train_augment(imgs, masks, draws)
    xg, yg = apply_train_augment(imgs.cuda(), masks.cuda(), draws_to(draws, torch.device("cuda")))
    compare_u8(x, xg, 1.0, 1e-3, "augment without CLAHE")
    if not torch.equal(yg.cpu(), y):
        fail("narrow train step: augmented masks differ between CPU and CUDA")
    big = torch.from_numpy(next(SyntheticSeg(n=2, imsize=588, seed=9).batches(2))[0])
    clip = torch.tensor([1.7, 3.9])
    compare_u8(clahe_rgb(big, clip), clahe_rgb(big.cuda(), clip.cuda()), 8.0, 1e-2,
               "CLAHE at 588 px")
    # the training batches get seeded pixel noise: the synthetic frames are
    # flat inside each shape, where the stem's max-pool meets exact ties,
    # and the card and the CPU route a tie's gradient to different inputs
    batches = []
    for imgs, masks in SyntheticSeg(n=4, imsize=112, seed=6).batches(2):
        noise = torch.randint(-20, 21, imgs.shape, generator=gen)
        imgs = (torch.from_numpy(imgs).int() + noise).clamp(0, 255).to(torch.uint8)
        x, y = apply_train_augment(imgs, torch.from_numpy(masks),
                                   draw_train_augment(gen, 2, 112))
        batches.append((x, y))
    reset_counts()
    step_report, grad_errs = [], []
    for epoch, (x, y) in enumerate(batches):
        loss = {dev: float(tr.step(x.to(dev), y.to(dev), epoch)) for dev, tr in trainers.items()}
        torch.cuda.synchronize()
        named = {dev: dict(tr.model.named_parameters()) for dev, tr in trainers.items()}
        trainable = [n for n in named["cpu"] if not n.startswith("backbone.")]
        got_grad = {dev: {n for n in trainable if named[dev][n].grad is not None}
                    for dev in named}
        if got_grad["cuda"] != set(trainable) or got_grad["cpu"] != set(trainable):
            fail(f"narrow train step {epoch}: trainables without a gradient: "
                 f"{sorted(set(trainable) - got_grad['cuda'] & got_grad['cpu'])}")
        # the feature decoder reads no c1: its projection's gradient is zero
        # (the trainer fills it in, so that weight decay applies as in optax)
        zero = {n for n in trainable if not named["cuda"][n].grad.abs().max() > 0}
        if zero != {"encoder.fc1.weight", "encoder.fc1.bias"}:
            fail(f"narrow train step {epoch}: zero gradients on the card: {sorted(zero)}")
        if epoch == 0:
            # same parameters on both devices: 2e-3 of each leaf's largest
            # gradient. fp32 with other conv and reduction orders and atomics
            # in K2 and in the resizes' backward give ≈ 1e-4; the sampling
            # offsets' gradient also jumps where a sample point crosses a
            # pixel edge, and a point within rounding of one takes the other
            # side's derivative on one device (9e-4 measured on an H100). A
            # gradient that vanishes analytically (a conv bias before a
            # training-mode BatchNorm) is held to 2e-6 of the step's largest
            top = max(named["cpu"][n].grad.abs().max().item() for n in trainable)
            for n in trainable:
                g_cpu, g_gpu = named["cpu"][n].grad, named["cuda"][n].grad.cpu()
                scale = max(g_cpu.abs().max().item(), 1e-3 * top)
                grad_errs.append(((g_gpu - g_cpu).abs().max().item() / scale, n))
            grad_errs.sort(reverse=True)
            grad_rel, n_grads = grad_errs[0][0], len(grad_errs)
            if not grad_rel <= 2e-3:
                fail(f"narrow train step: gradients differ, worst (share of scale, name): "
                     f"{grad_errs[:5]}")
        stats_err = 0.0
        bufs = {dev: dict(tr.model.named_buffers()) for dev, tr in trainers.items()}
        for n, b in bufs["cpu"].items():
            if n.endswith(("running_mean", "running_var")):
                e = (bufs["cuda"][n].cpu() - b).abs().max().item()
                stats_err = max(stats_err, e / max(1.0, b.abs().max().item()))
        step_report.append({"loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
                            "bn_stats_rel_err": stats_err})
        if not abs(loss["cuda"] - loss["cpu"]) <= 1e-5 * max(1.0, loss["cpu"]):
            fail(f"narrow train step {epoch}: loss {loss['cuda']} on the card, {loss['cpu']} "
                 "on the CPU")
        if not stats_err <= 1e-5:       # fp32 batch statistics, other reduction orders
            fail(f"narrow train step {epoch}: BatchNorm statistics differ by {stats_err}")
    train_small_launches = counts()
    param_err = max((p.detach().cpu() - named["cpu"][n].detach()).abs().max().item()
                    / (1.0 + named["cpu"][n].detach().abs().max().item())
                    for n, p in named["cuda"].items())
    say("small_train_step", steps=len(batches), augment_vs_cpu=aug_diff,
        steps_report=step_report,
        grad_max_rel_err=grad_rel, grads_compared=n_grads, grad_worst=grad_errs[:3],
        param_err_after_2_steps=param_err,
        launches=train_small_launches)
    if not param_err <= 1e-5:           # two lr·momentum updates of the gradients above
        fail(f"narrow train step: parameters differ by {param_err} after 2 steps")
    if train_small_launches != {"flash_fwd": 10 * 2, "msda_fwd": 7 * 2, "msda_bwd": 7 * 2}:
        fail(f"narrow train step: launches {train_small_launches}, expected 10, 7 and 7 "
             "per step")
    del base, trainers, named, bufs

    # ---- 7. the serving path at full width through its entry point
    reset_counts()
    stats = evaluate.main(["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
                           "--batch_size_per_gpu", str(FULL_BATCH),
                           "--val_images", str(FULL_BATCH * FULL_BATCHES),
                           "--bf16", "--gelu_approx", "--synthetic", "--seed", "0"])
    launches = counts()
    fwd = stats["batches"]
    say("full_width_serving", arch="vit_large", imsize=588, dtype="bf16", batch=FULL_BATCH,
        forwards=fwd, launches=launches,
        per_forward={k: v / fwd for k, v in launches.items()},
        loss=stats["loss"], dice=stats["dice"], acc1=stats["acc1"],
        logits_finite=stats["logits_finite"], img_per_s=stats["img_per_s"], device=name)
    if not stats["logits_finite"]:
        fail("full width: non-finite logits")
    if not all(math.isfinite(stats[k]) for k in ("loss", "dice", "acc1")):
        fail(f"full width: non-finite metrics {stats}")
    if launches != {"flash_fwd": 48 * fwd, "msda_fwd": 7 * fwd, "msda_bwd": 0}:
        fail(f"full width: launches {launches}, expected 48, 7 and 0 per forward × {fwd}")
    torch.cuda.empty_cache()

    # ---- 8. the training path at full width through its entry point; the
    # launches up to the first validation call are the train steps'
    out_dir = ROOT / "build" / "smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
            "--batch_size_per_gpu", str(TRAIN_BATCH), "--epochs", "1", "--bf16",
            "--gelu_approx", "--synthetic", "--seed", "0", "--output_dir", str(out_dir)]
    at_validation, val_calls = [], [0]
    plain_eval_step = Trainer.eval_step

    def eval_step_counted(self, *a, **kw):
        if not at_validation:
            at_validation.append(counts())
        val_calls[0] += 1
        return plain_eval_step(self, *a, **kw)

    Trainer.eval_step = eval_step_counted
    reset_counts()
    try:
        hist = train_seg.main(argv)
    finally:
        Trainer.eval_step = plain_eval_step
    train_launches = counts()
    epoch = hist[0]
    steps = len(epoch["train_losses"])
    in_train = at_validation[0] if at_validation else train_launches
    in_val = {k: train_launches[k] - in_train[k] for k in train_launches}
    # the trainables against their seeded start (the same draw train_seg made)
    init = evaluate.build_model(train_seg.get_args_parser().parse_args(argv))
    start = state_dict_to_flax({n: p for n, p in init.named_parameters()
                                if not n.startswith("backbone.")})["params"]
    unchanged = []
    with np.load(out_dir / "variables.npz") as f:
        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}/{k}")
                elif np.array_equal(f[f"{prefix}/{k}"], v):
                    unchanged.append(f"{prefix}/{k}")
        walk(start, "params")
    del init, start
    say("full_width_training", arch="vit_large", imsize=588, dtype="bf16", batch=TRAIN_BATCH,
        steps=steps, train_losses=epoch["train_losses"], train_loss=epoch["train_loss"],
        test_loss=epoch.get("test_loss"), test_dice=epoch.get("test_dice"),
        test_acc1=epoch.get("test_acc1"), launches_train=in_train,
        per_train_step={k: v / steps for k, v in in_train.items()},
        launches_validation=in_val, validation_forwards=val_calls[0],
        train_img_per_s=epoch["train_img_per_s"], peak_mem_bytes=epoch["peak_mem_bytes"],
        unchanged_trainables=unchanged, device=name,
        nvidia_smi=smi[0] if smi else "unavailable")
    if steps != 8 or not epoch["train_losses_finite"]:
        fail(f"full-width training: {steps} steps, losses {epoch['train_losses']}")
    if not all(math.isfinite(epoch.get(k, float("nan")))
               for k in ("test_loss", "test_dice", "test_acc1")):
        fail(f"full-width training: validation metrics not finite: {epoch}")
    if in_train != {"flash_fwd": 48 * steps, "msda_fwd": 7 * steps, "msda_bwd": 7 * steps}:
        fail(f"full-width training: launches {in_train} in {steps} steps, expected 48, 7 "
             "and 7 per step")
    if in_val != {"flash_fwd": 48 * val_calls[0], "msda_fwd": 7 * val_calls[0], "msda_bwd": 0}:
        fail(f"full-width training: validation launches {in_val} in {val_calls[0]} forwards")
    # every trainable moves, the c1 projection by weight decay alone
    if unchanged:
        fail(f"full-width training: trainables left unchanged: {unchanged}")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 9. kernel vs plain (and library) time at the main-path shapes
    # (plain in bf16 too), and each kernel's bound from the same inputs
    times, bounds = {}, {}
    with torch.no_grad():
        for shape in FLASH_SHAPES:
            q, k, v = flash_inputs(shape, seed=0)
            B, H, N, Dh = shape
            key = f"flash_fwd B={B} N={N}"
            times[key] = (cuda_ms(lambda: ff.flash_fwd(q, k, v, 0.125)),
                          cuda_ms(lambda: ff.flash_fwd_plain(q, k, v, 0.125)),
                          cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                              q, k, v, scale=0.125)))
            bounds[key] = bound_ms(4 * q.numel() * q.element_size(), 4 * B * H * N * N * Dh,
                                   "bf16")
        for i, (case, vshape, Lq, shapes, P) in enumerate(MSDA_CASES):
            value, loc, aw, grad = msda_inputs(vshape, Lq, shapes, P, seed=10 + i)
            D = vshape[3]
            corners = valid_corners(loc, shapes)
            small = (loc.numel() + aw.numel()) * 4
            key = f"msda_fwd {case}"
            times[key] = (cuda_ms(lambda: mc.msda_fwd(value, loc, aw, shapes)),
                          cuda_ms(lambda: mc.msda_plain(value, loc, aw, shapes)), None)
            bounds[key] = bound_ms(value.numel() * value.element_size() + small
                                   + grad.numel() * 4, 2 * D * corners, "fp32")
            key = f"msda_bwd {case}"
            with torch.enable_grad():
                leaves = [value.float().requires_grad_(), loc.clone().requires_grad_(),
                          aw.clone().requires_grad_()]
                out = mc.msda_plain(*leaves, shapes)
                plain = cuda_ms(lambda: torch.autograd.grad(out, leaves, grad,
                                                            retain_graph=True))
            times[key] = (cuda_ms(lambda: mc.msda_bwd(value, loc, aw, grad, shapes)), plain,
                          None)
            # reads value, loc, aw, g; writes dvalue (value's dtype), dloc, daw
            bounds[key] = bound_ms(2 * value.numel() * value.element_size() + 2 * small
                                   + grad.numel() * 4, 4 * D * corners, "fp32")
            del leaves, out
            torch.cuda.empty_cache()
    say("kernel_times", device=name, nvidia_smi=smi[0] if smi else "unavailable",
        ms={k: {"kernel": a, "plain": b, "library": c, "bound": bounds[k][0],
                "bound_by": bounds[k][1]} for k, (a, b, c) in times.items()})

    def on_path(key, prefix):
        return key.startswith(prefix) and f"B={TRAIN_BATCH}" in key

    def mean(prefix, i):
        vals = [v[i] for k, v in times.items() if on_path(k, prefix)]
        return None if None in vals else sum(vals) / len(vals)

    def mean_bound(prefix):
        vals = [b for k, b in bounds.items() if on_path(k, prefix)]
        return sum(t for t, _ in vals) / len(vals), vals[0][1]

    # per-call means over the training path's mix at batch 16: equal numbers
    # of calls at each attention length and of each MSDA case; launches of
    # the training run
    rows = []
    for kname, src, replaces, err in (
            ("flash_fwd", "flash_fwd.cu", "adaptersis_tpu/ops/flash_fwd.py:73", flash_err),
            ("msda_fwd", "msda_fwd.cu", "adaptersis_tpu/ops/msda_pallas.py:477", msda_err),
            ("msda_bwd", "msda_bwd.cu", "adaptersis_tpu/ops/msda_pallas.py:1305", bwd_err)):
        b_ms, b_by = mean_bound(kname)
        rows.append({"name": kname, "route": "cuda",
                     "source": f"adaptersis_tpu_torch/csrc/{src}", "replaces": replaces,
                     "launches": train_launches[kname], "max_abs_err": err,
                     "ms": mean(kname, 0), "plain_ms": mean(kname, 1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": mean(kname, 2)})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
