#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (adaptersis_tpu_torch): builds the CUDA
kernels from this checkout, checks each against its plain PyTorch version,
drives the serving and the training path end to end, and times the kernels.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, one result line each (with the
seconds since the start):
  1. device, power limit, kernel build and its time;
  2. K3 forward-only attention vs flash_fwd_plain, bf16 and fp32, H=16
     Dh=64, N = 1765 and 1764 (the clean and the adapter walk), at batch 2
     (the serving path's) and 16 (the training path's);
  3. K1 deformable-attention forward vs msda_plain at the CAViT and CACNN
     geometries of ViT-L/14 at 588 px, batch 2 and 16, bf16 values, points
     partly outside;
  4. K2 deformable-attention backward vs autograd of msda_plain at the same
     geometries and batches, with a seeded fp32 incoming gradient;
  4b. K6 LayerNorm, K4 fused LN → qkv → head split and K5 fused LN → MLP →
     LayerScale → residual vs their plain versions, bf16 and fp32, C = 1024,
     H = 16, N = 1765 and 1764, batch 2 and 16, rows with non-zero means and
     unequal scales, parameters stored in bf16 and in fp32; K5 per element;
  4c. K7 flash attention with segment ids vs its plain version, bf16 and
     fp32, each element against a bound from its own terms: the forward
     (output and logsumexp), dq, dk and dv through autograd with a seeded
     incoming gradient, and the backward kernels alone on the plain
     forward's o and lse (bf16: at most 5 % of the elements may differ), at
     the SSL step's shapes (ViT-S/14, batch 32): the student's packed rows
     (64, 6, 457, 64), segments 257 + 4 × 50, the teacher's (64, 6, 257, 64)
     without ids, and interleaved ids at scale 0.1; planted faults must
     fail: no segment ids, di = 0, p and ds not rounded to bf16, and q
     scaled before q·kᵀ;
  5. a narrow whole model (fp32, TF32 off), seeded: CPU (plain paths) vs
     CUDA (kernels), eval logits and metrics, and the launches per forward
     (10 K3, 7 K1, 10 K4, 10 K5, 4 K6);
  6. the narrow model's training step, CPU vs CUDA: the augmentation (and
     CLAHE at 588 px), then on one augmented batch (made on the CPU) per
     step the loss, every trainable's gradient
     (non-zero on the card), the BatchNorm statistics, the parameters after
     2 SGD steps, and the kernel launches per step;
  6b. a narrow SSL step (fp32, TF32 off), CPU (plain) vs CUDA (kernels),
     2 steps from the same seeded weights, augmented crops (made on the
     CPU) and masks: loss and parts, every student gradient (non-zero on
     the card), the teacher after the EMA, both centres, K7 launches;
  7. the serving path at full width: `adaptersis_tpu_torch.evaluate`,
     vit_large, 588 px, bf16, batch 2, synthetic data; launches per forward
     (48 attention, 7 MSDA: the last round's CACNN output reaches no
     output and is not computed; 48 K4, 48 K5, 4 K6);
  8. the training path at full width: `adaptersis_tpu_torch.train_seg`,
     vit_large, 588 px, bf16, batch 16, one epoch of 8 steps, then
     validation; finite losses, every trainable changed, launches per step
     (48 attention, 7 MSDA forward, 7 MSDA backward, 48 K4, 48 K5, 4 K6),
     img/s and peak memory;
  8b. the deployed configuration's entry points at their defaults (ViT-L/14
     at 588 px, bf16, batch 16): `adaptersis_tpu_torch.bench` (train step)
     and `adaptersis_tpu_torch.bench_infer` (forward + argmax), their JSON
     lines, finite values and launches per step;
  8c. the SSL slice's entry points at full width (ViT-S/14, batch 32,
     bf16, 65536 prototypes): `adaptersis_tpu_torch.bench_ssl` at its
     defaults and `adaptersis_tpu_torch.pretrain --bf16 --synthetic
     --epochs 1 --steps_per_epoch 4 --warmup_epochs 0`: finite losses,
     every student parameter changed (but the last layer, frozen for the
     first epoch), the teacher moved, 24 K7 forwards and 12 K7 backwards per
     step, img/s, MFU and peak memory;
  9. kernel, plain and library times at the bf16 shapes of phases 2-4c (CUDA
     events), and each kernel's bound from the same inputs; for K4 and K5
     also the unfused PyTorch sequence they replace and cuBLAS's GEMMs
     alone; for K7 PyTorch's SDPA with the boolean block-diagonal mask,
     forward and backward. The kernels line gives the training path's
     (batch 16) numbers and the launches of `bench`'s run for K1-K6, the
     SSL step's numbers and the launches of `bench_ssl`'s run for K7.
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
# the frozen walks' token blocks (B, N, C) of ViT-L/14 at 588 px, 16 heads
ROW_SHAPES = [(B, N, 1024) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)]
HEADS = 16
# K7 at the SSL step's shapes (ViT-S/14, batch 32: 64 global crops, 6 heads):
# the student packs a global crop (257 tokens) with 4 local crops (50 each)
SSL_BATCH = 32
STUDENT_SEGMENTS, TEACHER_N = [257, 50, 50, 50, 50], 257
K7_SHAPES = {"student": (2 * SSL_BATCH, 6, sum(STUDENT_SEGMENTS), 64),
             "teacher": (2 * SSL_BATCH, 6, TEACHER_N, 64)}
# per SSL step at ViT-S/14 (12 blocks): the teacher's and the student's
# forwards, the student's backward
SSL_PER_STEP = {"flash_attn": 24, "flash_attn_bwd": 12}
# per forward at full width: attention, MSDA forward, K4, K5, K6
PER_FORWARD = {"flash_fwd": 48, "msda_fwd": 7, "fused_ln_qkv": 48, "fused_ln_mlp": 48,
               "layernorm": 4}
T0 = time.perf_counter()
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
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **kw}), flush=True)


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


def row_inputs(shape, dtype, seed, params_dtype=torch.float32):
    """x with non-zero row means and unequal row scales (the fast variance
    E[x²] − E[x]² cancels digits where |mean| ≫ std), LayerNorm parameters,
    the qkv and MLP weights ~ N(0, 1/fan_in) in x's dtype (the frozen
    backbone's), biases ~ N(0, 0.1²), γ ~ N(0, 0.1²); the (n,) parameters
    in `params_dtype` (bf16 as a frozen bf16 backbone stores them)."""
    g = torch.Generator().manual_seed(seed)
    B, N, C = shape

    def rn(*s):
        return torch.randn(s, generator=g)

    x = rn(B, N, C) * (0.5 + 1.5 * torch.rand((B, N, 1), generator=g)) + 0.5 * rn(B, N, 1)
    p = {"ln_w": 1 + 0.1 * rn(C), "ln_b": 0.1 * rn(C),
         "w": (rn(3 * C, C) / math.sqrt(C)).to(dtype), "b": 0.1 * rn(3 * C),
         "w1": (rn(4 * C, C) / math.sqrt(C)).to(dtype), "b1": 0.1 * rn(4 * C),
         "w2": (rn(C, 4 * C) / math.sqrt(4 * C)).to(dtype), "b2": 0.1 * rn(C),
         "gamma": 0.1 * rn(C)}
    return x.to(dtype).cuda(), {k: (v if v.dim() == 2 else v.to(params_dtype)).cuda()
                                for k, v in p.items()}


def ulp(v, dtype):
    """The spacing of `dtype` (bf16 or fp32) at |v|, elementwise."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - bits)


def mlp_allowance(x, ref, p, ln, fm):
    """Per-element bound on |K5 − plain| (phase 4b). Both round the same
    fp32 x + γ·y once to x's dtype: where the two fp32 values straddle a
    rounding point they differ by one ulp of |ref| + ε, so the bound is
    ulp(|ref| + ε) + ε, with ε the largest difference of the fp32 γ·y.
    bf16: both round the hidden h to bf16, and where their fp32 h straddle
    a rounding point the two differ by ulp(h). Taking every one of a row's
    Hd roundings as flipped, with random signs, y_ri moves by a sum of
    ±ulp(h_rj)·w2_ij of standard deviation u_r·rms(w2), u_r = √Σ_j ulp(h_rj)²;
    ε_ri = 6 such deviations × |γ_i|. fp32: the same dot products in other
    orders, from h that differ by fc1's order and the fast variance's
    cancellation (≈ 20 u carried into xn): ε_ri = 2e-5·|γ_i|·Σ_j |h_rj|·|w2_ij|
    (≈ 335 u of the dot product's absolute sum). This is held per element,
    so a γ·y that is wrong by more than ε fails where |out| is small, not
    only against the residual x, which passes through. One flipped output
    rounding reads ulp/(ulp + ε) of its bound, just under 1; two read ≈ 2."""
    dt = x.dtype
    xn = ln.ln_rows(x, p["ln_w"], p["ln_b"], 1e-6).to(dt).float()
    h = fm.gelu_tanh(xn @ p["w1"].float().t() + p["b1"].float())
    w2, gamma = p["w2"].float(), p["gamma"].float().abs()
    if dt == torch.bfloat16:
        u_r = ulp(h, dt).square().sum(-1, keepdim=True).sqrt()
        eps = 6 * u_r * w2.square().mean().sqrt() * gamma
    else:
        eps = 2e-5 * gamma * (h.abs() @ w2.abs().t())
    eps = eps.view(ref.shape)
    return ulp(ref.float().abs() + eps, dt) + eps


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


def packed_ids(B: int, segments, device="cuda") -> torch.Tensor:
    """(B, N) int32 segment ids: segment i is `segments[i]` consecutive tokens."""
    ids = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(segments)])
    return ids[None].expand(B, -1).contiguous().to(device)


def k7_inputs(shape, dtype, seed):
    """q, k, v (scores of std ≈ 2.25: peaked rows, so a mishandled segment
    shows) and a seeded incoming gradient."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g) * s for s in (1.5, 1.5, 1.0))
    do = torch.randn(shape, generator=g)
    return [x.to(dtype).cuda() for x in (q, k, v, do)]


def k7_outputs(fa, q, k, v, do, seg, plain: bool, scale: float):
    """(o, lse, dq, dk, dv): through flash_attn's autograd (the kernels) or
    through autograd of flash_attn_plain."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = (fa.flash_attn_plain if plain else fa.flash_attn)(*leaves, scale, seg)
    o.backward(do)
    lse = (fa.flash_attn_fwd_plain if plain else fa.flash_attn_fwd_kernel)(q, k, v, scale, seg)[1]
    return [o.detach(), lse] + [x.grad for x in leaves]


def k7_allowances(fa, q, k, v, do, seg, ref, scale: float):
    """Per-element bounds on |kernel − plain|, from the plain pass `ref` =
    (o, lse, dq, dk, dv): {"fwd": [o, lse], "through": [dq, dk, dv] when the
    backward ran on the kernel's own o and lse, "alone": [dq, dk, dv] when
    it ran on the plain forward's}. Each is ulp(|ref| + ε) + ε: where the
    two fp32 values straddle a rounding point of the output's dtype they
    differ by one ulp of |ref| + ε. ε sums what each term of that output
    may differ by, so it follows the element's own terms:
      o = Σ_j p_ij·v_j: bf16, the kernel rounds each unnormalised p to bf16
        before p·v, the plain version the normalised p (the library's
        one-tile path), ≤ 2⁻⁸ of the term each: ε = (2⁻⁷ + 2⁻¹⁵)·Σ_j p_ij·
        |v_j|, 2⁻¹⁵ for summation orders (≈ 457 fp32 ulps); fp32 2⁻¹⁵·Σ.
      lse: fp32 in both, 2e-6·max|lse|.
      dv = Σ_i p_ij·do_i, dq = Σ_j ds_ij·k_j, dk = Σ_i ds_ij·q_i: both round
        p and ds at the same points (bf16), each from fp32 values that
        differ by Δ; a flipped rounding moves the term by one ulp, ≤ 2⁻⁷ of
        it: ε = (2⁻⁷ + 2⁻¹⁵)·Σ|term| + Σ Δ·|other factor| (fp32: no 2⁻⁷).
        Δp ≤ p·r with r = 2⁻¹⁶ (the exponent's fp32 error), plus the lse
        bound when the backward ran on the kernel's lse; Δds ≤ p·scale·
        (r·(Σ_d |do_d|·|v_d| + |di|) + Δdi), Δdi = Σ_d (o's bound)·|do_d|
        when it ran on the kernel's o, else 0.
    A planted fault that every term shares (di = 0, a dropped mask) moves
    an output by far more; one of half an ulp per term (ds or p not rounded)
    stays inside these sums, and the share of differing elements catches it
    (`K7_DIFFER_SHARE`)."""
    f = (2.0 ** -7 if q.dtype == torch.bfloat16 else 0.0) + 2.0 ** -15
    lse = ref[1]
    qa, ka, va, doa = (x.float().abs() for x in (q, k, v, do))

    def bound(r, e):
        return ulp(r.float().abs() + e, r.dtype) + e

    def t(x):
        return x.transpose(-1, -2)

    with torch.no_grad():
        p = torch.exp(fa._scores(q, k, scale, seg) - lse[..., None])
        fwd = [bound(ref[0], f * (p @ va)),
               bound(lse, torch.full_like(lse, 2e-6 * lse.abs().max().item()))]
        di = (ref[0].float() * do.float()).sum(-1, keepdim=True)
        ds = ((do.float() @ t(v.float()) - di) * p * scale).abs_()
        # p·scale·(Σ_d |do_d|·|v_d| + |di|): what Δds scales with
        a = (doa @ t(va)).add_(di.abs()).mul_(p * scale)
        out = {"fwd": fwd}
        for name, r, d_di in (("alone", 2.0 ** -16, 0.0),
                              ("through", 2.0 ** -16 + fwd[1][..., None],
                               (fwd[0] * doa).sum(-1, keepdim=True))):
            dsd = a * r + p * (scale * d_di)
            out[name] = [bound(ref[2], f * (ds @ ka) + dsd @ ka),
                         bound(ref[3], f * (t(ds) @ qa) + t(dsd) @ qa),
                         bound(ref[4], t(p * (f + r)) @ doa)]
            del dsd
        del p, ds, a
    return out


K7_NAMES = ("o", "lse", "dq", "dk", "dv")
# bf16, the backward alone on the plain forward's o and lse: the share of
# dq, dk and dv elements that may differ from the plain version at all. The
# fp32 values differ only by summation order and the exponent's error
# (≈ 2⁻¹⁹ of p), so one p or ds rounding in ≈ 10³ flips, and an output's own
# rounding flips rarer still: well under 1 % differ. A kernel that skips the
# rounding of ds (or p) is off by up to half an ulp in every term, which
# moves a quarter or more of the outputs by an ulp.
K7_DIFFER_SHARE = 0.05


def k7_worst(names, got, ref, allow):
    """Each output's largest error, largest share of its bound, and the
    share of its elements that differ at all."""
    out = {}
    for name, a, b, w in zip(names, got, ref, allow):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"flash_attn {name}: {tuple(a.shape)} {a.dtype}, plain {tuple(b.shape)} {b.dtype}")
        d = (a.float() - b.float()).abs()
        out[name] = {"max_abs_err": d.max().item(), "worst_share_of_bound": (d / w).max().item(),
                     "differing_share": (a != b).float().mean().item()}
    return out


def check_k7(fa) -> dict:
    """Phase 4c: K7 against its plain version on the same inputs, per
    element (`k7_allowances`): the forward, the backward through the
    kernels' own forward (autograd of flash_attn against autograd of
    flash_attn_plain), and the backward kernels alone on the plain forward's
    o and lse, whose bf16 outputs must also differ in at most
    `K7_DIFFER_SHARE` of their elements. At the student's bf16 shape
    deliberately wrong kernel inputs must fail: no segment ids (a dropped
    mask), o = 0 (so di = 0), and the fp32 kernels on the same values (p
    and ds not rounded to bf16); in the interleaved case, whose scale 0.1
    is no power of two, q scaled and rounded before the product. Returns
    the largest bf16 errors at the SSL step's shapes, forward and backward."""
    k7_err = {"fwd": 0.0, "bwd": 0.0}
    cases = [(name, shape, packed_ids(shape[0], STUDENT_SEGMENTS) if name == "student" else None,
              0.125) for name, shape in K7_SHAPES.items()]
    inter = torch.randint(0, 5, (8, 457), generator=torch.Generator().manual_seed(3),
                          dtype=torch.int32).cuda()
    cases.append(("interleaved ids", (8, 6, 457, 64), inter, 0.1))
    bwd = K7_NAMES[2:]

    def caught(report, names, key):
        """The planted fault must exceed a bound on every one of `names`."""
        return all(report[n][key] > (1.0 if key == "worst_share_of_bound" else K7_DIFFER_SHARE)
                   for n in names)

    for dtype in (torch.bfloat16, torch.float32):
        for i, (case, shape, seg, scale) in enumerate(cases):
            q, k, v, do = k7_inputs(shape, dtype, seed=40 + i)
            got = k7_outputs(fa, q, k, v, do, seg, plain=False, scale=scale)
            torch.cuda.synchronize()
            ref = k7_outputs(fa, q, k, v, do, seg, plain=True, scale=scale)
            alone = list(fa.flash_attn_bwd_kernel(q, k, v, ref[0], ref[1], do, scale, seg))
            allow = k7_allowances(fa, q, k, v, do, seg, ref, scale)
            report = {"fwd": k7_worst(K7_NAMES[:2], got[:2], ref[:2], allow["fwd"]),
                      "bwd_through_kernel_forward": k7_worst(bwd, got[2:], ref[2:],
                                                             allow["through"]),
                      "bwd_alone": k7_worst(bwd, alone, ref[2:], allow["alone"])}
            planted = {}
            if case == "student" and dtype == torch.bfloat16:
                wrong = k7_outputs(fa, q, k, v, do, None, plain=False, scale=scale)
                r = {**k7_worst(K7_NAMES[:2], wrong[:2], ref[:2], allow["fwd"]),
                     **k7_worst(bwd, wrong[2:], ref[2:], allow["through"])}
                planted["dropped_segment_mask"] = (r, caught(r, K7_NAMES, "worst_share_of_bound"))
                wrong = fa.flash_attn_bwd_kernel(q, k, v, torch.zeros_like(ref[0]), ref[1], do,
                                                 scale, seg)
                r = k7_worst(bwd, wrong, ref[2:], allow["alone"])
                planted["di_zero"] = (r, caught(r, ("dq", "dk"), "worst_share_of_bound"))
                wrong = [x.to(dtype) for x in fa.flash_attn_bwd_kernel(
                    q.float(), k.float(), v.float(), ref[0].float(), ref[1], do.float(),
                    scale, seg)]
                r = k7_worst(bwd, wrong, ref[2:], allow["alone"])
                planted["p_ds_not_rounded"] = (r, caught(r, bwd, "differing_share"))
            if case == "interleaved ids" and dtype == torch.bfloat16:
                wrong = fa.flash_attn_fwd_kernel((q.float() * scale).to(dtype), k, v, 1.0, seg)
                r = k7_worst(K7_NAMES[:2], wrong, ref[:2], allow["fwd"])
                planted["scale_before_qk"] = (r, caught(r, ("lse",), "worst_share_of_bound"))
            if planted:
                report["planted_faults"] = {n: {**r, "caught": c} for n, (r, c) in planted.items()}
            say("flash_attn_check", case=case, dtype=str(dtype), shape=list(shape), scale=scale,
                **report)
            for n, (_, c) in planted.items():
                if not c:
                    fail(f"flash_attn: the bound passes a planted fault ({n}, {case})")
            for part, names in (("fwd", K7_NAMES[:2]), ("bwd_through_kernel_forward", bwd),
                                ("bwd_alone", bwd)):
                for n in names:
                    r = report[part][n]
                    if not r["worst_share_of_bound"] <= 1.0:
                        fail(f"flash_attn kernel disagrees with plain ({case}, {dtype}, {part}, "
                             f"{n}): {r['worst_share_of_bound']} of its bound")
                    if (dtype == torch.bfloat16 and part == "bwd_alone"
                            and not r["differing_share"] <= K7_DIFFER_SHARE):
                        fail(f"flash_attn backward differs from plain in {r['differing_share']} "
                             f"of {n}'s elements ({case}): above {K7_DIFFER_SHARE}")
            if dtype == torch.bfloat16 and case in K7_SHAPES:
                k7_err["fwd"] = max(k7_err["fwd"], report["fwd"]["o"]["max_abs_err"])
                k7_err["bwd"] = max(k7_err["bwd"],
                                    *(report["bwd_through_kernel_forward"][n]["max_abs_err"]
                                      for n in bwd))
            del q, k, v, do, got, ref, alone, allow
            torch.cuda.empty_cache()
    return k7_err


def own_segment_pairs(B: int, H: int, segments) -> int:
    """Query-key pairs of own segments: the attention work these ids need."""
    return B * H * sum(n * n for n in segments)


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
    from adaptersis_tpu_torch import bench, bench_infer, bench_ssl, evaluate, pretrain, train_seg
    from adaptersis_tpu_torch.data.augment import (
        apply_train_augment, draw_train_augment, draws_to)
    from adaptersis_tpu_torch.data.clahe import clahe_rgb
    from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
    from adaptersis_tpu_torch.ops import _build, flash_attn as fa, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.ops import fused_mlp as fm, fused_qkv as fq, layernorm as ln
    from adaptersis_tpu_torch.models.layers import TRAINED
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.ssl.augment import apply_multicrop, draw_multicrop
    from adaptersis_tpu_torch.ssl.masking import MaskingGenerator, collate_masks_with_indices
    from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to
    from adaptersis_tpu_torch.train.convert import seeded_init_, state_dict_to_flax
    from adaptersis_tpu_torch.train.trainer import Trainer, eval_step

    # every comparison below is against fp32 math: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts():
        ff.launches = mc.launches = mc.bwd_launches = fq.launches = fm.launches = 0
        ln.launches = fa.launches = fa.bwd_launches = 0

    def counts():
        return {"flash_fwd": ff.launches, "msda_fwd": mc.launches, "msda_bwd": mc.bwd_launches,
                "fused_ln_qkv": fq.launches, "fused_ln_mlp": fm.launches,
                "layernorm": ln.launches, "flash_attn": fa.launches,
                "flash_attn_bwd": fa.bwd_launches}

    def expect(forwards, backwards):
        """Launches of `forwards` full-width forwards and `backwards` MSDA
        backwards (the segmentation paths run no K7)."""
        return {**{k: v * forwards for k, v in PER_FORWARD.items()}, "msda_bwd": backwards,
                "flash_attn": 0, "flash_attn_bwd": 0}

    def expect_ssl(steps, per_step=SSL_PER_STEP):
        """Launches of `steps` SSL steps: K7 only."""
        return {**{k: 0 for k in counts()}, **{k: v * steps for k, v in per_step.items()}}

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

    # ---- 4b. K6, K4 and K5 vs their plain versions on the same inputs, on
    # the card; in bf16 the (n,) parameters are bf16 (as the frozen
    # backbone stores them) at N = 1765 and fp32 at N = 1764. bf16: the
    # kernels and the plain versions compute the same fp32 values up to
    # summation order and rsqrt's last bits, then round once to bf16; where
    # the two fp32 values straddle a rounding point they differ by one ulp
    # ≤ 2⁻⁷·|out|: bound 2⁻⁷·max|out| for K6. K4 also rounds xn = LN(x) to
    # bf16 before its product, and a few xn per row (≈ 0.25 expected at a
    # 1e-6 relative difference over 1024) may round the other way, each
    # moving an output by ≤ 2⁻⁷·|xn|·|w|: up to four of them,
    # + 2⁻⁵·max|xn|·max|w|. fp32 (K6, K4): the same products in other
    # orders and the fast variance's cancellation (E[x²]/var ≤ ≈ 20 on these
    # rows, ≈ 1e-6·20 of the output's scale): 1e-4·max|out|. K5 is held per
    # element: `mlp_allowance`
    row_err = {"layernorm": 0.0, "fused_ln_qkv": 0.0, "fused_ln_mlp": 0.0}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            bf = dtype == torch.bfloat16
            for i, shape in enumerate(ROW_SHAPES):
                pdt = torch.bfloat16 if bf and shape[1] == 1765 else torch.float32
                x, p = row_inputs(shape, dtype, seed=30 + i, params_dtype=pdt)
                xn = ln.ln_rows(x, p["ln_w"], p["ln_b"], 1e-6).to(dtype).float()
                checks = []
                out = ln.layernorm(x, p["ln_w"], p["ln_b"])
                ref = ln.layernorm_plain(x, p["ln_w"], p["ln_b"])
                checks.append(("layernorm", [(out, ref)], 0.0))
                out = fq.fused_ln_qkv(x, p["ln_w"], p["ln_b"], p["w"], p["b"], HEADS)
                ref = fq.fused_ln_qkv_plain(x, p["ln_w"], p["ln_b"], p["w"], p["b"], HEADS)
                checks.append(("fused_ln_qkv", list(zip(out, ref)),
                               2.0 ** -5 * xn.abs().max().item()
                               * p["w"].float().abs().max().item()))
                mlp_args = (p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"])
                out = fm.fused_ln_mlp(x, *mlp_args)
                ref = fm.fused_ln_mlp_plain(x, *mlp_args)
                torch.cuda.synchronize()
                if out.shape != ref.shape or out.dtype != dtype or not out.is_contiguous():
                    fail(f"fused_ln_mlp returned {tuple(out.shape)} {out.dtype}")
                diff = (out.float() - ref.float()).abs()
                allow = mlp_allowance(x, ref, p, ln, fm)
                worst = (diff / allow).max().item()
                report = {"fused_ln_mlp": {"max_abs_err": diff.max().item(),
                                           "worst_share_of_bound": worst,
                                           "bound_max": allow.max().item(),
                                           "bound_min": allow.min().item()}}
                if not worst <= 1.0:
                    fail(f"fused_ln_mlp kernel disagrees with plain at {shape} {dtype}: "
                         f"an error is {worst} of its per-element bound")
                if i == 0:
                    # the bound fails a wrong K5: the kernel given b2 = 0 or
                    # an fc2 weight with a 64-wide slice of K zeroed (as if
                    # its K loop skipped a step); in fp32 also the plain
                    # version with the exact GELU in place of tanh's
                    w2_cut = p["w2"].clone()
                    w2_cut[:, 1024:1088] = 0
                    wrong = {"b2 dropped": fm.fused_ln_mlp(x, *mlp_args[:5],
                                                           torch.zeros_like(p["b2"]), p["gamma"]),
                             "fc2 K slice lost": fm.fused_ln_mlp(x, *mlp_args[:4], w2_cut,
                                                                 p["b2"], p["gamma"])}
                    if not bf:
                        tanh_gelu = fm.gelu_tanh
                        fm.gelu_tanh = torch.nn.functional.gelu
                        try:
                            wrong["exact GELU"] = fm.fused_ln_mlp_plain(x, *mlp_args)
                        finally:
                            fm.gelu_tanh = tanh_gelu
                    caught = {k: ((o.float() - ref.float()).abs() / allow).max().item()
                              for k, o in wrong.items()}
                    report["fused_ln_mlp"]["wrong_kernels_worst_share"] = caught
                    if not all(v > 1.0 for v in caught.values()):
                        fail(f"fused_ln_mlp: the bound passes a wrong kernel at {dtype}: {caught}")
                    del wrong, w2_cut
                if bf:
                    row_err["fused_ln_mlp"] = max(row_err["fused_ln_mlp"], diff.max().item())
                del diff, allow
                for kname, pairs, extra in checks:
                    for o, r in pairs:
                        if o.shape != r.shape or o.dtype != dtype or not o.is_contiguous():
                            fail(f"{kname} returned {tuple(o.shape)} {o.dtype}, plain "
                                 f"{tuple(r.shape)} {r.dtype}")
                    err = max((o.float() - r.float()).abs().max().item() for o, r in pairs)
                    scale = max(r.float().abs().max().item() for _, r in pairs)
                    bound = 2.0 ** -7 * scale + extra if bf else 1e-4 * scale
                    report[kname] = {"max_abs_err": err, "bound": bound}
                    if not err <= bound:
                        fail(f"{kname} kernel disagrees with plain at {shape} {dtype}: "
                             f"{err} > {bound}")
                    if bf:
                        row_err[kname] = max(row_err[kname], err)
                say("row_kernels_check", dtype=str(dtype), params=str(pdt), shape=list(shape),
                    heads=HEADS, **report)
                del x, p, xn, out, ref, checks
        torch.cuda.empty_cache()

    # ---- 4c. K7 (flash attention with segment ids) vs its plain version
    # (`check_k7`)
    k7_err = check_k7(fa)

    # ---- 5. narrow whole model: CPU plain paths vs CUDA kernels, fp32
    model = narrow_model()
    ds = SyntheticSeg(n=2, imsize=112, seed=5)
    imgs, masks = next(ds.batches(2))
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    cpu = eval_step(model.eval(), imgs, masks)
    reset_counts()
    gpu = eval_step(copy.deepcopy(model).cuda(), imgs.cuda(), masks.cuda())
    torch.cuda.synchronize()
    # 5 + 2 + 3 block applications (clean walk, adapter prefix, 3 more
    # blocks), each one K4, K3 and K5; 4 final norms (K6); 4 CAViT + 3 CACNN
    # MSDA calls
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
    small_expect = {"flash_fwd": 10, "msda_fwd": 7, "msda_bwd": 0, "fused_ln_qkv": 10,
                    "fused_ln_mlp": 10, "layernorm": 4, "flash_attn": 0, "flash_attn_bwd": 0}
    if small_launches != small_expect:
        fail(f"small slice: kernel launches {small_launches}, expected {small_expect}")
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
    if train_small_launches != {k: 2 * (7 if k == "msda_bwd" else v)
                                for k, v in small_expect.items()}:
        fail(f"narrow train step: launches {train_small_launches}, expected {small_expect} "
             "and 7 MSDA backwards per step")
    del base, trainers, named, bufs

    # ---- 6b. narrow SSL step: CPU plain paths vs CUDA kernels, fp32 (TF32
    # off), 2 steps from the same seeded student, teacher and centres, on the
    # same augmented crops (made on the CPU) and masks
    impls = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
    depth, nb, lr, mom = 2, 4, 1e-6, 0.9
    base = SSLMetaArch(DinoVisionTransformer(img_size=56, patch_size=14, embed_dim=128,
                                             depth=depth, num_heads=2, **impls),
                       SSLConfig(dino_out_dim=256, ibot_out_dim=256, head_hidden_dim=64,
                                 head_bottleneck_dim=32, n_local_crops=4))
    seeded_init_(base.student, 3)
    seeded_init_(base.teacher, 4)
    crng = np.random.default_rng(8)
    with torch.no_grad():
        base.dino_center.copy_(torch.from_numpy(0.1 * crng.standard_normal((1, 256))))
        base.ibot_center.copy_(torch.from_numpy(0.1 * crng.standard_normal((1, 1, 256))))
    archs = {"cpu": base, "cuda": copy.deepcopy(base).cuda()}
    frames = torch.from_numpy(crng.integers(0, 256, (nb, 84, 84, 3), np.uint8))
    gen = torch.Generator().manual_seed(8)
    mask_gen = MaskingGenerator((4, 4), num_masking_patches=8)
    reset_counts()
    ssl_report = []
    for it in range(2):
        g_, l_ = apply_multicrop(frames, draw_multicrop(gen, nb, 4), 56, 28)
        info = collate_masks_with_indices(2 * nb, 16, mask_gen, seed=it)
        outs = {dev: {k: float(v) for k, v in arch.train_step(
                    g_.to(dev), l_.to(dev), masks_to(info, torch.device(dev)), lr=lr, wd=0.04,
                    momentum=mom, teacher_temp=0.05, last_layer_lr=lr).items()}
                for dev, arch in archs.items()}
        torch.cuda.synchronize()
        named = {dev: dict(a.student.named_parameters()) for dev, a in archs.items()}
        # the first step starts from the same parameters: the losses within
        # fp32 orders, 1e-5; after one update the students differ where
        # Adam's u = g/(|g| + eps) flipped sign (|Δu| < 2, so |Δp| < 2·lr per
        # element and step): the second step's losses within 1e-3
        tol = 1e-5 if it == 0 else 1e-3
        loss_err = {k: abs(outs["cuda"][k] - v) / max(1.0, abs(v)) for k, v in outs["cpu"].items()}
        if not all(e <= tol for e in loss_err.values()):
            fail(f"narrow SSL step {it}: losses {outs['cuda']} on the card, {outs['cpu']} "
                 "on the CPU")
        zero = [n for n, q in named["cuda"].items() if not q.grad.abs().max() > 0]
        if zero:
            fail(f"narrow SSL step {it}: zero gradients on the card: {zero}")
        grad_rel = 0.0
        if it == 0:
            # fp32 gradients of the same parameters through two blocks, the
            # heads' softmaxes and the losses in other orders: 1e-4 of each
            # leaf's largest gradient (≥ 1e-4 of the step's largest)
            top = max(q.grad.abs().max().item() for q in named["cpu"].values())
            for n, q in named["cpu"].items():
                sc = max(q.grad.abs().max().item(), 1e-4 * top)
                grad_rel = max(grad_rel, (named["cuda"][n].grad.cpu() - q.grad).abs().max().item()
                               / sc)
            if not grad_rel <= 1e-4:
                fail(f"narrow SSL step: gradients differ by {grad_rel} of their scale")
        # the teacher after the EMA: t·m + s·(1 − m) of students that differ
        # by < 2·lr per element and step
        t_err = max((tq.detach().cpu() - cq.detach()).abs().max().item()
                    for tq, cq in zip(archs["cuda"].teacher.parameters(),
                                      archs["cpu"].teacher.parameters()))
        if not t_err <= 2 * lr * (it + 1) + 1e-6:
            fail(f"narrow SSL step {it}: teachers differ by {t_err}")
        c_err = {c: (getattr(archs["cuda"], c).cpu() - getattr(base, c)).abs().max().item()
                 for c in ("dino_center", "ibot_center")}
        # the centres: EMAs of the teachers' head outputs, 1e-5 of their scale
        if not all(e <= 1e-5 * max(1.0, getattr(base, c).abs().max().item())
                   for c, e in c_err.items()):
            fail(f"narrow SSL step {it}: centres differ by {c_err}")
        ssl_report.append({"loss_cpu": outs["cpu"], "loss_rel_err": loss_err,
                           "grad_max_rel_err": grad_rel if it == 0 else None,
                           "teacher_max_abs_err": t_err, "centre_max_abs_err": c_err})
    ssl_small_launches = counts()
    say("small_ssl_step", steps=2, steps_report=ssl_report, launches=ssl_small_launches)
    if ssl_small_launches != expect_ssl(2, {"flash_attn": 2 * depth, "flash_attn_bwd": depth}):
        fail(f"narrow SSL step: launches {ssl_small_launches}, expected {2 * depth} K7 "
             f"forwards and {depth} backwards per step")
    del base, archs, named

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
    if launches != expect(fwd, 0):
        fail(f"full width: launches {launches}, expected {expect(1, 0)} per forward × {fwd}")
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
    if in_train != expect(steps, 7 * steps):
        fail(f"full-width training: launches {in_train} in {steps} steps, expected "
             f"{expect(1, 7)} per step")
    if in_val != expect(val_calls[0], 0):
        fail(f"full-width training: validation launches {in_val} in {val_calls[0]} forwards")
    # every trainable moves, the c1 projection by weight decay alone
    if unchanged:
        fail(f"full-width training: trainables left unchanged: {unchanged}")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 8b. the deployed configuration's entry points at their defaults
    entry = {}
    for mod, backwards in ((bench, 7), (bench_infer, 0)):
        reset_counts()
        res = mod.main([])
        got = counts()
        n = 2 + 3 * 10                  # the defaults: 2 warm-up steps, 3 windows of 10
        entry[mod.__name__.rsplit(".", 1)[-1]] = (res, got)
        say("entry_point", module=mod.__name__, result=res, launches=got,
            per_step={k: v / n for k, v in got.items()})
        finite = [v for k, v in res.items() if k in ("value", "mfu", "peak_mem_gib", "loss",
                                                       "ms_batch")]
        if not all(isinstance(v, float) and math.isfinite(v) for v in finite):
            fail(f"{mod.__name__}: values not finite: {res}")
        if got != expect(n, backwards * n):
            fail(f"{mod.__name__}: launches {got} in {n} steps, expected "
                 f"{expect(1, backwards)} per step")
        torch.cuda.empty_cache()
    bench_launches = entry["bench"][1]

    # ---- 8c. the SSL slice's entry points at full width: `bench_ssl` at its
    # defaults (2 warm-up steps and 3 windows of 10), then `pretrain` for 4
    # steps; every student parameter must change but the last layer, which
    # `pretrain` freezes for its first epoch, and the teacher with them
    reset_counts()
    ssl_res = bench_ssl.main([])
    ssl_launches = counts()
    n = 2 + 3 * 10
    say("entry_point", module=bench_ssl.__name__, result=ssl_res, launches=ssl_launches,
        per_step={k: v / n for k, v in ssl_launches.items()})
    if not all(isinstance(ssl_res[k], float) and math.isfinite(ssl_res[k])
               for k in ("value", "mfu", "peak_mem_gib", "loss", "ms_step")):
        fail(f"bench_ssl: values not finite: {ssl_res}")
    if ssl_launches != expect_ssl(n):
        fail(f"bench_ssl: launches {ssl_launches} in {n} steps, expected {SSL_PER_STEP} per step")
    torch.cuda.empty_cache()
    argv = ["--bf16", "--synthetic", "--epochs", "1", "--steps_per_epoch", "4",
            "--warmup_epochs", "0"]
    reset_counts()
    arch, hist = pretrain.run(pretrain.get_args_parser().parse_args(argv))
    pre_launches = counts()
    start = pretrain.build_arch(pretrain.get_args_parser().parse_args(argv))
    # the teacher's frozen last layer: t·m + t·(1 − m) of an unchanged t
    # moves it by its roundings only (≤ 4 fp32 ulps)
    moved = {}
    for branch in ("student", "teacher"):
        now = dict(getattr(arch, branch).named_parameters())
        moved[branch] = {}
        for n_, p_ in getattr(start, branch).named_parameters():
            d = (now[n_].detach().cpu() - p_).abs()
            rounding = branch == "teacher" and "last_layer" in n_
            moved[branch][n_] = bool((d > (4 * ulp(p_, torch.float32) if rounding else 0)).any())
    wrong = {b: [n_ for n_, m in ms.items() if m == ("last_layer" in n_)]
             for b, ms in moved.items()}
    say("entry_point", module=pretrain.__name__, argv=argv, epochs=hist, launches=pre_launches,
        per_step={k: v / 4 for k, v in pre_launches.items()},
        params_changed={b: sum(ms.values()) for b, ms in moved.items()},
        params=len(moved["student"]), device=name,
        nvidia_smi=smi[0] if smi else "unavailable")
    if len(hist) != 1 or not all(math.isfinite(hist[0][k])
                                 for k in ("total_loss", "dino", "ibot", "koleo", "img_per_s")):
        fail(f"pretrain: {hist}")
    if any(wrong.values()):
        fail(f"pretrain: parameters changed against expectation (all but the frozen last "
             f"layer must move): {wrong}")
    if pre_launches != expect_ssl(4):
        fail(f"pretrain: launches {pre_launches} in 4 steps, expected {SSL_PER_STEP} per step")
    del arch, start
    torch.cuda.empty_cache()

    # ---- 9. kernel vs plain (and library) time at the main-path shapes
    # (plain in bf16 too), and each kernel's bound from the same inputs
    times, bounds, extra = {}, {}, {}
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
        # K6, K4 and K5 at the walks' shapes, bf16 with bf16 parameters (the
        # frozen backbone's, read in place). Beside plain and library:
        # the unfused PyTorch sequence each replaced (under autocast, as the
        # training step ran it: LayerNorm to fp32, casts, F.linear, the q/k/v
        # relayout, GELU) and cuBLAS's GEMMs alone on the normalised input
        F = torch.nn.functional
        for shape in ROW_SHAPES:
            x, p = row_inputs(shape, torch.bfloat16, seed=0, params_dtype=torch.bfloat16)
            B, N, C = shape
            R = B * N
            lw, lb = p["ln_w"].to(x.dtype), p["ln_b"].to(x.dtype)
            xn = F.layer_norm(x, (C,), lw, lb, 1e-6)
            xb, pe = x.numel() * x.element_size(), p["ln_w"].element_size()
            key = f"layernorm B={B} N={N}"
            times[key] = (cuda_ms(lambda: ln.layernorm(x, p["ln_w"], p["ln_b"])),
                          cuda_ms(lambda: ln.layernorm_plain(x, p["ln_w"], p["ln_b"])),
                          cuda_ms(lambda: F.layer_norm(x, (C,), lw, lb, 1e-6)))
            # reads x, w, b; writes y; ≈ 8 fp32 operations per element
            bounds[key] = bound_ms(2 * xb + 2 * C * pe, 8 * R * C, "fp32")

            def unfused_qkv():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    y = F.linear(F.layer_norm(x, (C,), lw, lb, 1e-6), p["w"], p["b"])
                qkv = y.reshape(B, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4)
                return [t.contiguous() for t in qkv]

            key = f"fused_ln_qkv B={B} N={N}"
            qkv_args = (x, p["ln_w"], p["ln_b"], p["w"], p["b"], HEADS)
            times[key] = (cuda_ms(lambda: fq.fused_ln_qkv(*qkv_args)),
                          cuda_ms(lambda: fq.fused_ln_qkv_plain(*qkv_args)), None)
            extra[key] = {"unfused": cuda_ms(unfused_qkv),
                          "cublas_gemm": cuda_ms(lambda: F.linear(xn, p["w"], p["b"].to(x.dtype)))}
            # reads x, the LN parameters, w, b; writes q, k, v (3·x)
            bounds[key] = bound_ms(4 * xb + p["w"].numel() * 2 + (2 + 3) * C * pe,
                                   2 * R * C * 3 * C, "bf16")

            def unfused_mlp():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    h = F.gelu(F.linear(F.layer_norm(x, (C,), lw, lb, 1e-6), p["w1"], p["b1"]),
                               approximate="tanh")
                    return x + p["gamma"].to(x.dtype) * F.linear(h, p["w2"], p["b2"])

            h = F.gelu(F.linear(xn, p["w1"], p["b1"].to(x.dtype)), approximate="tanh")
            key = f"fused_ln_mlp B={B} N={N}"
            mlp_args = (x, p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"])
            times[key] = (cuda_ms(lambda: fm.fused_ln_mlp(*mlp_args)),
                          cuda_ms(lambda: fm.fused_ln_mlp_plain(*mlp_args)), None)
            extra[key] = {"unfused": cuda_ms(unfused_mlp),
                          "cublas_gemm": cuda_ms(lambda: (F.linear(xn, p["w1"]),
                                                          F.linear(h, p["w2"])))}
            # reads x, the LN parameters, w1, b1, w2, b2, γ; writes out
            bounds[key] = bound_ms(2 * xb + 2 * p["w1"].numel() * 2 + 8 * C * pe,
                                   2 * 2 * R * C * 4 * C, "bf16")
            del x, p, xn, h
            torch.cuda.empty_cache()
        # K7 at the SSL step's shapes, bf16: forward, and backward from the
        # forward's o and lse; beside plain, PyTorch's SDPA with the boolean
        # block-diagonal mask (the student's; none for the teacher), forward
        # and its backward alone (autograd.grad with the graph kept)
        for case, shape in K7_SHAPES.items():
            q, k, v, do = k7_inputs(shape, torch.bfloat16, seed=0)
            B, H, N, Dh = shape
            segs = STUDENT_SEGMENTS if case == "student" else [N]
            seg = packed_ids(B, segs) if case == "student" else None
            mask = None if seg is None else seg[:, None, :, None] == seg[:, None, None, :]
            o, lse = fa.flash_attn_fwd_kernel(q, k, v, 0.125, seg)
            pairs = own_segment_pairs(B, H, segs)
            tb, ib = q.numel() * q.element_size(), (0 if seg is None else seg.numel() * 4)
            key = f"flash_attn {case}"
            times[key] = (cuda_ms(lambda: fa.flash_attn_fwd_kernel(q, k, v, 0.125, seg)),
                          cuda_ms(lambda: fa.flash_attn_fwd_plain(q, k, v, 0.125, seg)),
                          cuda_ms(lambda: F.scaled_dot_product_attention(
                              q, k, v, attn_mask=mask, scale=0.125)))
            # reads q, k, v and the ids; writes o and lse; q·kᵀ and p·v over
            # the own-segment pairs
            bounds[key] = bound_ms(4 * tb + lse.numel() * 4 + ib, 4 * Dh * pairs, "bf16")
            key = f"flash_attn_bwd {case}"
            with torch.enable_grad():
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=0.125)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))

                def lib_both():
                    y = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=0.125)
                    return torch.autograd.grad(y, leaves, do)

                extra[key] = {"library_fwd_and_bwd": cuda_ms(lib_both)}
            times[key] = (cuda_ms(lambda: fa.flash_attn_bwd_kernel(q, k, v, o, lse, do, 0.125,
                                                                   seg)),
                          cuda_ms(lambda: fa.flash_attn_bwd_plain(q, k, v, o, lse, do, 0.125,
                                                                  seg)), lib_bwd)
            # reads q, k, v, o, do, lse and the ids; writes dq, dk, dv; five
            # products over the own-segment pairs (q·kᵀ, do·vᵀ, pᵀ·do,
            # dsᵀ·q, ds·k)
            bounds[key] = bound_ms(8 * tb + lse.numel() * 4 + ib, 10 * Dh * pairs, "bf16")
            del q, k, v, do, o, lse, leaves, out, mask
            torch.cuda.empty_cache()
    say("kernel_times", device=name, nvidia_smi=smi[0] if smi else "unavailable",
        ms={k: {"kernel": a, "plain": b, "library": c, "bound": bounds[k][0],
                "bound_by": bounds[k][1], **extra.get(k, {})}
            for k, (a, b, c) in times.items()})

    def on_path(key, prefix):
        return key.startswith(prefix) and f"B={TRAIN_BATCH}" in key

    def mean(prefix, i):
        vals = [v[i] for k, v in times.items() if on_path(k, prefix)]
        return None if None in vals else sum(vals) / len(vals)

    def mean_bound(prefix):
        vals = [b for k, b in bounds.items() if on_path(k, prefix)]
        return sum(t for t, _ in vals) / len(vals), vals[0][1]

    # per-call means over the training path's mix at batch 16: equal numbers
    # of calls at each walk length and of each MSDA case; launches of the
    # deployed configuration's training run (phase 8b, `bench`)
    rows = []
    for kname, src, replaces, err in (
            ("flash_fwd", "flash_fwd.cu", "adaptersis_tpu/ops/flash_fwd.py:73", flash_err),
            ("msda_fwd", "msda_fwd.cu", "adaptersis_tpu/ops/msda_pallas.py:477", msda_err),
            ("msda_bwd", "msda_bwd.cu", "adaptersis_tpu/ops/msda_pallas.py:1305", bwd_err),
            ("fused_ln_qkv", "ln_gemm.cu", "adaptersis_tpu/ops/fused_qkv.py:51",
             row_err["fused_ln_qkv"]),
            ("fused_ln_mlp", "ln_gemm.cu", "adaptersis_tpu/ops/fused_mlp.py:48",
             row_err["fused_ln_mlp"]),
            ("layernorm", "layernorm.cu", "adaptersis_tpu/ops/layernorm.py:49",
             row_err["layernorm"])):
        b_ms, b_by = mean_bound(kname)
        rows.append({"name": kname, "route": "cuda",
                     "source": f"adaptersis_tpu_torch/csrc/{src}", "replaces": replaces,
                     "launches": bench_launches[kname], "max_abs_err": err,
                     "ms": mean(kname, 0), "plain_ms": mean(kname, 1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": mean(kname, 2)})
    # K7: the forward's per-call mean over the SSL step's mix (12 student and
    # 12 teacher calls), the backward's student calls; launches of bench_ssl
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    for kname, src, replaces, keys, err in (
            ("flash_attn", "flash_attn_fwd.cu", f"{lib}:342",
             ["flash_attn student", "flash_attn teacher"], k7_err["fwd"]),
            ("flash_attn_bwd", "flash_attn_bwd.cu", f"{lib}:796 (dK/dV), :1146 (dQ)",
             ["flash_attn_bwd student"], k7_err["bwd"])):
        avg = [sum(times[k][i] for k in keys) / len(keys) for i in range(3)]
        rows.append({"name": kname, "route": "cuda",
                     "source": f"adaptersis_tpu_torch/csrc/{src}", "replaces": replaces,
                     "launches": ssl_launches[kname], "max_abs_err": err, "ms": avg[0],
                     "plain_ms": avg[1], "bound_ms": sum(bounds[k][0] for k in keys) / len(keys),
                     "bound_by": bounds[keys[0]][1], "library_ms": avg[2]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
