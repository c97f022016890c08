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
     (the serving path's) and 16 (the training path's), each element
     within a bound from its own terms (`k3_allowance`); five repeated
     calls must give the same bits and planted faults must break the
     bound (bf16: a dropped tail key, a stale K/V ring stage; fp32: one
     TF32 pass for each product, `ops/tf32.py`, where the kernel runs
     three);
  2b. K3 the same way at tap_unet_fuse's extra walks of ViT-L/14 at 588 px,
     N = 3970 (the 1.5× frame) and 442 (the 0.5× frame), batch 2 and 8;
  2c. K3 the same way at ViT-g/14's 24 heads (`G_FLASH_SHAPES`);
  2d. K3 the same way at the Mask2Former stack's walk, 1370 tokens
     (`M2F_FLASH_SHAPES`, batch 2 and 4);
  2e. K3 the same way at the frozen-feature evals' walk, ViT-L/14 at 224
     px: 257 tokens (`EVAL_FLASH_SHAPES`, batch 2 and 64), and at the
     depther's 420 × 560 walk: 1201 tokens, batch 4;
  2f. K3 the same way at the reference eval scripts' ViT-S/14 walks, 6
     heads, N = 65, 257, 577, 785 and 1765 (224 px, tap_unet_fuse's 0.5×
     and 1.5× frames, 392 and 588 px), and at vit_tiny's 3 heads at 257,
     batch 2 and 16 (`VITS_FLASH_SHAPES`; under 256 keys the stale stage
     gives the second quarter of the keys the first's v);
  3. K1 deformable-attention forward vs msda_plain at the CAViT and CACNN
     geometries of ViT-L/14 at 588 px, bf16 values, each element within a
     bound from its own terms (`msda_allowances`): batch 2 and 16 on
     uniform points (partly outside), batch 16 on model-like points (each
     query's reference point plus the initialised offset bias), batch 2 on a
     hot token (every point of a head on one pixel centre), pixel edges
     (coordinates within one fp32 rounding of k/W or (k + ½)/W) and all
     points outside; five more calls at CAViT batch 16 must give the same
     bits, and a level's start offset moved by one token must break the
     bound; 3b. the same at ViT-g/14's adapters (`G_MSDA_CASES`: head width
     D = 192, bf16 and fp32 values, batch 2 and 16, uniform and model-like
     points and a hot token); 3c. the same at the Mask2Former stack's
     geometries (`m2f_msda_cases`, batch 2, bf16 and fp32, uniform and
     model-like points and a hot token, faults and repeats): the pixel
     decoder's D = 32 over levels 16², 31², 64² with Lq = S = 5313,
     ViTAdapter's injector and extractor at 518 px (D = 128), and D = 48
     (vit_small);
  4. K2 deformable-attention backward vs autograd of msda_plain in the same
     cases, with a seeded fp32 incoming gradient: dvalue (bf16, half an ulp
     plus the fp32 reordering of the element's own sum), dloc and daw per
     element; five more calls at CAViT batch 16, and on the hot token
     (whose bins several warps sum), must give bit-identical dvalue, dloc
     and daw, and two planted faults must break the dvalue
     bound (each token's first contribution dropped; every point's x0 and
     x0+1 corner weights swapped); 4a. the same at `G_MSDA_CASES`; 4f.
     the same at the Mask2Former cases of 3c;
  3d, 4h. K1 and K2 the same way at vit_tiny's adapters at 224 px
     (`TINY_MSDA_CASES`: CAViT's 16² queries on the 28², 14², 7² pyramid and
     CACNN the reverse, D = 24, bf16 and fp32, batch 2 and 16, uniform,
     model-like and hot-token points, faults and repeats);
  4b. K6 LayerNorm, K4 fused LN → qkv → head split and K5 fused LN → MLP →
     LayerScale → residual vs their plain versions, bf16 and fp32, C = 1024,
     H = 16, N = 1765 and 1764, batch 2 and 16, and 3 images of 1765 (the
     GEMMs' 128-row tiles straddle image boundaries, the last is ragged),
     rows with non-zero means and unequal scales, parameters stored in bf16
     and in fp32; K5 per element, K4 in fp32 also per element
     (`qkv_allowance`); planted faults must break the bounds (K4: q, k, v
     moved by one head, one k-step of x not normalised; K5: b2 dropped, an
     fc2 k-slice lost, in fp32 the exact GELU; in fp32 at every shape, K4
     and K5 with one TF32 pass for each product) and five more calls of
     each must give the same bits; then K6 and K4 the same
     way at ViT-g/14's C = 1536, H = 24 (`G_ROW_SHAPES`: its SwiGLU blocks
     run no K5) and K6, K4 and K5 at vit_tiny's C = 192, H = 3
     (`TINY_ROW_SHAPES`), and at the Mask2Former walk's 1370 rows
     (`M2F_ROW_SHAPES`); 4g. K6 and K4 the same way at the evals' 257
     tokens (`EVAL_ROW_SHAPES`, batch 2 and 64) and the depther's 1201
     (batch 4); no K5: exact GELU;
  4i. K6, K4 and K5 the same way at ViT-S/14's C = 384, H = 6 at B·N rows
     for the N of 2f and 3 images of 785 (`VITS_ROW_SHAPES`), and K7 at
     eval_dinov2_setr_cross_ete's (16, 6, 257, 64), no ids, fp32 and bf16,
     forward and backward, as 4d (`entry_kernel_checks`);
  4c. K7 flash attention with segment ids vs its plain version, bf16 and
     fp32, each element against a bound from its own terms: the forward
     (output and logsumexp), dq, dk and dv through autograd with a seeded
     incoming gradient, and the backward kernels alone on the plain
     forward's o and lse (bf16: at most 5 % of the elements may differ), at
     the SSL step's shapes (ViT-S/14, batch 32): the student's packed rows
     (64, 6, 457, 64), segments 257 + 4 × 50, the teacher's (64, 6, 257, 64)
     without ids, interleaved ids at scale 0.1, and segments whose
     boundaries fall one token past a tile edge, their straddling keys
     carrying most of the mass; each case prints the share of tile pairs
     the kernels walk; planted faults must fail: no segment ids, di = 0, p
     and ds not rounded to bf16, q scaled before q·kᵀ, and the straddling
     tokens given the next segment's id; five more bf16 calls at the
     student's shape give the same bits;
  4d. K7 the same way at tap_setr_ete's geometry, (2, 16, 1765, 64), one
     segment (no ids): forward and backward per element, the planted
     faults di = 0 and p and ds not rounded to bf16, five bit-identical
     repeats;
  4e. K7 the same way at ViT-g/14's SSL step (`G_K7_SHAPES`: the student's
     (16, 24, 457, 64) with its planted faults and repeats, the teacher's
     (16, 24, 257, 64));
  5. a narrow whole model (fp32, TF32 off), seeded: CPU (plain paths) vs
     CUDA (kernels), eval logits and metrics, and the launches per forward
     (10 K3, 7 K1, 10 K4, 10 K5, 4 K6), every K3 launch on the 3×TF32
     kernel as its launcher reports (`path_counts`; so in phases 6, 8m, 8r
     and 8s; K4's and K5's launcher has one kernel per dtype);
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
     at 588 px, bf16, batch 16): `adaptersis_tpu_torch.bench --profile`
     (train step; then 3 steps under torch.profiler, whose device table
     must name K1-K6 by their kernels, `PROFILE_NAMES`; its top rows are
     printed, `check_profile`) and `adaptersis_tpu_torch.bench_infer`
     (forward + argmax), their JSON lines, finite values and launches per
     step;
  8c. the SSL slice's entry points at full width (ViT-S/14, batch 32,
     bf16, 65536 prototypes): `adaptersis_tpu_torch.bench_ssl` at its
     defaults and `adaptersis_tpu_torch.pretrain --bf16 --synthetic
     --epochs 1 --steps_per_epoch 4 --warmup_epochs 0`: finite losses,
     every student parameter changed (but the last layer, frozen for the
     first epoch), the teacher moved, 24 K7 forwards and 12 K7 backwards per
     step, img/s, MFU and peak memory;
  8d. the SSL step gate at full width (ViT-S/14, batch 32, bf16, 65536
     prototypes): the step built twice from the same seeded weights with
     every LayerScale perturbed, on the same crops and masks, once with K7
     and once with `flash_attn_plain` patched into the model's layers; the
     loss and its parts within 1e-2, each trainable subtree's gradients
     (backbone blocks, patch embed, the other backbone parameters, the
     DINO head, which iBOT shares) within 1e-1 in normalised L2 distance
     and max relative error (the JAX gate's bf16 bound); a zero gradient
     on the plain side fails;
  8e. the segmentation train step gate at full width (M9: `bench`'s model,
     ViT-L/14 at 588 px, bf16, batch 8, every backbone LayerScale drawn
     from N(0, 0.1²)), on two seeds: the step with the kernels, with the
     plain versions of K1-K6 patched in, and with those plain versions but
     K4's and K5's sums in float64 (the floor: two correct
     implementations), from the same seeded weights on the same augmented
     batch; the loss within 1e-2, each trainable subtree's gradients
     (cross_vit, cross_cnn, encoder, decoder, level_embed) within 1e-1 or
     twice the floor's distance in normalised L2 distance and max relative
     error, two planted faults (q, k, v moved by one head; K5 without b2)
     beyond them; `seg_step_gate`;
  8f. `train.py`'s real-data run at full width (`real_data_run`): a
     Robust-MIS tree at its 960 × 540 frames and a seeded `.pth` in
     `dinov2_vitl14_pretrain.pth`'s layout, `train_seg` (ViT-L/14, 588 px,
     bf16, batch 8, 2 epochs) as run A, then its repeat A′ through
     `adaptersis_tpu_torch.quality_parity` with A's last validation as the
     reference (`parity_checks`: parity.json's metrics are A′'s last
     `test_*` row, exit code 1 exactly when parity_ok is false, every Δ 0
     and PASS when A and A′ are bit-identical; A's dice + 0.05 must FAIL
     with exit code 1, compared without training again), R stopped after
     an epoch and resumed (`resume_rule`), `--evaluate` and `evaluate`;
  8g. `pretrain`'s checkpoint and resume at full width (`ssl_resume_run`);
  8h. `train_seg`'s other models and decoders at the paper's width (ViT-L/14
     at 588 px cut to `VARIANT_DEPTH` = 4 of its 24 blocks, bf16, tanh
     GELU, batch 8, synthetic, one epoch of 3 steps and a validation): the adapter model with the MLA decoder (through
     `train_mla`) and with SETR's, and tap_setr, tap_unet, tap_unet_fuse,
     tap_masktrans and tap_setr_ete; finite losses, every trainable moved,
     a frozen backbone unchanged, launches per train step and validation
     forward as `variant_expect` says, img/s, peak memory, seconds; then
     `--evaluate` on tap_setr_ete's checkpoint gives its last acc1
     (`variant_runs`);
  8i. tap_setr_ete's train step gate (ViT-L/14 at 588 px, bf16, batch 2,
     LayerScale ~ N(0, 0.1²)): K7 against `flash_attn_plain`, with SDPA as
     the floor and q, k, v moved by one head as the planted fault, per
     subtree (backbone, head) within max(1e-1, 2 × floor)
     (`ete_step_gate`);
  8j. ViT-g/14 at its full width cut to `G_DEPTH` = 12 of its 40 blocks
     (`arch_depth`, as in 8k and 8l) through `train_seg --config_file
     configs/vitg14_pretrain.yaml --imsize 588 --bf16 --synthetic` at batch
     8 (`variant_runs` with `G_RUNS`: 3 steps, a validation of 2 forwards,
     launches per step as `G_PER_FORWARD` predicts, img/s, peak memory, then
     `--evaluate` on its checkpoint), and its train step at batch 2 on phase
     8e's sides (`seg_step_gate` with arch vit_giant2; the moved heads as
     the fault);
  8k. ViT-g/14's SSL step: `pretrain --arch vit_giant2 --bf16 --synthetic`
     at the default crops, batch 8, 2 steps (`vitg_ssl_run`, G_DEPTH
     blocks);
  8l. `visualize_attention` on the card (`attention_map_run`): a seeded
     ViT-S/14 `.pth` (against the CPU's plain path) and ViT-g/14's draw
     (G_DEPTH blocks);
  8m. `segment_m2f --arch vit_large --imsize 518 --batch_size_per_gpu 4
     --synthetic` at its fp32 default, one epoch cut to 3 steps, its
     validation and checkpoint, then the same command with `--epochs 2`
     resumes; launches per step and validation forward (`M2F_FP32_STEP`),
     img/s over 2 steps, peak memory; 8n. `segment_m2f` at its defaults
     (vit_small, D = 48), one step; 8o. `bench_m2f --profile` at its
     defaults (ViT-L/14, 518 px, bf16, batch 4: `M2F_BENCH_STEP`; the 3
     profiled steps' device table must name K1-K6 as in 8b) and on
     vit_large_windowed for 3 steps (`M2F_WINDOWED_STEP`)
     (`m2f_entry_runs`);
  8p. the Mask2Former train step gate (`m2f_step_gate`, batch 2, bf16):
     K1-K5 against their plain versions, the floor and the moved heads as
     in 8e, per subtree (adapter, pixel decoder, decoder layers,
     prediction heads), every side fed the plain side's Hungarian
     assignments;
  8q. the DETR stack's deformable decoder (6 layers, C 256 in 8 heads, 4
     levels, 100 queries, batch 2, fp32, a refinement branch) on the card
     with K1 and K2 against the same with the plain MSDA: outputs, points
     and gradients, 6 K1 and 6 K2 launches (`detr_decoder_check`);
  8r. M9's fp32 half: the ViT-L train step at train_seg's default
     precision (588 px, fp32, exact GELU, batch 2, every LayerScale from
     N(0, 0.1²), TF32 off), seeds 0 and 1, on the sides of 8e with the
     floor summing K3 and K4 in float64 and the moved heads as the fault:
     the loss within 2e-3, each subtree within 8e-2 in normalised L2 and
     1e-1 in max relative error (the JAX gate's fp32/bs2 bounds) or twice
     the floor (`seg_step_gate` with fp32);
  8s. `train_seg --arch vit_large --patch_size 14 --imsize 588
     --batch_size_per_gpu 12 --lr 0.01 --synthetic` at train.py's own
     example precision (no --bf16, no --gelu_approx), one epoch cut to 3
     steps and a validation, then `--evaluate` (`variant_runs` with
     `FP32_RUNS`): launches per step `PER_FORWARD_FP32` (48 K3 and 48 K4 on
     3×TF32, 52 K6, 7 K1, 7 K2, no K5), img/s, peak memory;
  8w. the frozen-feature evals (M14): `evals_cli` knn, logreg and linear
     (`--epochs 2`) at ViT-L/14, 224 px, batch 64, fp32 with exact GELU,
     `--synthetic`, from a seeded `.pth` in `dinov2_vitl14_pretrain.pth`'s
     layout, and knn on an image-folder tree (`--dataset imagefolder`):
     256 train and 256 val images each (the tree 128), launches per
     extraction forward `EVAL_PER_FORWARD` (24 K3 on 3×TF32, 24 K4, 28 K6),
     extraction img/s, peak memory (`evals_cli_runs`);
  8x. `eval_knn` at ImageNet-1k's sizes on seeded random features (N =
     1,281,167, D = 1024, M = 50,000, 1000 classes, k ∈ {10, 20, 100,
     200}, chunks of 1024): seconds per k and the peak memory; one
     `logreg_sweep` C at 100,000 × 1024, 1000 classes (`knn_scale_run`);
  8y. `DepthEncoderDecoder` at ViT-L/14 width with the linear and the DPT
     head, batch 4 at 420 × 560, 3 SGD steps on the head: finite losses,
     every head parameter moved, the backbone unchanged, 24 K3, 24 K4, 28
     K6 a step; the linear head's steps under `profile_trace`, whose trace
     must hold the card's kernels (`depther_run`);
  8z. `train_multi_class` (8 classes, the iou_multi loss, EndoVis 2017)
     at ViT-L/14, 588 px, bf16, tanh GELU, batch 8 on a fabricated EndoVis
     2017 tree (`write_endovis2017_tree`: 1280 × 1024 frames, 24 training
     frames in two sequences, 8 test frames), one epoch of 3 steps and a
     validation: finite losses, every trainable moved, the frozen backbone
     unchanged, the head's 8 output channels, launches per train step and
     validation forward as phase 8's, `test_ch_iou` and `test_isi_iou` in
     log.txt finite in [0, 1], the labels trained on (binary_masks: {0, 1}),
     img/s, loader wait, peak memory, seconds (`multi_class_run`);
  8za. the six reference eval scripts' entry points,
     `adaptersis_tpu_torch.eval.eval_dinov2_{setr,unet,or_unet_fuse,
     masktrans,masktrans_inov,setr_cross_ete}.main` with `--arch vit_small
     --patch_size 14 --batch_size_per_gpu 16` and each script's own
     defaults (fp32, exact GELU, 224, 392 or 588 px, its loss and input
     norm, 12 blocks), one epoch cut to 2 steps and a validation of 2
     forwards:
     synthetic frames, but setr_cross_ete on a Robust-MIS tree with
     `--cross_test_path` on a second (finite cross_* metrics); finite
     losses, every trainable moved, the frozen backbone unchanged (setr_ete's
     moved), launches per step and validation forward as `variant_expect`
     at 12 blocks with the exact GELU, K3 on 3×TF32, img/s, peak memory,
     seconds, then `--evaluate` on setr_cross_ete's checkpoint gives its
     last acc1 (`eval_entry_runs`);
  8zb. EndoVis 2018 (1280 × 1024), CholecSeg8k (854 × 480) and AutoLaparo
     (1920 × 1080) from raw trees in their releases' layouts (16 training
     and 4 validation frames; written and converted by `python -m
     adaptersis_tpu_torch.data.process.<converter>` on the host since
     phase 1, `start_datasets`), every label the reader gives checked on the
     host to lie in [0, classes), then `train_multi_class --dataset <name>
     --num_labels C --num_classes C` (C = 8, 13, 10) at ViT-S/14, 224 px,
     fp32, batch 8, 2 steps and a validation, held as 8z: the head's C
     channels, finite losses, challenge metrics in [0, 1], launches; the
     decoder that ran and the loader wait; then CholecSeg8k at the default 8
     classes must stop with `evaluate.check_labels`'s message before its
     first step (`dataset_runs`);
  8zc. `train_seg --arch vit_tiny --patch_size 14 --imsize 224
     --synthetic`, the adapter model at its 12 blocks, batch 16, 2 steps and
     a validation, in fp32 and with `--bf16 --gelu_approx` (K5), as 8h
     (`tiny_runs`);
  9. kernel, plain and library times at the bf16 shapes of phases 2-4c (CUDA
     events around 20 back-to-back calls, `cuda_ms`), the kernels' and the
     library calls' device time alone (20 calls captured in a CUDA graph and
     replayed, `device_ms`), for K3, SDPA, K6 and F.layer_norm the host's
     µs per call (`host_us`), and each kernel's bound from the same inputs;
     for K4 and K5 also the unfused PyTorch sequence they replace,
     cuBLAS's GEMMs alone and the achieved TFLOP/s; for K7 PyTorch's SDPA
     with the boolean
     block-diagonal mask, forward and backward; for K1 and K2 also model-like
     points and, at batch 16, a hot token, the corner-row bytes each call
     moves through the L2 and the rate reached, and K2's device time split
     into its four kernels (point, tile sort, plan, sum) from torch.profiler's
     trace (`kernel_split`); K3 at tap_unet_fuse's N = 3970 and 442 and K7
     forward and backward at tap_setr_ete's (16, 16, 1765, 64), each against
     SDPA; and at batch 16 the new shapes of phases 2c-4e ("vitg ..." and
     "vit_tiny ..." keys); at batch 4 the Mask2Former shapes ("m2f ..."
     keys: K3 against SDPA, K6, K4, K5 at 1370 tokens in bf16 and fp32,
     K1 and K2 at the pixel decoder's, the injector's and the extractor's
     geometries, bf16 and fp32, and at D = 48); at batch 16 the fp32 step's
     K3 at 1765 / 1764 tokens against SDPA and K6 and K4 at 28240 rows
     against the unfused sequence and cuBLAS's fp32 GEMM ("fp32 ..." keys),
     each fp32 row's bound that of 3×TF32 on the tensor cores, which its
     kernel runs, with the CUDA cores' fp32 bound beside it
     (`bound_fp32_cuda_cores`); at batch 64 the evals' fp32 K3 at 257
     tokens against SDPA and K6 and K4 at 16448 rows ("eval ..." keys).
     The kernels line gives the training path's
     (batch 16, uniform points) numbers and the launches of `bench`'s run
     for K1-K6, the SSL step's numbers and the launches of `bench_ssl`'s run
     for K7, and in each row `new_shapes` (ViT-g's and vit_tiny's numbers)
     and `launches_vitg_step` (per step of 8j, or of 8k for K7),
     `m2f_shapes` (each "m2f ..." key) and `launches_m2f_step` (per step
     of 8o's `bench_m2f` and 8m's `segment_m2f`), `fp32_shapes` (each
     "fp32 ..." key) and `launches_fp32_step` (per step of 8s),
     `eval_shapes` (each "eval ..." key) and `launches_eval_forward` (per
     extraction forward of 8w's knn run), `vits_shapes` (each "vits ..."
     and "vit_tiny adapter ..." key: at batch 16 the eval scripts' fp32 K3
     at N = 65-1765 against SDPA, K6 and K4 at C = 384 against the unfused
     sequence and cuBLAS, K6, K4, K5 at 257 tokens in bf16, K7 fp32 at
     setr_cross_ete's shape against SDPA, vit_tiny's K3, K6, K4, K5 at 257
     tokens and K1, K2 at D = 24 in fp32 and bf16), `vits_max_abs_err` (2f-4i
     by dtype) and `launches_vits_step` (per train step of each run of 8za
     and 8zc).
Then a JSON line of the kernels, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed phase exits non-zero.

    python3 chip_smoke.py --times

runs the build and phase 9 alone, with no checks, and prints sha256
prefixes of K6's and K3's outputs on seeded inputs: to compare
two trees' kernels on one card (copy this script into the other tree's root
and run both in one call).

    python3 chip_smoke.py --gate

runs the build, phase 8e with `SEG_GATE_PROBES` (the floor measured with
MSDA's location gradient stopped, and with the CNN encoder in fp32) and
`seg_gate_ablation` (the step with one kernel at a time, and with MSDA's
sums in float64, against the plain step), the same way on any tree whose
K3 wrapper counts launches by kernel (`path_counts`).

    python3 chip_smoke.py --evals

runs the build, phases 2e, 4g, 8w, 8x and 8y and phase 9's "eval ..."
keys alone (`evals_only`).

    python3 chip_smoke.py --entries

runs the build, phases 2f, 3d, 4h, 4i and 8za-8zc and phase 9's "vits ..."
and "vit_tiny adapter ..." keys alone (`entries_only`).

    python3 chip_smoke.py --fp32-steps

runs the build and the fp32 commands of phases 8s and 8m uncut
(`fp32_steps_only`: img/s, peak memory, launches), on any tree of the port:
copy it into another tree's root to time both trees' fp32 steps in one call.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

FULL_BATCH, FULL_BATCHES = 2, 4        # the serving path's batch
TRAIN_BATCH = 16                        # the training path's batch
FLASH_SHAPES = [(B, 16, N, 64) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)]
# the frozen walks' token blocks (B, N, C) of ViT-L/14 at 588 px, 16 heads
ROW_SHAPES = [(B, N, 1024) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)]
# 3 images: the 128-row tiles of K4 and K5 straddle both image boundaries,
# and the last (5295 = 41·128 + 47 rows) is ragged
STRADDLE_ROWS = (3, 1765, 1024)
HEADS = 16
# K7 at the SSL step's shapes (ViT-S/14, batch 32: 64 global crops, 6 heads):
# the student packs a global crop (257 tokens) with 4 local crops (50 each)
SSL_BATCH = 32
STUDENT_SEGMENTS, TEACHER_N = [257, 50, 50, 50, 50], 257
K7_SHAPES = {"student": (2 * SSL_BATCH, 6, sum(STUDENT_SEGMENTS), 64),
             "teacher": (2 * SSL_BATCH, 6, TEACHER_N, 64)}
# K3 at tap_unet_fuse's extra walks of ViT-L/14 at 588 px: the 1.5× frame
# (63² + 1 tokens) and the 0.5× frame (21² + 1); phase 2b holds them at
# batch 2 and at the variants' batch (phase 8h), phase 9 times them at 16
VARIANT_BATCH = 8
FUSE_N = (3970, 442)
FUSE_K3_SHAPES = [(B, 16, N, 64) for B in (FULL_BATCH, VARIANT_BATCH) for N in FUSE_N]
# K7 at tap_setr_ete's geometry: ViT-L/14 at 588 px trained end to end, one
# 1765-token segment (no ids), 16 heads; phase 4d at batch 2, phase 9 at 16
ETE_CASE, ETE_SHAPE = "setr_ete", (FULL_BATCH, 16, 1765, 64)
# per SSL step at ViT-S/14 (12 blocks): the teacher's and the student's
# forwards, the student's backward
SSL_PER_STEP = {"flash_attn": 24, "flash_attn_bwd": 12}
# per forward at full width: attention, MSDA forward, K4, K5, K6
PER_FORWARD = {"flash_fwd": 48, "msda_fwd": 7, "fused_ln_qkv": 48, "fused_ln_mlp": 48,
               "layernorm": 4}
# ... at train.py's own example precision (fp32, exact GELU): each of the 48
# block applications takes K6 before its plain MLP in place of K5, beside
# the 4 tap norms
PER_FORWARD_FP32 = {**PER_FORWARD, "fused_ln_mlp": 0, "layernorm": 48 + 4}
T0 = time.perf_counter()
# (name, value shape (B, S, M, D), Lq, level shapes, P, the queries' grids) at
# ViT-L/14 @ 588 px: CAViT's 42² ViT-token queries sample the 73², 36², 18²
# CNN pyramid, CACNN's pyramid queries sample the 42² ViT tokens
PYRAMID, VIT_GRID = [(73, 73), (36, 36), (18, 18)], [(42, 42)]
MSDA_GEOMETRIES = (("cavit", 6949, 1764, PYRAMID, VIT_GRID), ("cacnn", 1764, 6949, VIT_GRID, PYRAMID))
# ... and the values' dtype
MSDA_CASES = [(f"{case} B={B}", (B, S, 8, 128), Lq, shapes, 4, queries, torch.bfloat16)
              for B in (FULL_BATCH, TRAIN_BATCH)
              for case, S, Lq, shapes, queries in MSDA_GEOMETRIES]
# phases 3 and 4 also hold K1 and K2 at batch 2 of both geometries on these
# points (`msda_inputs`), and at batch 16 on model-like ones
MSDA_POINTS = ("hot token", "pixel edges", "all outside")
# ViT-g/14 at 588 px (M2b): 1536 wide, 40 blocks of 24 heads of 64 with a
# SwiGLU FFN (no K5); the adapters keep 8 heads, so their deformable
# attention runs at head width D = 192 (K1's 32-lane group with 8 idle lanes
# in bf16, K2's two-pass sum), in bf16 and fp32; vit_tiny is 192 wide with 3
# heads (K4, K5 and K6 at C = 192). Phases 2-4c hold the kernels at these
# shapes too, phase 9 times them (keys "vitg ..." and "vit_tiny ...")
G_HEADS, G_WIDTH, TINY_HEADS, TINY_WIDTH = 24, 1536, 3, 192
G_FLASH_SHAPES = [(B, G_HEADS, N, 64) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)]
G_MSDA_CASES = [(f"vitg {case} B={B} {str(dt)[6:]}", (B, S, 8, G_WIDTH // 8), Lq, shapes, 4,
                 queries, dt)
                for dt in (torch.bfloat16, torch.float32) for B in (FULL_BATCH, TRAIN_BATCH)
                for case, S, Lq, shapes, queries in MSDA_GEOMETRIES]
G_MSDA_POINTS = ("hot token",)
G_ROW_SHAPES = [(B, N, G_WIDTH) for B in (FULL_BATCH, TRAIN_BATCH) for N in (1765, 1764)] + [
    (3, 1765, G_WIDTH)]
TINY_ROW_SHAPES = [(B, N, TINY_WIDTH) for B in (FULL_BATCH, TRAIN_BATCH)
                   for N in (1765, 1764)] + [(3, 1765, TINY_WIDTH)]
# the reference eval scripts (phases 2f-4i, 8za-8zc) at their published
# width, ViT-S/14 (384 wide, 12 blocks of 6 heads of 64; their heads take
# 4 × 384 channels), fp32 with exact GELU, batch 16: their walks at 224 px
# (16² + 1 = 257 tokens), tap_unet_fuse's 1.5× and 0.5× frames of it (577,
# 65: one full 64-key tile and a one-key tail), eval_dinov2_masktrans's 392
# px (785 = 6·128 + 17) and eval_dinov2_masktrans_inov's 588 (1765); and
# vit_tiny's at 224 (3 heads). Phases 2f and 4i hold K3, K6, K4 and K5
# there at batch 2 and 16, phase 9 times them at 16 ("vits ..." keys)
VITS_HEADS, VITS_WIDTH, ENTRY_BATCH = 6, 384, 16
VITS_TOKENS = (65, 257, 577, 785, 1765)
VITS_FLASH_SHAPES = [(B, VITS_HEADS, N, 64) for B in (FULL_BATCH, ENTRY_BATCH)
                     for N in VITS_TOKENS] + [(B, TINY_HEADS, 257, 64)
                                              for B in (FULL_BATCH, ENTRY_BATCH)]
# 3 images of 785 rows: the 128-row tiles straddle both image boundaries
VITS_ROW_SHAPES = [(B, N, VITS_WIDTH) for B in (FULL_BATCH, ENTRY_BATCH)
                   for N in VITS_TOKENS] + [(3, 785, VITS_WIDTH)]
# K7 at eval_dinov2_setr_cross_ete's trained backbone: one 257-token
# segment (no ids), 6 heads, in fp32 (its precision) and bf16
VITS_K7_CASE, VITS_K7_SHAPE = "vits setr_cross_ete", (ENTRY_BATCH, VITS_HEADS, 257, 64)
# vit_tiny's adapters at 224 px (phases 3d, 4h): CAViT's 16² ViT-token
# queries sample the 28², 14², 7² CNN pyramid, CACNN's pyramid queries the
# 16² tokens, 8 heads of D = 192 / 8 = 24 (48-byte bf16 rows: K1's 4-lane
# group with one lane idle), bf16 and fp32 values, batch 2 and 16 (phase 9:
# "vit_tiny adapter ..." keys)
TINY_PYRAMID, TINY_GRID = [(28, 28), (14, 14), (7, 7)], [(16, 16)]
TINY_MSDA_CASES = [(f"vit_tiny adapter {case} B={B} {str(dt)[6:]}", (B, S, 8, TINY_WIDTH // 8),
                    Lq, shapes, 4, queries, dt)
                   for dt in (torch.bfloat16, torch.float32) for B in (FULL_BATCH, ENTRY_BATCH)
                   for case, S, Lq, shapes, queries in (
                       ("cavit", 1029, 256, TINY_PYRAMID, TINY_GRID),
                       ("cacnn", 256, 1029, TINY_GRID, TINY_PYRAMID))]
TINY_MSDA_POINTS = ("hot token",)
# K7 at ViT-g's SSL step (`pretrain --arch vit_giant2` at its default crops,
# batch 8: 16 global crops, 24 heads; the same packing as ViT-S's)
G_SSL_BATCH = 8
G_K7_SHAPES = {"vitg student": (2 * G_SSL_BATCH, G_HEADS, sum(STUDENT_SEGMENTS), 64),
               "vitg teacher": (2 * G_SSL_BATCH, G_HEADS, TEACHER_N, 64)}
# phases 8j-8l run ViT-g/14 at its full width cut to 12 of its 40 blocks
# (`arch_depth`; 40 until phase 8z and the two profiles came in, 20 until
# phases 8za-8zc did), to keep the whole script well inside its limit
G_DEPTH = 12
# per ViT-g adapter forward: G_DEPTH blocks in each of the two walks, a K3
# and a K4 each; the SwiGLU MLP halves take K6, and the 4 tap norms; no K5
G_PER_FORWARD = {"flash_fwd": 2 * G_DEPTH, "msda_fwd": 7, "fused_ln_qkv": 2 * G_DEPTH,
                 "fused_ln_mlp": 0, "layernorm": 2 * G_DEPTH + 4}
# per ViT-g SSL step: the teacher's and the student's G_DEPTH blocks
# forward, the student's backward
G_SSL_PER_STEP = {"flash_attn": 2 * G_DEPTH, "flash_attn_bwd": G_DEPTH}
# the ViT-Adapter + Mask2Former stack (M12) at ViT-L/14, 518 px: the
# backbone's 37² patch tokens and the cls token ride through the blocks
# (1370 tokens); the CNN pyramid is 64², 31², 16² (5313 tokens); the pixel
# decoder's deformable self-attention runs over those levels high stride
# first at C 256 in 8 heads (D = 32), ViTAdapter's injectors (ViT tokens
# query the pyramid) and extractors (the pyramid queries the ViT grid) at
# E/8 = 128, and 48 under segment_m2f's default vit_small. Phases 2d, 3c
# and 4f hold K3, K4, K6, K1 and K2 there at batch 2 in bf16 and fp32,
# phase 9 times them at bench_m2f's batch 4 (keys "m2f ...")
M2F_BATCH = 4
M2F_TOKENS = 37 * 37 + 1
M2F_PYRAMID, M2F_GRID = [(64, 64), (31, 31), (16, 16)], [(37, 37)]
M2F_LEVELS = M2F_PYRAMID[::-1]
M2F_MSDA_GEOMETRIES = (
    ("m2f pixel_decoder", 5313, 5313, M2F_LEVELS, M2F_LEVELS, 32),
    ("m2f injector", 5313, 1369, M2F_PYRAMID, M2F_GRID, 128),
    ("m2f extractor", 1369, 5313, M2F_GRID, M2F_PYRAMID, 128),
    ("m2f vit_small injector", 5313, 1369, M2F_PYRAMID, M2F_GRID, 48),
    ("m2f vit_small extractor", 1369, 5313, M2F_GRID, M2F_PYRAMID, 48))


def m2f_msda_cases(B, geometries=M2F_MSDA_GEOMETRIES,
                   dtypes=(torch.bfloat16, torch.float32)) -> list:
    return [(f"{case} B={B} {str(dt)[6:]}", (B, S, 8, D), Lq, shapes, 4, queries, dt)
            for dt in dtypes for case, S, Lq, shapes, queries, D in geometries]


# at batch 2 the M12 cases take model-like points and a hot token beside
# the uniform ones, the planted faults and (uniform) five repeats
M2F_MSDA_POINTS = ("model", "hot token")
M2F_FLASH_SHAPES = [(B, 16, M2F_TOKENS, 64) for B in (FULL_BATCH, M2F_BATCH)]
M2F_ROW_SHAPES = [(B, M2F_TOKENS, 1024) for B in (FULL_BATCH, M2F_BATCH)]
# launches per m2f train step at ViT-L/14: 24 global blocks (K3, K4, and K5
# with tanh GELU in bench_m2f, K6 before segment_m2f's exact-GELU MLPs);
# 16 MSDA forwards (6 pixel-decoder layers, 4 injectors, 4 extractors, 2
# extra extractors) and 12 backwards (the injectors sit before the frozen
# blocks and take none); vit_large_windowed: 20 windowed blocks (K6 before
# their attention, K5 after) and 4 global ones
M2F_BENCH_STEP = {"flash_fwd": 24, "msda_fwd": 16, "msda_bwd": 12, "fused_ln_qkv": 24,
                  "fused_ln_mlp": 24, "layernorm": 0, "flash_attn": 0, "flash_attn_bwd": 0}
M2F_FP32_STEP = {**M2F_BENCH_STEP, "fused_ln_mlp": 0, "layernorm": 24}
M2F_WINDOWED_STEP = {**M2F_BENCH_STEP, "flash_fwd": 4, "fused_ln_qkv": 4, "layernorm": 20}
M2F_SMALL_STEP = {**M2F_FP32_STEP, "flash_fwd": 12, "fused_ln_qkv": 12, "layernorm": 12}
# the frozen-feature evals (M14) at ViT-L/14, 224 px: 16² patches and the
# cls token (257 tokens, a tail tile that is no multiple of 64 or 128),
# evals_cli's batch 64, fp32 with exact GELU (the JAX CLI's precision).
# Phases 2e and 4g hold K3, K4 and K6 there at batch 2 and 64, phase 9
# times them at 64 ("eval ..." keys). Per extraction forward: 24 blocks of
# K4 → K3 → K6 before the plain erf MLP, and the final norm of each of the
# 4 taps (K6); no K5, no MSDA. evals_cli extracts 4 batches a split; the
# linear mode also walks the train split `EVAL_EPOCHS` times and the val
# split once for the probe grid
EVAL_BATCH, EVAL_IMSIZE, EVAL_TOKENS, EVAL_EPOCHS = 64, 224, 16 * 16 + 1, 2
# 8y: DepthEncoderDecoder at ViT-L/14 width, 420 × 560: 30 × 40 patches and
# the cls token (1201 = 18 · 64 + 49 tokens: another key tail and another
# 128-row tail than 257's), whose K3, K4 and K6 shapes 2e and 4g hold too
DEPTH_BATCH, DEPTH_HW, DEPTH_STEPS = 4, (420, 560), 3
DEPTH_TOKENS = (DEPTH_HW[0] // 14) * (DEPTH_HW[1] // 14) + 1
EVAL_FLASH_SHAPES = [(B, 16, EVAL_TOKENS, 64) for B in (FULL_BATCH, EVAL_BATCH)] + [
    (DEPTH_BATCH, 16, DEPTH_TOKENS, 64)]
EVAL_ROW_SHAPES = [(B, EVAL_TOKENS, 1024) for B in (FULL_BATCH, EVAL_BATCH)] + [
    (DEPTH_BATCH, DEPTH_TOKENS, 1024)]
EVAL_PER_FORWARD = {"flash_fwd": 24, "msda_fwd": 0, "fused_ln_qkv": 24, "fused_ln_mlp": 0,
                    "layernorm": 24 + 4}
EVAL_FORWARDS = {"knn": 8, "logreg": 8, "linear": 8 + 4 * EVAL_EPOCHS + 4}
# 8x: k-NN at ImageNet-1k's sizes on seeded random features, and one C of
# the logistic-regression sweep
KNN_TRAIN, KNN_TEST, KNN_DIM, KNN_CLASSES, KNN_KS = 1_281_167, 50_000, 1024, 1000, (10, 20, 100,
                                                                                 200)
LOGREG_TRAIN, LOGREG_VAL = 100_000, 10_000
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W); fp32
# is the CUDA cores' rate, "tf32x3" the rate of fp32 products at fp32
# accuracy as three TF32 products each on the tensor cores (495 TFLOP/s / 3)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 495e12 / 3}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **kw}), flush=True)


def flash_inputs(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    # scores of std ≈ 2.25: peaked rows, so a mishandled key or tail shows
    q, k, v = (torch.randn(shape, generator=g) * s for s in (1.5, 1.5, 1.0))
    return [x.to(dtype).cuda() for x in (q, k, v)]


def msda_inputs(vshape, Lq, shapes, P, seed, points="uniform", queries=None,
                dtype=torch.bfloat16):
    """value ~ N(0, 1) in `dtype`, aw a softmax over each head's L·P points, g ~
    N(0, 1) fp32, and the sampling locations by `points`: "uniform" in
    [−0.1, 1.1] (points partly outside their levels); "model", each query's
    reference point on its grid (`queries`) plus the sampling_offsets bias
    that `ops/ms_deform_attn.py` initialises (a few pixels away, per head in
    its own direction); "hot token", uniform but every point of head 0 on
    one pixel centre of each level, so that one token per level takes every
    corner of the head; "pixel edges", every coordinate within one fp32
    rounding (0 or ±1 ulp) of a pixel edge k/W or a pixel centre (k + ½)/W,
    where the corners and the location gradient change; "all outside",
    every point outside its level (|x| beyond every corner)."""
    g = torch.Generator().manual_seed(seed)
    B, S, M, D = vshape
    L = len(shapes)
    value = torch.randn(vshape, generator=g).to(dtype)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=g) * 1.2 - 0.1
    aw = torch.softmax(torch.randn((B, Lq, M, L * P), generator=g), -1)
    grad = torch.randn((B, Lq, M * D), generator=g)
    if points == "model":
        from adaptersis_tpu_torch.ops.ms_deform_attn import _directional_offset_bias
        ref = torch.cat([torch.stack(torch.meshgrid((torch.arange(w) + 0.5) / w,
                                                    (torch.arange(h) + 0.5) / h,
                                                    indexing="xy"), -1).reshape(-1, 2)
                         for h, w in queries])                        # (Lq, 2) as (x, y)
        bias = torch.from_numpy(_directional_offset_bias(M, L, P)).view(M, L, P, 2)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        loc = (ref[:, None, None, None] + bias / norm[:, None]).expand(B, -1, -1, -1, -1, -1)
    elif points == "hot token":
        for lvl, (h, w) in enumerate(shapes):
            loc[:, :, 0, lvl, :, 0] = (w // 2 + 0.5) / w
            loc[:, :, 0, lvl, :, 1] = (h // 2 + 0.5) / h
    elif points == "pixel edges":
        for lvl, (h, w) in enumerate(shapes):
            for axis, n in ((0, w), (1, h)):
                sh = loc[:, :, :, lvl, :, axis].shape
                k = torch.randint(-1, n + 2, sh, generator=g).double()
                half = 0.5 * (torch.rand(sh, generator=g) < 0.5)
                at = ((k + half) / n).float()
                nudge = torch.randint(-1, 2, sh, generator=g)
                inf = torch.full_like(at, math.inf)
                at = torch.where(nudge < 0, torch.nextafter(at, -inf),
                                 torch.where(nudge > 0, torch.nextafter(at, inf), at))
                loc[:, :, :, lvl, :, axis] = at
    elif points == "all outside":
        u = torch.rand(loc.shape, generator=g)
        loc = torch.where(loc < 0.5, -0.2 - 0.3 * u, 1.2 + 0.3 * u)
    elif points != "uniform":
        raise ValueError(points)
    return (value.cuda(), loc.contiguous().cuda(), aw.reshape(B, Lq, M, L, P).cuda(),
            grad.cuda())


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


def qkv_from_xn(xn, w, b, heads, dtype):
    """fused_ln_qkv_plain's product and head split from a given xn (values
    of `dtype`, summed in xn's float type)."""
    B, N, C = xn.shape
    y = (xn @ w.to(dtype).to(xn.dtype).t() + b.to(xn.dtype)).to(dtype)
    y = y.reshape(B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    return [t.contiguous() for t in y]


def qkv_allowance(xn, w, heads, refs):
    """Per-element bound on |K4 − plain| in fp32 (phase 4b, beside
    `row_check`'s 1e-4·max|plain|): ulp(|ref|) + 2⁻¹⁷·Σ_k |xn_k|·|w_jk|, i.e.
    128 fp32 units of the dot product's absolute sum, for the kernel's sums
    in another order and 3×TF32's dropped terms (≈ 2⁻²² of each product),
    and the fast variance's cancellation carried into xn. One TF32 pass
    (`ops/tf32.py`, 2⁻¹² of each product) reads ≈ 10 of it. Returns one
    bound per output of `refs` (q, k, v)."""
    B, N, C = xn.shape
    asum = (xn.abs() @ w.float().abs().t()).reshape(B, N, 3, heads, C // heads)
    return [ulp(r, torch.float32) + 2.0 ** -17 * a
            for r, a in zip(refs, asum.permute(2, 0, 3, 1, 4))]


def row_check(report, row_err, kname, pairs, extra, shape, dtype) -> float:
    """Phase 4b's bound for K6 and K4 on (kernel, plain) output pairs: bf16
    2⁻⁷·max|plain| + `extra`, fp32 1e-4·max|plain|; records the error (fp32
    under "<kname> fp32") and returns the bound."""
    bf = dtype == torch.bfloat16
    for o, r in pairs:
        if o.shape != r.shape or o.dtype != dtype or not o.is_contiguous():
            fail(f"{kname} returned {tuple(o.shape)} {o.dtype}, plain {tuple(r.shape)} {r.dtype}")
    err = max((o.float() - r.float()).abs().max().item() for o, r in pairs)
    scale = max(r.float().abs().max().item() for _, r in pairs)
    bound = 2.0 ** -7 * scale + extra if bf else 1e-4 * scale
    report[kname] = {"max_abs_err": err, "bound": bound}
    if not err <= bound:
        fail(f"{kname} kernel disagrees with plain at {shape} {dtype}: {err} > {bound}")
    key = kname if bf else f"{kname} fp32"
    row_err[key] = max(row_err.get(key, 0.0), err)
    return bound


def same_bits(kname, first, call, repeats=5) -> bool:
    """Fails unless `repeats` more calls give `first`'s bits: the kernel
    sums in a fixed order (no atomics)."""
    for _ in range(repeats):
        if not all(torch.equal(a, b) for a, b in zip(call(), first)):
            fail(f"{kname}: a repeated call gave other bits")
    return True


U32 = 2.0 ** -24  # fp32's unit roundoff


def msda_corners(loc, aw, shapes):
    """Every bilinear corner of every point, in K2's source order per (b, m):
    tokens, in-level masks and forward weights (wx·wy)·a, each (B, M, Lq·NC)
    with NC = 4·L·P ordered (q, l, p, corner), corner = 2·dy + dx; and wx,
    wy as (B, Lq, M, L, P, 4). Rounded as msda_plain rounds them."""
    B, Lq, M, L, P, _ = loc.shape
    tok, valid, wxs, wys = [], [], [], []
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        t_l, v_l, wx_l, wy_l = [], [], [], []
        for k in range(4):
            dx, dy = k & 1, k >> 1
            xi, yi = x0.long() + dx, y0.long() + dy
            v_l.append((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))
            t_l.append(start + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
            wx_l.append(tx if dx else 1 - tx)
            wy_l.append(ty if dy else 1 - ty)
        for dst, src in ((tok, t_l), (valid, v_l), (wxs, wx_l), (wys, wy_l)):
            dst.append(torch.stack(src, -1))                     # (B, Lq, M, P, 4)
        start += H * W
    tok, valid, wx, wy = (torch.stack(t, 3) for t in (tok, valid, wxs, wys))
    w = (wx * wy) * aw[..., None] * valid

    def flat(t):
        return t.permute(0, 2, 1, 3, 4, 5).reshape(B, M, -1)

    return flat(tok), flat(valid), flat(w), wx, wy


def valid_corners(loc, aw, shapes) -> int:
    """Bilinear corners inside their level: the work MSDA does on this data."""
    return int(msda_corners(loc, aw, shapes)[1].sum())


def msda_fwd_allowance(value, loc, aw, shapes):
    """Per-element bound on |K1 − plain| (phase 3): (2n + 2)·u·Σ|t| with
    n = 4·L·P terms and Σ|t| = Σ a·wx·wy·|v| (`msda_allowances`)."""
    from adaptersis_tpu_torch.ops.msda_cuda import msda_plain
    return (2 * 4 * loc.shape[3] * loc.shape[4] + 2) * U32 * msda_plain(
        value.float().abs(), loc, aw, shapes)


def msda_allowances(value, loc, aw, grad, shapes, ref_dv):
    """Per-element bounds on |kernel − plain| for K2's dV, dloc and daw
    (phase 4), and K1's output (`msda_fwd_allowance`). Both sides sum the same fp32 products
    (the same corners and weights: both round loc·W − 0.5 as PyTorch does)
    in other orders, so each element of each side lies within (n − 1)·u
    of its sum's absolute terms Σ|t|, plus u for the products the kernel
    fuses into its adds: ε = (2n + 2)·u·Σ|t| with u = 2⁻²⁴ and n the
    element's terms. The output: n = 4·L·P, Σ|t| = Σ a·wx·wy·|v|. dV: n =
    the token's own contributions, Σ|t| = Σ w·|g|, and dV is rounded once to
    bf16: ½ ulp(|ref| + ε) + ε. daw, dloc: the dot products of D terms
    over four corners, n = D + 4, Σ|t| = Σ_c wx·wy·Σ_d |v·g| (daw) and
    a·W·Σ_c wy·Σ_d |v·g| (dloc x; y likewise). A point whose corners all
    lie outside gets a bound of 0: both sides must give exact zeros."""
    B, S, M, D = value.shape
    L, P = loc.shape[3], loc.shape[4]
    from adaptersis_tpu_torch.ops.msda_cuda import msda_plain
    va = value.float().abs()
    with torch.enable_grad():
        v = value.float().requires_grad_()
        dv_abs = torch.autograd.grad(msda_plain(v, loc, aw, shapes), v, grad.abs())[0]
    tok, valid, _, wx, wy = msda_corners(loc, aw, shapes)
    n = torch.zeros(B, M, S, device=value.device).scatter_add_(2, tok, valid.float())
    eps = (2 * n.permute(0, 2, 1)[..., None] + 2) * U32 * dv_abs
    dv = ulp(ref_dv.abs() + eps, value.dtype) / 2 + eps if value.dtype == torch.bfloat16 else eps
    # Σ_d |v·g| per corner (B, Lq, M, L, P, 4), 0 outside
    ga = grad.view(B, -1, M, D).abs().permute(0, 2, 1, 3)         # (B, M, Lq, D)
    vt = va.permute(0, 2, 1, 3)                                   # (B, M, S, D)
    Lq = loc.shape[1]
    dots = torch.zeros(B, M, Lq * L * P * 4, device=value.device)
    for c0 in range(0, Lq, 256):  # a query block at a time: the gathered rows are large
        c1 = min(Lq, c0 + 256)
        cols = slice(c0 * L * P * 4, c1 * L * P * 4)
        rows = vt.gather(2, tok[:, :, cols, None].expand(-1, -1, -1, D))
        rows = rows.view(B, M, c1 - c0, L * P * 4, D) * ga[:, :, c0:c1, None]
        dots[:, :, cols] = rows.sum(-1).view(B, M, -1) * valid[:, :, cols]
    dots = dots.view(B, M, Lq, L, P, 4).permute(0, 2, 1, 3, 4, 5)
    gam = (2 * (D + 4) + 2) * U32
    daw = gam * (wx * wy * dots).sum(-1)
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=value.device)
    dloc = gam * aw[..., None] * size[:, None] * torch.stack(
        [(wy * dots).sum(-1), (wx * dots).sum(-1)], -1)
    return dv, dloc, daw


def worst_share(diff, allow) -> float:
    """max |kernel − plain| / bound; a difference where the bound is 0
    reads as a huge share."""
    return (diff / allow.clamp_min(1e-38)).max().item()


def level_moved(value, shapes):
    """value with one level's rows moved by one token (level 1, or level 0
    where there is one level): what a kernel reading that level from
    start + 1 would see."""
    lvl = 1 if len(shapes) > 1 else 0
    s0 = sum(h * w for h, w in shapes[:lvl])
    n = shapes[lvl][0] * shapes[lvl][1]
    moved = value.clone()
    moved[:, s0:s0 + n - 1] = value[:, s0 + 1:s0 + n]
    return moved


def first_dropped(dv, loc, aw, grad, shapes):
    """dV as a K2 that lost each token's first contribution (in source
    order) would give it: kernel dV − w·g of that contribution, rounded to
    dV's dtype."""
    B, S, M, D = dv.shape
    tok, valid, w, _, _ = msda_corners(loc, aw, shapes)
    nc = tok.shape[2] // loc.shape[1]
    big = tok.shape[2]
    src = torch.arange(big, device=dv.device).expand_as(tok)
    first = torch.full((B, M, S), big, dtype=torch.long, device=dv.device).scatter_reduce_(
        2, tok, torch.where(valid, src, big), "amin")
    has = first < big
    f = first.clamp(max=big - 1)
    wf = w.gather(2, f) * has
    g = grad.view(B, -1, M, D).permute(0, 2, 1, 3)
    gq = g.gather(2, (f // nc)[..., None].expand(-1, -1, -1, D))
    return (dv.float() - (wf[..., None] * gq).permute(0, 2, 1, 3)).to(dv.dtype)


def x_weights_swapped(loc, shapes):
    """loc moved so that each point keeps its corners but its x0 and x0+1
    corners trade weights (tx → 1 − tx)."""
    out = loc.clone()
    for lvl, (_, W) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        x0 = torch.floor(x)
        out[:, :, :, lvl, :, 0] = (x0 + 1 - (x - x0) + 0.5) / W
    return out


def msda_cases(cases, at_b2):
    """Phase 3 and 4's cases: (index, case tuple, points) over `cases`: the
    uniform points everywhere, the model-like ones at batch 16, `at_b2`
    (MSDA_POINTS, G_MSDA_POINTS) at batch 2."""
    for i, c in enumerate(cases):
        extra = ["model"] if c[1][0] == TRAIN_BATCH else list(at_b2)
        for points in ["uniform", *extra]:
            yield i, c, points


def repeated(case: str, vshape, points: str) -> bool:
    """Where phases 3 and 4 call a kernel five more times: CAViT's geometry
    at batch 16 and every M12 case on uniform points (and, for K2, every
    hot token)."""
    return points == "uniform" and ((vshape[0] == TRAIN_BATCH and "cavit" in case)
                                    or case.startswith("m2f "))


def check_msda_fwd(mc, cases=MSDA_CASES, at_b2=MSDA_POINTS) -> float:
    """Phase 3: K1 against msda_plain on the same values, every element
    within its bound (`msda_allowances`), in every case of `msda_cases`.
    Five more calls at CAViT batch 16 must give the same bits, and on the
    uniform batch-2 points a planted fault must break the bound: a level's
    start offset moved by one token (`level_moved`). Returns the largest
    error on uniform points."""
    worst = 0.0
    with torch.no_grad():
        for i, (case, vshape, Lq, shapes, P, queries, dt), points in msda_cases(cases, at_b2):
            value, loc, aw, grad = msda_inputs(vshape, Lq, shapes, P, 10 + i, points, queries,
                                               dt)
            out = mc.msda_fwd(value, loc, aw, shapes)
            torch.cuda.synchronize()
            ref = mc.msda_plain(value, loc, aw, shapes)
            allow = msda_fwd_allowance(value, loc, aw, shapes)
            diff = (out - ref).abs()
            report = {"max_abs_err": diff.max().item(), "worst_share_of_bound": worst_share(
                diff, allow), "bound_max": allow.max().item(),
                "corners_inside": valid_corners(loc, aw, shapes), "corners": loc[..., 0].numel() * 4}
            if points == "uniform" and vshape[0] == FULL_BATCH:
                report["level_moved_share"] = worst_share(
                    (mc.msda_fwd(level_moved(value, shapes), loc, aw, shapes) - ref).abs(), allow)
                if not report["level_moved_share"] > 1:
                    fail(f"msda_fwd: the bound passes a level moved by one token ({case})")
            if repeated(case, vshape, points):
                report["repeats_bit_identical"] = same_bits(
                    "msda_fwd", [out], lambda: [mc.msda_fwd(value, loc, aw, shapes)])
            say("msda_check", case=case, points=points, value=list(vshape), dtype=str(dt),
                Lq=Lq, levels=shapes, **report)
            if not report["worst_share_of_bound"] <= 1:
                fail(f"msda_fwd disagrees with plain ({case}, {points}): an error is "
                     f"{report['worst_share_of_bound']} of its bound")
            if points == "uniform":
                worst = max(worst, report["max_abs_err"])
            del value, loc, aw, grad, out, ref, allow, diff
            torch.cuda.empty_cache()
    return worst


def check_msda_bwd(mc, cases=MSDA_CASES, at_b2=MSDA_POINTS) -> float:
    """Phase 4: K2 against the autograd of msda_plain (fp32 sums of the same
    bf16 values) with a seeded fp32 incoming gradient, dvalue, dloc and daw
    each element within its bound (`msda_allowances`), in every case of
    `msda_cases`; dvalue in the value's dtype. Five more calls at CAViT
    batch 16, and on the hot token (whose bins several warps of the sum pass
    share, in whatever order they finish), must give the same bits in all
    three, and on the uniform
    batch-2 points two planted faults must break the dvalue bound: each
    token's first contribution dropped (`first_dropped`), and every
    point's x0 and x0+1 corner weights swapped (`x_weights_swapped`).
    Returns the largest error on uniform points."""
    worst = 0.0
    for i, (case, vshape, Lq, shapes, P, queries, dt), points in msda_cases(cases, at_b2):
        value, loc, aw, grad = msda_inputs(vshape, Lq, shapes, P, 20 + i, points, queries, dt)
        got = mc.msda_bwd(value, loc, aw, grad, shapes)
        torch.cuda.synchronize()
        if got[0].dtype != value.dtype:
            fail(f"msda backward returned dvalue in {got[0].dtype}, value is {value.dtype}")
        with torch.enable_grad():
            leaves = [value.float().requires_grad_(), loc.clone().requires_grad_(),
                      aw.clone().requires_grad_()]
            want = torch.autograd.grad(mc.msda_plain(*leaves, shapes), leaves, grad)
        with torch.no_grad():
            allows = msda_allowances(value, loc, aw, grad, shapes, want[0])
            report = {}
            for gname, g, w, allow in zip(("dvalue", "dloc", "daw"), got, want, allows):
                diff = (g.float() - w).abs()
                report[gname] = {"max_abs_err": diff.max().item(),
                                 "worst_share_of_bound": worst_share(diff, allow),
                                 "bound_max": allow.max().item()}
                if not report[gname]["worst_share_of_bound"] <= 1:
                    fail(f"msda backward disagrees with plain ({case}, {points}, {gname}): "
                         f"an error is {report[gname]['worst_share_of_bound']} of its bound")
                if points == "uniform":
                    worst = max(worst, report[gname]["max_abs_err"])
            if points == "uniform" and vshape[0] == FULL_BATCH:
                wrong = {"first contribution dropped": first_dropped(got[0], loc, aw, grad, shapes),
                         "x weights swapped": mc.msda_bwd(value, x_weights_swapped(loc, shapes),
                                                          aw, grad, shapes)[0]}
                report["planted_faults_share"] = {
                    k: worst_share((v.float() - want[0]).abs(), allows[0]) for k, v in wrong.items()}
                if not all(v > 1 for v in report["planted_faults_share"].values()):
                    fail(f"msda_bwd: the dvalue bound passes a planted fault ({case}): "
                         f"{report['planted_faults_share']}")
                del wrong
            if repeated(case, vshape, points) or points == "hot token":
                report["repeats_bit_identical"] = same_bits(
                    "msda_bwd", got, lambda: mc.msda_bwd(value, loc, aw, grad, shapes))
        say("msda_bwd_check", case=case, points=points, value=list(vshape), dtype=str(dt),
            Lq=Lq, levels=shapes, **report)
        del value, loc, aw, grad, got, want, leaves, allows
        torch.cuda.empty_cache()
    return worst


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


def device_ms(fn, iters=20, replays=5, stream=None):
    """Device time per call alone: `iters` calls captured in one CUDA graph,
    replayed `replays` times between two events, so that the host's launch
    path (Python, argument checks, allocation, ctypes) is not in it.
    `stream` is the stream to capture on: a backward's must be the stream
    its forward ran on."""
    s = stream or torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del g
    torch.cuda.empty_cache()
    return ms


def kernel_split(fn, names, calls=20):
    """Device ms per call of each kernel whose name holds one of `names`,
    from torch.profiler's trace of `calls` calls of fn (after one warm-up):
    the split of a function that launches several kernels."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    ms[n] += e.time_range.elapsed_us() / 1e3 / calls
    return ms


def host_us(fn, calls=1000):
    """Host time per call: a host clock over `calls` calls with no
    synchronise inside. Where the device takes longer per call, the launch
    queue fills and the device's pace shows through."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def kernel_times(ff, mc, fq, fm, ln, fa, only=""):
    """Phase 9: kernel, plain and library times at the bf16 shapes of phases
    2-4c, and each kernel's bound from the same inputs. `times[key]` =
    (kernel, plain, library) back-to-back calls between CUDA events
    (`cuda_ms`), `dev[key]` = (kernel, library) from graph replay
    (`device_ms`), `host[key]` = (kernel, library) µs per call
    (`host_us`, for K3 and SDPA, K6 and F.layer_norm); `extra[key]` holds
    what else a kernel replaced. ViT-g's and vit_tiny's shapes (M2b) are
    timed at batch 16 under keys "vitg ..." and "vit_tiny ...", kept out of
    the kernels line; `only` = "eval" times only M14's "eval ..." keys,
    "entries" only the "vits ..." and "vit_tiny adapter ..." keys."""
    F = torch.nn.functional
    times, bounds, extra, dev, host = {}, {}, {}, {}, {}

    def timed(key, kernel, plain, library=None, host_too=False, library_capture=None):
        """library_capture: (fn, stream) to graph in place of `library`."""
        times[key] = (cuda_ms(kernel), cuda_ms(plain),
                      None if library is None else cuda_ms(library))
        lib_dev = library_capture or (library, None)
        dev[key] = (device_ms(kernel),
                    None if library is None else device_ms(lib_dev[0], stream=lib_dev[1]))
        if host_too:
            host[key] = (host_us(kernel), None if library is None else host_us(library))

    def flash_times(shapes, tag="", k7_body=False, host_too=False, seed=0,
                    dtype=torch.bfloat16):
        for shape in shapes:
            q, k, v = flash_inputs(shape, seed=seed, dtype=dtype)
            B, H, N, Dh = shape
            key = f"{tag}flash_fwd B={B} N={N}"
            timed(key, lambda: ff.flash_fwd(q, k, v, 0.125),
                  lambda: ff.flash_fwd_plain(q, k, v, 0.125),
                  lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125),
                  host_too=host_too)
            # fp32 at Dh 64 runs 3×TF32 on the tensor cores: its bound is
            # that work's, with the CUDA cores' fp32 bound beside it
            kind = "bf16" if dtype == torch.bfloat16 else "tf32x3" if Dh == 64 else "fp32"
            nbytes, flops = 4 * q.numel() * q.element_size(), 4 * B * H * N * N * Dh
            bounds[key] = bound_ms(nbytes, flops, kind)
            if kind == "tf32x3":
                extra[key] = {"bound_fp32_cuda_cores": bound_ms(nbytes, flops, "fp32")}
            if k7_body:
                # K7's forward body (no ids) on K3's inputs: whether one body
                # could serve both
                extra[key] = {"k7_fwd_device": device_ms(
                    lambda: fa.flash_attn_fwd_kernel(q, k, v, 0.125))}
            del q, k, v
            torch.cuda.empty_cache()

    def msda_times(cases, tag="", hot_too=True, points_timed=("uniform", "model"), split=True):
        """K1 and K2 on uniform points (the kernels line's), on model-like
        ones and, at batch 16, with a hot token; beside the HBM bound, the
        corner rows each call moves through the L2 (in-level corners × D ×
        the value's bytes, and for K2's dV pass a 4·D byte g row per
        corner) and the rate reached on the device; with `split` K2's device
        time split into its four kernels (`kernel_split`)"""
        for i, (case, vshape, Lq, shapes, P, queries, dt) in enumerate(cases):
            hot = ["hot token"] if vshape[0] == TRAIN_BATCH and hot_too else []
            for points in (*points_timed, *hot):
                value, loc, aw, grad = msda_inputs(vshape, Lq, shapes, P, 10 + i, points,
                                                   queries, dt)
                D = vshape[3]
                corners = valid_corners(loc, aw, shapes)
                small = (loc.numel() + aw.numel()) * 4
                name = case[len(tag):] if case.startswith(tag) else case
                pts = "" if points == "uniform" else f" {points}"
                key = f"{tag}msda_fwd {name}{pts}"
                timed(key, lambda: mc.msda_fwd(value, loc, aw, shapes),
                      lambda: mc.msda_plain(value, loc, aw, shapes))
                bounds[key] = bound_ms(value.numel() * value.element_size() + small
                                       + grad.numel() * 4, 2 * D * corners, "fp32")
                l2 = corners * D * value.element_size()
                extra[key] = {"corners_inside": corners, "l2_bytes": l2,
                              "l2_tb_per_s": l2 / dev[key][0] * 1e-9}
                key = f"{tag}msda_bwd {name}{pts}"
                with torch.enable_grad():
                    leaves = [value.float().requires_grad_(), loc.clone().requires_grad_(),
                              aw.clone().requires_grad_()]
                    out = mc.msda_plain(*leaves, shapes)
                    timed(key, lambda: mc.msda_bwd(value, loc, aw, grad, shapes),
                          lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
                # reads value, loc, aw, g; writes dvalue (value's dtype), dloc, daw
                bounds[key] = bound_ms(2 * value.numel() * value.element_size() + 2 * small
                                       + grad.numel() * 4, 4 * D * corners, "fp32")
                l2 = corners * D * (value.element_size() + 4)
                extra[key] = {"corners_inside": corners, "l2_bytes": l2,
                              "l2_tb_per_s": l2 / dev[key][0] * 1e-9}
                if split:
                    extra[key]["pass_ms"] = kernel_split(
                        lambda: mc.msda_bwd(value, loc, aw, grad, shapes),
                        ("point_kernel", "sort_kernel", "plan_kernel", "sum_kernel"))
                del leaves, out, value, loc, aw, grad
                torch.cuda.empty_cache()

    def row_times(shapes, heads, tag="", k5=True, dtype=torch.bfloat16):
        """K6, K4 and K5 at the walks' shapes, bf16 with bf16 parameters (the
        frozen backbone's, read in place; or all fp32 with `dtype`). Beside
        plain and library: the unfused PyTorch sequence each replaced (under
        autocast, as the training step ran it: LayerNorm to fp32, casts,
        F.linear, the q/k/v relayout, GELU) and cuBLAS's GEMMs alone on the
        normalised input"""
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        # the GEMMs' fp32 products run 3×TF32 on the tensor cores
        gemm = "bf16" if kind == "bf16" else "tf32x3"
        for shape in shapes:
            x, p = row_inputs(shape, dtype, seed=0, params_dtype=dtype)
            B, N, C = shape
            R = B * N
            lw, lb = p["ln_w"].to(x.dtype), p["ln_b"].to(x.dtype)
            xn = F.layer_norm(x, (C,), lw, lb, 1e-6)
            xb, pe = x.numel() * x.element_size(), p["ln_w"].element_size()
            key = f"{tag}layernorm B={B} N={N}"
            timed(key, lambda: ln.layernorm(x, p["ln_w"], p["ln_b"]),
                  lambda: ln.layernorm_plain(x, p["ln_w"], p["ln_b"]),
                  lambda: F.layer_norm(x, (C,), lw, lb, 1e-6), host_too=True)
            # reads x, w, b; writes y; ≈ 8 fp32 operations per element
            bounds[key] = bound_ms(2 * xb + 2 * C * pe, 8 * R * C, "fp32")

            def unfused_qkv():
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=kind == "bf16"):
                    y = F.linear(F.layer_norm(x, (C,), lw, lb, 1e-6), p["w"], p["b"])
                qkv = y.reshape(B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
                return [t.contiguous() for t in qkv]

            key = f"{tag}fused_ln_qkv B={B} N={N}"
            qkv_args = (x, p["ln_w"], p["ln_b"], p["w"], p["b"], heads)
            timed(key, lambda: fq.fused_ln_qkv(*qkv_args),
                  lambda: fq.fused_ln_qkv_plain(*qkv_args))
            flops = 2 * R * C * 3 * C
            extra[key] = {"unfused": cuda_ms(unfused_qkv),
                          "cublas_gemm": cuda_ms(lambda: F.linear(xn, p["w"], p["b"].to(x.dtype))),
                          "tflops_device": flops / dev[key][0] * 1e-9}
            # reads x, the LN parameters, w, b; writes q, k, v (3·x)
            qkv_bytes = 4 * xb + p["w"].numel() * p["w"].element_size() + (2 + 3) * C * pe
            bounds[key] = bound_ms(qkv_bytes, flops, gemm)
            if kind == "fp32":
                extra[key]["bound_fp32_cuda_cores"] = bound_ms(qkv_bytes, flops, "fp32")
            if not k5:
                del x, p, xn
                torch.cuda.empty_cache()
                continue

            def unfused_mlp():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    h = F.gelu(F.linear(F.layer_norm(x, (C,), lw, lb, 1e-6), p["w1"], p["b1"]),
                               approximate="tanh")
                    return x + p["gamma"].to(x.dtype) * F.linear(h, p["w2"], p["b2"])

            h = F.gelu(F.linear(xn, p["w1"], p["b1"].to(x.dtype)), approximate="tanh")
            key = f"{tag}fused_ln_mlp B={B} N={N}"
            mlp_args = (x, p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"])
            timed(key, lambda: fm.fused_ln_mlp(*mlp_args),
                  lambda: fm.fused_ln_mlp_plain(*mlp_args))
            flops = 2 * 2 * R * C * 4 * C
            extra[key] = {"unfused": cuda_ms(unfused_mlp),
                          "cublas_gemm": cuda_ms(lambda: (F.linear(xn, p["w1"]),
                                                          F.linear(h, p["w2"]))),
                          "tflops_device": flops / dev[key][0] * 1e-9}
            # reads x, the LN parameters, w1, b1, w2, b2, γ; writes out
            bounds[key] = bound_ms(2 * xb + 2 * p["w1"].numel() * pe + 8 * C * pe, flops, gemm)
            del x, p, xn, h
            torch.cuda.empty_cache()

    def k7_times(cases, tag="", dtype=torch.bfloat16):
        """K7 (bf16, or `dtype`): forward, and backward from the forward's o
        and lse; beside plain, PyTorch's SDPA with the boolean block-diagonal
        mask (the student's; none for the teacher and setr_ete), forward and
        its backward alone (autograd.grad with the graph kept; graphed on
        the stream its forward ran on)"""
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        for case, shape in cases.items():
            q, k, v, do = k7_inputs(shape, dtype, seed=0)
            B, H, N, Dh = shape
            student = case.endswith("student")
            segs = STUDENT_SEGMENTS if student else [N]
            seg = packed_ids(B, segs) if student else None
            mask = None if seg is None else seg[:, None, :, None] == seg[:, None, None, :]
            o, lse = fa.flash_attn_fwd_kernel(q, k, v, 0.125, seg)
            pairs = own_segment_pairs(B, H, segs)
            tb, ib = q.numel() * q.element_size(), (0 if seg is None else seg.numel() * 4)
            name = case[len(tag):] if case.startswith(tag) else case
            key = f"{tag}flash_attn {name}"
            timed(key, lambda: fa.flash_attn_fwd_kernel(q, k, v, 0.125, seg),
                  lambda: fa.flash_attn_fwd_plain(q, k, v, 0.125, seg),
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.125))
            # reads q, k, v and the ids; writes o and lse; q·kᵀ and p·v over
            # the own-segment pairs
            bounds[key] = bound_ms(4 * tb + lse.numel() * 4 + ib, 4 * Dh * pairs, kind)
            if seg is None:  # K3's body on the teacher's inputs (no lse store)
                extra[key] = {"k3_device": device_ms(lambda: ff.flash_fwd(q, k, v, 0.125))}
            key = f"{tag}flash_attn_bwd {name}"
            side = torch.cuda.Stream()
            with torch.enable_grad():
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=0.125)
                # the graphed backward's own leaves and forward, made on the
                # capture stream: autograd runs a node on its forward's stream
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    leaves_side = [x.clone().requires_grad_() for x in (q, k, v)]
                    out_side = F.scaled_dot_product_attention(*leaves_side, attn_mask=mask,
                                                              scale=0.125)
                torch.cuda.current_stream().wait_stream(side)

                def lib_both():
                    y = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=0.125)
                    return torch.autograd.grad(y, leaves, do)

                extra[key] = {"library_fwd_and_bwd": cuda_ms(lib_both)}
                timed(key, lambda: fa.flash_attn_bwd_kernel(q, k, v, o, lse, do, 0.125, seg),
                      lambda: fa.flash_attn_bwd_plain(q, k, v, o, lse, do, 0.125, seg),
                      lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                      library_capture=(lambda: torch.autograd.grad(out_side, leaves_side, do,
                                                                   retain_graph=True), side))
            # reads q, k, v, o, do, lse and the ids; writes dq, dk, dv; five
            # products over the own-segment pairs (q·kᵀ, do·vᵀ, pᵀ·do,
            # dsᵀ·q, ds·k)
            bounds[key] = bound_ms(8 * tb + lse.numel() * 4 + ib, 10 * Dh * pairs, kind)
            del q, k, v, do, o, lse, leaves, out, leaves_side, out_side, mask
            torch.cuda.empty_cache()

    def at_16(shapes):
        return [s for s in shapes if s[0] == TRAIN_BATCH]

    def eval_times():
        """M14 at evals_cli's batch 64: the fp32 K3 at ViT-L/14's 257 tokens
        against SDPA in fp32, K6 and K4 at 16448 rows against the unfused
        sequence and cuBLAS's fp32 GEMM (TF32 off)"""
        flash_times([(EVAL_BATCH, 16, EVAL_TOKENS, 64)], "eval ", seed=3, dtype=torch.float32)
        row_times([(EVAL_BATCH, EVAL_TOKENS, 1024)], HEADS, "eval ", k5=False,
                  dtype=torch.float32)

    def entry_times():
        """At batch 16: the eval scripts' fp32 K3 at ViT-S/14's walks (6
        heads) against SDPA, K6 and K4 at C = 384 against the unfused
        sequence and cuBLAS's fp32 GEMM, and in bf16 K6, K4 and K5 at 224
        px; K7 in fp32 at setr_cross_ete's (16, 6, 257, 64), forward and
        backward, against SDPA; vit_tiny's K3 (3 heads), K6, K4 (and in
        bf16 K5) at 224 px in fp32 and bf16, and K1 and K2 at its adapters
        (D = 24, uniform points) in both dtypes"""
        flash_times([(ENTRY_BATCH, VITS_HEADS, N, 64) for N in VITS_TOKENS], "vits ", seed=4,
                    dtype=torch.float32)
        row_times([(ENTRY_BATCH, N, VITS_WIDTH) for N in VITS_TOKENS], VITS_HEADS, "vits ",
                  k5=False, dtype=torch.float32)
        row_times([(ENTRY_BATCH, 257, VITS_WIDTH)], VITS_HEADS, "vits bf16 ")
        k7_times({VITS_K7_CASE: VITS_K7_SHAPE}, "vits ", dtype=torch.float32)
        tiny = "vit_tiny adapter "
        for dt, tag in ((torch.float32, tiny), (torch.bfloat16, f"{tiny}bf16 ")):
            flash_times([(ENTRY_BATCH, TINY_HEADS, 257, 64)], tag, seed=5, dtype=dt)
            row_times([(ENTRY_BATCH, 257, TINY_WIDTH)], TINY_HEADS, tag,
                      k5=dt == torch.bfloat16, dtype=dt)
        msda_times([c for c in TINY_MSDA_CASES if c[1][0] == ENTRY_BATCH], tiny,
                   hot_too=False, points_timed=("uniform",), split=False)

    if only:
        with torch.no_grad():
            {"eval": eval_times, "entries": entry_times}[only]()
        return times, bounds, extra, dev, host

    with torch.no_grad():
        flash_times(FLASH_SHAPES, k7_body=True, host_too=True)
        # K3 at tap_unet_fuse's extra walks (1.5× and 0.5× frames), batch 16
        flash_times([(TRAIN_BATCH, 16, N, 64) for N in FUSE_N], "unet_fuse ", seed=1)
        msda_times(MSDA_CASES)
        row_times(ROW_SHAPES, HEADS)
        # K7 at the SSL step's shapes and at tap_setr_ete's (batch 16, one
        # segment)
        k7_times({**K7_SHAPES, f"{ETE_CASE} B={TRAIN_BATCH}": (TRAIN_BATCH,) + ETE_SHAPE[1:]})
        # ViT-g/14 and vit_tiny (M2b)
        flash_times(at_16(G_FLASH_SHAPES), "vitg ")
        msda_times([c for c in G_MSDA_CASES if c[1][0] == TRAIN_BATCH
                    and c[6] == torch.bfloat16], "vitg ", hot_too=False)
        row_times(at_16(G_ROW_SHAPES), G_HEADS, "vitg ", k5=False)
        row_times(at_16(TINY_ROW_SHAPES), TINY_HEADS, "vit_tiny ")
        k7_times(G_K7_SHAPES, "vitg ")
        # M12 at bench_m2f's batch 4: K3 at 1370 tokens against SDPA, K6, K4
        # (and in bf16 K5) at 1370 rows, bf16 and fp32; K1 and K2 at the
        # pixel decoder's geometry (uniform and model-like points), the
        # injector's and extractor's (uniform), bf16 and fp32, and at
        # vit_small's D = 48 in bf16
        for dt, tag in ((torch.bfloat16, "m2f "), (torch.float32, "m2f fp32 ")):
            flash_times([(M2F_BATCH, 16, M2F_TOKENS, 64)], tag, seed=2, dtype=dt)
            row_times([(M2F_BATCH, M2F_TOKENS, 1024)], HEADS, tag, k5=dt == torch.bfloat16,
                      dtype=dt)
        # the fp32 step of train_seg (phase 8s) at batch 16: K3 at (16, 16,
        # 1765 / 1764, 64) against SDPA in fp32, K6 and K4 at 28240 rows
        # against the unfused sequence and cuBLAS's fp32 GEMM (TF32 off)
        flash_times(at_16(FLASH_SHAPES), "fp32 ", dtype=torch.float32)
        row_times(at_16(ROW_SHAPES), HEADS, "fp32 ", k5=False, dtype=torch.float32)
        eval_times()
        entry_times()
        geo = M2F_MSDA_GEOMETRIES
        msda_times(m2f_msda_cases(M2F_BATCH, geo[:1]), "m2f ", hot_too=False)
        msda_times(m2f_msda_cases(M2F_BATCH, geo[1:3]), "m2f ", hot_too=False,
                   points_timed=("uniform",))
        msda_times(m2f_msda_cases(M2F_BATCH, geo[3:], (torch.bfloat16,)), "m2f ",
                   hot_too=False, points_timed=("uniform",))
    return times, bounds, extra, dev, host


def say_times(name, smi, times, bounds, extra, dev, host):
    say("kernel_times", device=name, nvidia_smi=smi[0] if smi else "unavailable",
        ms={k: {"kernel": a, "plain": b, "library": c, "kernel_device": dev[k][0],
                "library_device": dev[k][1], "bound": bounds[k][0], "bound_by": bounds[k][1],
                **({"kernel_host_us": host[k][0], "library_host_us": host[k][1]}
                   if k in host else {}),
                **extra.get(k, {})}
            for k, (a, b, c) in times.items()})


def row_hashes(ln) -> dict:
    """sha256 prefixes of K6's output on seeded rows (bf16 and fp32, C = 1024
    and 384): equal hashes from two builds show bit-equal outputs."""
    import hashlib
    out = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for C in (1024, 384):
                x, p = row_inputs((2, 1765, C), dtype, seed=60 + C, params_dtype=dtype)
                y = ln.layernorm(x, p["ln_w"], p["ln_b"])
                torch.cuda.synchronize()
                out[f"{str(dtype)[6:]} C={C}"] = hashlib.sha256(
                    y.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def k3_hashes(ff) -> dict:
    """sha256 prefixes of K3's output at the walks' bf16 shapes and at one
    fp32 shape, on seeded inputs: equal hashes from two builds show
    bit-equal outputs."""
    import hashlib
    out = {}
    with torch.no_grad():
        for shape, dtype in [(s, torch.bfloat16) for s in FLASH_SHAPES] + [
                ((2, 4, 257, 64), torch.float32)]:
            q, k, v = (x.to(dtype) for x in flash_inputs(shape, seed=70))
            o = ff.flash_fwd(q, k, v, 0.125)
            torch.cuda.synchronize()
            out[f"{str(dtype)[6:]} {tuple(shape)}"] = hashlib.sha256(
                o.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
            del q, k, v, o
    return out


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


# the straddle case's segments: each boundary after the first falls one
# token past a tile edge of both the forward's 128-key tiles and the
# backward's 64-row tiles (tokens 128, 256 and 384 end their segments)
STRADDLE_SEGMENTS = [129, 63, 65, 63, 65, 72]


def straddle_tokens(ids: torch.Tensor) -> torch.Tensor:
    """Tokens that end their segment one past a 64-token tile edge."""
    row = ids[0].cpu()
    t = torch.arange(64, row.numel() - 1, 64)
    return t[(row[t] == row[t - 1]) & (row[t + 1] != row[t])]


def straddle_inputs(shape, dtype, seed, seg):
    """k7_inputs, with the key of each straddling token set to 3·Σ q/√n over
    its segment's n queries: it carries about half of its segment's
    probability mass (36–53 % on average over the segment's queries), so a
    tile wrongly skipped (or a straddling pair masked) moves o, lse and the
    gradients far outside their bounds. Not more: as p of one key nears 1,
    its ds = p·(dp − di) cancels, two correct fp32 computations round it to
    bf16 differently, and the key's large k carries that flip into the
    whole row of dq. The plain formulas in fp32 and in float64 (rounded at
    the same points) differ in 7.6 % of dq's elements at 4·Σ q/√n, in 2.9 %
    at 3·Σ q/√n, against `K7_DIFFER_SHARE`."""
    q, k, v, do = k7_inputs(shape, torch.float32, seed)
    for t in straddle_tokens(seg).tolist():
        own = seg[0] == seg[0, t]
        k[:, :, t] = 3 * q[:, :, own].sum(-2) / math.sqrt(int(own.sum()))
    return [x.to(dtype) for x in (q, k, v, do)]


def walked_tiles(fa, seg, shape, counted=None) -> dict:
    """The tile pairs the kernels walk by `live_tiles`'s rule: per row of the
    batch (its first) and as a share of all, for the forward's 64 queries ×
    128 keys and the backward's 64 × 64. `counted`: what the bf16 kernels
    report they walked (`walked=`), the forward's count and the dK/dV and
    dQ kernels' two, each beside the rule's total over rows and heads."""
    B, H, N, _ = shape
    ids = seg if seg is not None else torch.zeros((B, N), dtype=torch.int32, device="cuda")
    out = {}
    for name, (r, c) in (("fwd_64x128", (64, 128)), ("bwd_64x64", (64, 64))):
        live = fa.live_tiles(ids, r, c)
        out[name] = {"per_row": f"{int(live[0].sum())}/{live[0].numel()}",
                     "share": live.float().mean().item()}
        if counted is not None:
            out[name].update(kernel_walked=counted[name], rule_total=H * int(live.sum()))
    return out


def kernel_walks(fa, q, k, v, do, o, lse, seg, scale: float) -> dict:
    """The tile pairs the bf16 kernels count as walked: one forward and one
    backward call (on the plain forward's o and lse)."""
    fwd, bwd = (torch.zeros(n, dtype=torch.int32, device="cuda") for n in (1, 2))
    fa.flash_attn_fwd_kernel(q, k, v, scale, seg, walked=fwd)
    fa.flash_attn_bwd_kernel(q, k, v, o, lse, do, scale, seg, walked=bwd)
    return {"fwd_64x128": fwd.tolist(), "bwd_64x64": bwd.tolist()}


def k7_outputs(fa, q, k, v, do, seg, plain: bool, scale: float):
    """(o, lse, dq, dk, dv): through flash_attn's autograd (the kernels) or
    through autograd of flash_attn_plain."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = (fa.flash_attn_plain if plain else fa.flash_attn)(*leaves, scale, seg)
    kept = o.detach().clone()
    o.backward(do)
    if not torch.equal(o.detach(), kept):
        fail(f"flash_attn: the backward wrote into the forward's output (plain={plain})")
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


def check_k7(fa, cases=None) -> dict:
    """Phase 4c: K7 against its plain version on the same inputs, per
    element (`k7_allowances`): the forward, the backward through the
    kernels' own forward (autograd of flash_attn against autograd of
    flash_attn_plain), and the backward kernels alone on the plain forward's
    o and lse, whose bf16 outputs must also differ in at most
    `K7_DIFFER_SHARE` of their elements. At the student's bf16 shape
    deliberately wrong kernel inputs must fail: no segment ids (a dropped
    mask), o = 0 (so di = 0), and the fp32 kernels on the same values (p
    and ds not rounded to bf16); in the interleaved case, whose scale 0.1
    is no power of two, q scaled and rounded before the product; in the
    straddle case (`STRADDLE_SEGMENTS`, `straddle_inputs`) the straddling
    tokens given the next segment's id in the kernel's ids only. Also in
    bf16 at the student's shape, five more forward and backward calls must
    give the same bits. Each case prints the share of tile pairs that
    `live_tiles` keeps (`walked_tiles`); in bf16 the kernels' own counts of
    the pairs they walked (`kernel_walks`) must equal the rule's. No
    backward call may change its o. Returns the largest errors at the SSL
    step's shapes, forward and backward, bf16 ("fwd", "bwd") and fp32
    ("fwd fp32", "bwd fp32"). Phase 4d passes `cases` = [(ETE_CASE,
    ETE_SHAPE, None, 0.125)]: tap_setr_ete's one segment of 1765 tokens,
    whose faults are di = 0 and the unrounded fp32 kernels, with five
    repeats; it returns that case's errors (and 4i the same at
    `VITS_K7_CASE`)."""
    k7_err = {"fwd": 0.0, "bwd": 0.0}
    if cases is None:
        cases = [(name, shape,
                  packed_ids(shape[0], STUDENT_SEGMENTS) if name == "student" else None, 0.125)
                 for name, shape in K7_SHAPES.items()]
        inter = torch.randint(0, 5, (8, 457), generator=torch.Generator().manual_seed(3),
                              dtype=torch.int32).cuda()
        cases.append(("interleaved ids", (8, 6, 457, 64), inter, 0.1))
        cases.append(("straddle", (8, 6, 457, 64), packed_ids(8, STRADDLE_SEGMENTS), 0.125))
    bwd = K7_NAMES[2:]

    def caught(report, names, key):
        """The planted fault must exceed a bound on every one of `names`."""
        return all(report[n][key] > (1.0 if key == "worst_share_of_bound" else K7_DIFFER_SHARE)
                   for n in names)

    for dtype in (torch.bfloat16, torch.float32):
        for i, (case, shape, seg, scale) in enumerate(cases):
            q, k, v, do = (straddle_inputs(shape, dtype, 40 + i, seg) if case == "straddle"
                           else k7_inputs(shape, dtype, seed=40 + i))
            got = k7_outputs(fa, q, k, v, do, seg, plain=False, scale=scale)
            torch.cuda.synchronize()
            ref = k7_outputs(fa, q, k, v, do, seg, plain=True, scale=scale)
            ref_o = ref[0].clone()
            alone = list(fa.flash_attn_bwd_kernel(q, k, v, ref[0], ref[1], do, scale, seg))
            allow = k7_allowances(fa, q, k, v, do, seg, ref, scale)
            counted = (kernel_walks(fa, q, k, v, do, ref[0], ref[1], seg, scale)
                       if dtype == torch.bfloat16 else None)
            report = {"walked_tiles": walked_tiles(fa, seg, shape, counted),
                      "fwd": k7_worst(K7_NAMES[:2], got[:2], ref[:2], allow["fwd"]),
                      "bwd_through_kernel_forward": k7_worst(bwd, got[2:], ref[2:],
                                                             allow["through"]),
                      "bwd_alone": k7_worst(bwd, alone, ref[2:], allow["alone"])}
            planted = {}
            if case in ("student", "vitg student", ETE_CASE, VITS_K7_CASE) \
                    and dtype == torch.bfloat16:
                if seg is not None:
                    wrong = k7_outputs(fa, q, k, v, do, None, plain=False, scale=scale)
                    r = {**k7_worst(K7_NAMES[:2], wrong[:2], ref[:2], allow["fwd"]),
                         **k7_worst(bwd, wrong[2:], ref[2:], allow["through"])}
                    planted["dropped_segment_mask"] = (r, caught(r, K7_NAMES,
                                                                 "worst_share_of_bound"))
                wrong = fa.flash_attn_bwd_kernel(q, k, v, torch.zeros_like(ref[0]), ref[1], do,
                                                 scale, seg)
                r = k7_worst(bwd, wrong, ref[2:], allow["alone"])
                planted["di_zero"] = (r, caught(r, ("dq", "dk"), "worst_share_of_bound"))
                wrong = [x.to(dtype) for x in fa.flash_attn_bwd_kernel(
                    q.float(), k.float(), v.float(), ref[0].float(), ref[1], do.float(),
                    scale, seg)]
                r = k7_worst(bwd, wrong, ref[2:], allow["alone"])
                planted["p_ds_not_rounded"] = (r, caught(r, bwd, "differing_share"))
                first = [*fa.flash_attn_fwd_kernel(q, k, v, scale, seg),
                         *fa.flash_attn_bwd_kernel(q, k, v, ref[0], ref[1], do, scale, seg)]
                report["repeats_bit_identical"] = all(
                    all(torch.equal(a, b) for a, b in zip(
                        (*fa.flash_attn_fwd_kernel(q, k, v, scale, seg),
                         *fa.flash_attn_bwd_kernel(q, k, v, ref[0], ref[1], do, scale, seg)),
                        first))
                    for _ in range(5))
                del first
            if case == "interleaved ids" and dtype == torch.bfloat16:
                wrong = fa.flash_attn_fwd_kernel((q.float() * scale).to(dtype), k, v, 1.0, seg)
                r = k7_worst(K7_NAMES[:2], wrong, ref[:2], allow["fwd"])
                planted["scale_before_qk"] = (r, caught(r, ("lse",), "worst_share_of_bound"))
            if case == "straddle" and dtype == torch.bfloat16:
                moved = seg.clone()
                t = straddle_tokens(seg).cuda()
                moved[:, t] = seg[:, t + 1]
                wrong = k7_outputs(fa, q, k, v, do, moved, plain=False, scale=scale)
                r = {**k7_worst(K7_NAMES[:2], wrong[:2], ref[:2], allow["fwd"]),
                     **k7_worst(bwd, wrong[2:], ref[2:], allow["through"])}
                planted["straddling_ids_moved"] = (r, caught(r, K7_NAMES, "worst_share_of_bound"))
            if planted:
                report["planted_faults"] = {n: {**r, "caught": c} for n, (r, c) in planted.items()}
            say("flash_attn_check", case=case, dtype=str(dtype), shape=list(shape), scale=scale,
                **report)
            for n, (_, c) in planted.items():
                if not c:
                    fail(f"flash_attn: the bound passes a planted fault ({n}, {case})")
            if not torch.equal(ref[0], ref_o):
                fail(f"flash_attn: a backward call wrote into its o ({case}, {dtype})")
            for name, walk in report["walked_tiles"].items():
                if "kernel_walked" in walk and any(n != walk["rule_total"]
                                                   for n in walk["kernel_walked"]):
                    fail(f"flash_attn: the kernels walked {walk['kernel_walked']} tile pairs "
                         f"({name}, {case}), live_tiles keeps {walk['rule_total']}")
            if report.get("repeats_bit_identical") is False:
                fail(f"flash_attn: repeated calls differ ({case})")
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
            if case not in ("interleaved ids", "straddle"):
                tag = "" if dtype == torch.bfloat16 else " fp32"
                k7_err["fwd" + tag] = max(k7_err.get("fwd" + tag, 0.0),
                                          report["fwd"]["o"]["max_abs_err"])
                k7_err["bwd" + tag] = max(k7_err.get("bwd" + tag, 0.0),
                                          *(report["bwd_through_kernel_forward"][n]["max_abs_err"]
                                            for n in bwd))
            del q, k, v, do, got, ref, ref_o, alone, allow
            torch.cuda.empty_cache()
    return k7_err


def k3_allowance(q, k, v, ref, scale: float):
    """Per-element bound on |K3 − plain| (phase 2), from the plain fp32 pass
    `ref` on the same (bf16 or fp32) values: ulp(|ref| + ε) + ε in q's
    dtype, as K7's forward (`k7_allowances`). Where the two fp32 values
    straddle a rounding point of the output's dtype they differ by one ulp
    of |ref| + ε; ε sums what the terms of o_i = Σ_j p_ij·v_j may differ
    by: in bf16 the kernel rounds each unnormalised p to bf16 before p·v
    and the plain version rounds none here (its bf16 run would round the
    normalised p), ≤ 2⁻⁸ of the term each, so (2⁻⁷ + 2⁻¹⁵)·Σ_j p_ij·|v_j|,
    2⁻¹⁵ for the exponent's error and the summation orders; in fp32
    2⁻¹⁵·Σ_j p_ij·|v_j|. Computed one batch element at a time (the fp32
    scores of batch 16 take 3.2 GB)."""
    f = (2.0 ** -7 if q.dtype == torch.bfloat16 else 0.0) + 2.0 ** -15
    out = torch.empty_like(ref)
    with torch.no_grad():
        for b in range(q.shape[0]):
            s = (q[b].float() * scale) @ k[b].float().transpose(-1, -2)
            eps = f * (torch.softmax(s, dim=-1) @ v[b].float().abs())
            out[b] = ulp(ref[b].abs() + eps, q.dtype) + eps
            del s, eps
    return out


def check_k3(ff, shapes=FLASH_SHAPES, by_dtype=False):
    """Phase 2: K3 against its plain version (fp32 on the same values) at
    the walks' shapes (H = 16, Dh = 64, N = 1765 and 1764, batch 2 and 16;
    phase 2b: `FUSE_K3_SHAPES`), bf16 and fp32, each element within
    `k3_allowance`. Both dtypes also: five more calls give the same bits (a
    race in the K/V ring would change them from run to run), and planted
    faults must break the bound: in bf16 the last key's v row zeroed (a
    dropped tail) and keys 128-255 given the v of keys 0-127 (a stale ring
    stage; under 256 keys, the second quarter given the first's); in fp32
    the plain version with one TF32 pass for each product (`ops/tf32.py`:
    what the tensor cores give without the split, against the kernel's
    three). Returns the largest bf16 error (with `by_dtype`, the largest
    per dtype: {"bfloat16": ..., "float32": ...})."""
    from adaptersis_tpu_torch.ops import tf32
    errs = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for i, shape in enumerate(shapes):
                q, k, v = (x.to(dtype) for x in flash_inputs(shape, seed=i))
                out = ff.flash_fwd(q, k, v, 0.125)
                torch.cuda.synchronize()
                if out.shape != q.shape or out.dtype != dtype or not out.is_contiguous():
                    fail(f"flash_fwd returned {tuple(out.shape)} {out.dtype} at {shape} {dtype}")
                ref = ff.flash_fwd_plain(q.float(), k.float(), v.float(), 0.125)
                allow = k3_allowance(q, k, v, ref, 0.125)
                d = (out.float() - ref).abs()
                report = {"max_abs_err": d.max().item(),
                          "worst_share_of_bound": (d / allow).max().item(),
                          "bound_max": allow.max().item(), "bound_min": allow.min().item()}
                del d
                report["repeats_bit_identical"] = all(
                    torch.equal(ff.flash_fwd(q, k, v, 0.125), out) for _ in range(5))
                if dtype == torch.bfloat16:
                    tail, stale = v.clone(), v.clone()
                    tail[:, :, -1] = 0
                    stage = 128 if shape[2] >= 256 else shape[2] // 4
                    stale[:, :, stage:2 * stage] = v[:, :, :stage]
                    wrong = {"dropped_tail": lambda: ff.flash_fwd(q, k, tail, 0.125),
                             "stale_stage": lambda: ff.flash_fwd(q, k, stale, 0.125)}
                else:  # one batch element at a time, as `k3_allowance`
                    wrong = {"one tf32 pass": lambda: torch.cat([
                        tf32.flash_fwd_tf32(q[b:b + 1], k[b:b + 1], v[b:b + 1], 0.125, 1)
                        for b in range(q.shape[0])])}
                report["planted_faults_worst_share"] = {
                    n: ((f().float() - ref).abs() / allow).max().item() for n, f in wrong.items()}
                del wrong
                say("flash_fwd_check", dtype=str(dtype), shape=list(shape), **report)
                if not report["worst_share_of_bound"] <= 1.0:
                    fail(f"flash_fwd kernel disagrees with plain at {shape} {dtype}: an error is "
                         f"{report['worst_share_of_bound']} of its per-element bound")
                if not report["repeats_bit_identical"]:
                    fail(f"flash_fwd: repeated calls differ at {shape} {dtype}")
                for n, w in report["planted_faults_worst_share"].items():
                    if not w > 1.0:
                        fail(f"flash_fwd: the bound passes a planted fault ({n}, {shape}): {w}")
                kind = str(dtype)[6:]
                errs[kind] = max(errs.get(kind, 0.0), report["max_abs_err"])
                del q, k, v, out, ref, allow
                torch.cuda.empty_cache()
    return errs if by_dtype else errs["bfloat16"]


def check_k5(fm, ln, x, p, report, row_err, shape, planted: bool) -> None:
    """Phase 4b's K5 case: every element within `mlp_allowance`; with
    `planted` also the planted faults and five repeats; in fp32 always the
    plain version with one TF32 pass for each product (`ops/tf32.py`).
    Records into `report` and `row_err`."""
    from adaptersis_tpu_torch.ops import tf32
    dtype, C = x.dtype, x.shape[-1]
    bf = dtype == torch.bfloat16
    mlp_args = (p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"])
    out = fm.fused_ln_mlp(x, *mlp_args)
    ref = fm.fused_ln_mlp_plain(x, *mlp_args)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != dtype or not out.is_contiguous():
        fail(f"fused_ln_mlp returned {tuple(out.shape)} {out.dtype}")
    diff = (out.float() - ref.float()).abs()
    allow = mlp_allowance(x, ref, p, ln, fm)
    worst = (diff / allow).max().item()
    report["fused_ln_mlp"] = {"max_abs_err": diff.max().item(),
                              "worst_share_of_bound": worst,
                              "bound_max": allow.max().item(),
                              "bound_min": allow.min().item()}
    if not worst <= 1.0:
        fail(f"fused_ln_mlp kernel disagrees with plain at {shape} {dtype}: "
             f"an error is {worst} of its per-element bound")
    wrong = {} if bf else {"one tf32 pass": tf32.fused_ln_mlp_tf32(x, *mlp_args, passes=1)}
    if planted:
        # the bound fails a wrong K5: the kernel given b2 = 0 or an fc2
        # weight with a 64-wide slice of K zeroed (as if its K loop skipped
        # a step); in fp32 also the plain version with the exact GELU in
        # place of tanh's
        w2_cut = p["w2"].clone()
        w2_cut[:, C:C + 64] = 0
        wrong["b2 dropped"] = fm.fused_ln_mlp(x, *mlp_args[:5], torch.zeros_like(p["b2"]),
                                              p["gamma"])
        wrong["fc2 K slice lost"] = fm.fused_ln_mlp(x, *mlp_args[:4], w2_cut, p["b2"],
                                                    p["gamma"])
        del w2_cut
        if not bf:
            tanh_gelu = fm.gelu_tanh
            fm.gelu_tanh = torch.nn.functional.gelu
            try:
                wrong["exact GELU"] = fm.fused_ln_mlp_plain(x, *mlp_args)
            finally:
                fm.gelu_tanh = tanh_gelu
        report["fused_ln_mlp"]["repeats_equal"] = same_bits(
            "fused_ln_mlp", [out], lambda: [fm.fused_ln_mlp(x, *mlp_args)])
    if wrong:
        caught = {k: ((o.float() - ref.float()).abs() / allow).max().item()
                  for k, o in wrong.items()}
        report["fused_ln_mlp"]["wrong_kernels_worst_share"] = caught
        if not all(v > 1.0 for v in caught.values()):
            fail(f"fused_ln_mlp: the bound passes a wrong kernel at {dtype}: {caught}")
    del wrong
    key = "fused_ln_mlp" if bf else "fused_ln_mlp fp32"
    row_err[key] = max(row_err.get(key, 0.0), diff.max().item())


def check_row_kernels(ln, fq, fm, shapes=ROW_SHAPES + [STRADDLE_ROWS], heads=HEADS,
                      k5=True) -> dict:
    """Phase 4b (see main): K6, K4 and (with `k5`) K5 against their plain
    versions, per shape in bf16 and fp32, K4 with `heads` heads (in fp32
    also per element, `qkv_allowance`); the first shape also plants faults
    and repeats each call five times; every fp32 shape plants one TF32 pass
    in K4 and K5. Returns the largest errors, bf16 under each kernel's
    name, fp32 under "<name> fp32"."""
    from adaptersis_tpu_torch.ops import tf32
    row_err = {"layernorm": 0.0, "fused_ln_qkv": 0.0, "fused_ln_mlp": 0.0}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            bf = dtype == torch.bfloat16
            for i, shape in enumerate(shapes):
                C = shape[2]
                pdt = torch.bfloat16 if bf and shape[1] == 1765 else torch.float32
                x, p = row_inputs(shape, dtype, seed=30 + i, params_dtype=pdt)
                xn = ln.ln_rows(x, p["ln_w"], p["ln_b"], 1e-6).to(dtype).float()
                report = {}
                out = ln.layernorm(x, p["ln_w"], p["ln_b"])
                ref = ln.layernorm_plain(x, p["ln_w"], p["ln_b"])
                row_check(report, row_err, "layernorm", [(out, ref)], 0.0, shape, dtype)
                qkv_args = (x, p["ln_w"], p["ln_b"], p["w"], p["b"], heads)
                out = fq.fused_ln_qkv(*qkv_args)
                ref = fq.fused_ln_qkv_plain(*qkv_args)
                bound = row_check(report, row_err, "fused_ln_qkv", list(zip(out, ref)),
                                  2.0 ** -5 * xn.abs().max().item()
                                  * p["w"].float().abs().max().item(), shape, dtype)
                allow = None if bf else qkv_allowance(xn, p["w"], heads, ref)

                def shares(outs) -> dict:
                    """The largest error of `outs` against plain over the
                    bound: global (`row_check`) and, in fp32, per element."""
                    got = {"global": max((o.float() - r.float()).abs().max().item()
                                         for o, r in zip(outs, ref)) / bound}
                    if allow is not None:
                        got["per_element"] = max(((o - r).abs() / a).max().item()
                                                 for o, r, a in zip(outs, ref, allow))
                    return got

                if not bf:
                    report["fused_ln_qkv"]["worst_share_per_element"] = shares(out)["per_element"]
                    if not report["fused_ln_qkv"]["worst_share_per_element"] <= 1.0:
                        fail(f"fused_ln_qkv kernel disagrees with plain at {shape} {dtype}: "
                             f"{report['fused_ln_qkv']}")
                # the bounds fail a wrong K4: in fp32 the plain version with
                # one TF32 pass (`ops/tf32.py`); at the first shape also q, k
                # and v each moved by one head, and one 64-wide k-step of x
                # left unnormalised
                wrong = {} if bf else {"one tf32 pass": tf32.fused_ln_qkv_tf32(
                    *qkv_args[:5], heads, passes=1)}
                if i == 0:
                    xs = xn.clone()
                    xs[..., C // 2:C // 2 + 64] = x[..., C // 2:C // 2 + 64].float()
                    wrong["heads moved"] = [o.roll(1, dims=1) for o in out]
                    wrong["k-step not normalised"] = qkv_from_xn(xs, p["w"], p["b"], heads,
                                                                 dtype)
                    report["fused_ln_qkv"]["repeats_equal"] = same_bits(
                        "fused_ln_qkv", out, lambda: fq.fused_ln_qkv(*qkv_args))
                    del xs
                if wrong:
                    caught = {k: shares(o) for k, o in wrong.items()}
                    report["fused_ln_qkv"]["wrong_kernels_share"] = caught
                    if not all(max(v.values()) > 1.0 for v in caught.values()):
                        fail(f"fused_ln_qkv: the bounds pass a wrong kernel at {dtype}: {caught}")
                del wrong, allow
                if k5:
                    check_k5(fm, ln, x, p, report, row_err, shape, planted=i == 0)
                say("row_kernels_check", dtype=str(dtype), params=str(pdt), shape=list(shape),
                    heads=heads, **report)
                del x, p, xn, out, ref
        torch.cuda.empty_cache()

    return row_err


def own_segment_pairs(B: int, H: int, segments) -> int:
    """Query-key pairs of own segments: the attention work these ids need."""
    return B * H * sum(n * n for n in segments)


# the JAX step gate's bf16 bound (VERIFY_STEP_ONCHIP.md): each trainable
# subtree's normalised L2 distance and max relative error; the losses as its
# bf16 loss bound
SSL_GATE_BOUND, SSL_GATE_LOSS_BOUND = 1e-1, 1e-2


def ssl_gate_subtree(name: str) -> str:
    if name.startswith("backbone.blocks."):
        return "backbone blocks"
    if name.startswith("backbone.patch_embed."):
        return "patch embed"
    if name.startswith("backbone."):
        return "backbone tokens and final norm"
    return "DINO head (also the iBOT head)"


def ssl_step_gate(fa, counts, reset_counts) -> dict:
    """Phase 8d: the SSL step at full width (ViT-S/14, batch 32, bf16,
    65536 prototypes, 8 local crops) built twice from the same seeded
    weights, every LayerScale drawn from N(0, 0.1²) so that every residual
    path carries its share, on the same augmented crops and masks (as
    `bench_ssl` makes them). One side runs K7; the other `flash_attn_plain`,
    patched into `adaptersis_tpu_torch.models.layers` for its step only.
    Compared: the loss and its parts (relative, `SSL_GATE_LOSS_BOUND`), and
    per trainable subtree the student's gradients (normalised L2 distance
    and max|a − b| / max|b|, `SSL_GATE_BOUND`). A subtree whose gradient is
    zero on the plain side fails, and so do K7 launches other than 24
    forwards and 12 backwards on the kernel side and none on the plain."""
    from adaptersis_tpu_torch.data.augment import draws_to
    from adaptersis_tpu_torch.models import layers
    from adaptersis_tpu_torch.models.vit import build_backbone
    from adaptersis_tpu_torch.ssl.augment import apply_multicrop, draw_multicrop
    from adaptersis_tpu_torch.ssl.masking import MaskingGenerator, collate_masks_with_indices
    from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to

    G, L, B, n_local, patch, dev = 224, 98, SSL_BATCH, 8, 14, torch.device("cuda")
    attn_impl, ln_impl, qkv_impl, mlp_impl = layers.TRAINED
    torch.manual_seed(0)
    backbone = build_backbone("vit_small", img_size=G, patch_size=patch, attn_impl=attn_impl,
                              ln_impl=ln_impl, qkv_impl=qkv_impl, mlp_impl=mlp_impl)
    rng = np.random.default_rng(21)
    with torch.no_grad():
        for n, p in backbone.named_parameters():
            if n.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, np.float32)))
    cfg = SSLConfig(dino_out_dim=65536, ibot_out_dim=65536, n_local_crops=n_local)
    kernel_side = SSLMetaArch(backbone, cfg, bf16=True).to(dev)
    sides = {"kernel": kernel_side, "plain": copy.deepcopy(kernel_side)}
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (B, G + 32, G + 32, 3),
                                                              np.uint8)).to(dev)
    draws = draws_to(draw_multicrop(torch.Generator().manual_seed(1), B, n_local), dev)
    g, l = apply_multicrop(imgs, draws, G, L)
    grid = G // patch
    masks = masks_to(collate_masks_with_indices(
        g.shape[0], grid * grid,
        MaskingGenerator((grid, grid), num_masking_patches=grid * grid // 2), seed=7), dev)
    step = dict(lr=1e-3, wd=0.04, momentum=0.992, teacher_temp=0.07, last_layer_lr=1e-3)
    losses, launches, kernel_attn = {}, {}, layers.flash_attn
    for side, meta in sides.items():
        reset_counts()
        if side == "plain":
            layers.flash_attn = fa.flash_attn_plain
        try:
            losses[side] = {k: float(v) for k, v in meta.train_step(g, l, masks, **step).items()}
        finally:
            layers.flash_attn = kernel_attn
        launches[side] = {k: counts()[k] for k in ("flash_attn", "flash_attn_bwd")}
    grads = {}
    for side, meta in sides.items():
        grads[side] = {}
        for n, p in meta.student.named_parameters():
            grads[side].setdefault(ssl_gate_subtree(n), []).append(p.grad.double().flatten())
    report, dead = {}, []
    for sub, parts in grads["plain"].items():
        a, b = torch.cat(grads["kernel"][sub]), torch.cat(parts)
        nb = b.norm().item()
        if not nb > 0:
            dead.append(sub)
        report[sub] = {"l2_dist": ((a - b).norm() / max(nb, 1e-30)).item(),
                       "max_rel": ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item(),
                       "norm_plain": nb}
    loss_err = {k: abs(losses["kernel"][k] - v) / max(abs(v), 1e-30)
                for k, v in losses["plain"].items()}
    out = {"losses": losses, "loss_rel_err": loss_err, "subtrees": report,
           "launches": launches, "bound": SSL_GATE_BOUND, "loss_bound": SSL_GATE_LOSS_BOUND}
    say("ssl_step_gate", arch="vit_small", batch=B, dtype="bf16", prototypes=65536, **out)
    if dead:
        fail(f"SSL step gate: zero gradient on the plain side in {dead}")
    if launches != {"kernel": SSL_PER_STEP, "plain": {"flash_attn": 0, "flash_attn_bwd": 0}}:
        fail(f"SSL step gate: K7 launches {launches}")
    if not all(math.isfinite(v) and v <= SSL_GATE_LOSS_BOUND for v in loss_err.values()):
        fail(f"SSL step gate: losses differ {loss_err}")
    for sub, r in report.items():
        if not (r["l2_dist"] <= SSL_GATE_BOUND and r["max_rel"] <= SSL_GATE_BOUND):
            fail(f"SSL step gate: {sub} gradients differ: {r}")
    del sides, kernel_side, grads
    torch.cuda.empty_cache()
    return out


SEG_GATE_BATCH = 8
SEG_SUBTREES = ("cross_vit", "cross_cnn", "encoder", "decoder", "level_embed")
# `--gate`'s probes of what sets phase 8e's floor: steps that differ from
# the full one in a single respect (`seg_gate_step`)
SEG_GATE_PROBES = ("location gradient stopped", "encoder fp32")


def seg_gate_inputs(seed=0, arch="vit_large", batch=SEG_GATE_BATCH, gelu_approx=True):
    """`bench`'s model (ViT-L/14 at 588 px, tanh GELU, 4 taps; or `arch`'s;
    with `gelu_approx` False `train_seg`'s default, exact GELU) from `seed`
    with every LayerScale γ of the frozen backbone drawn from N(0, 0.1²), so
    that each block moves its tokens; one augmented batch (with CLAHE) of
    `batch` seeded uint8 frames and masks."""
    from adaptersis_tpu_torch.data.augment import (
        apply_train_augment, draw_train_augment, draws_to)
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import build_backbone
    from adaptersis_tpu_torch.train.convert import seeded_init_

    dev, B, size = torch.device("cuda"), batch, 588
    backbone = build_backbone(arch, img_size=518, patch_size=14, gelu_approx=gelu_approx)
    model = seeded_init_(AdapterSegmentor(backbone, num_classes=2, n_last_blocks=4), seed=seed)
    rng = np.random.default_rng(22 + seed)
    with torch.no_grad():
        for n, p in backbone.named_parameters():
            if n.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, np.float32)))
    imgs = torch.from_numpy(rng.integers(0, 256, (B, size, size, 3), np.uint8)).to(dev)
    masks = torch.from_numpy((rng.uniform(size=(B, size, size)) > 0.8)
                             .astype(np.int32)).to(dev)
    draws = draws_to(draw_train_augment(torch.Generator().manual_seed(3 + seed), B, size), dev)
    return model.to(dev), *apply_train_augment(imgs, masks, draws)


def seg_gate_plain_versions() -> dict:
    """Per kernel, the (module, name, plain version) patches that take it
    off the segmentation step."""
    from adaptersis_tpu_torch.models import layers, vit
    from adaptersis_tpu_torch.ops import (
        flash_fwd as ff, fused_mlp as fm, fused_qkv as fq, layernorm as ln, ms_deform_attn,
        msda_cuda as mc)
    from adaptersis_tpu_torch.ops._build import plain
    return {"K1+K2": [(ms_deform_attn, "msda_fwd", plain(mc.msda_plain))],
            "K3": [(layers, "flash_fwd", ff.flash_fwd_plain)],
            "K4": [(layers, "fused_ln_qkv", fq.fused_ln_qkv_plain)],
            "K5": [(layers, "fused_ln_mlp", fm.fused_ln_mlp_plain)],
            "K6": [(layers, "layernorm", ln.layernorm_plain),
                   (vit, "layernorm", ln.layernorm_plain)]}


def plain_patches(kernels) -> list:
    """The patches that put the named kernels' plain versions in place."""
    versions = seg_gate_plain_versions()
    return [p for k in kernels for p in versions[k]]


def seg_gate_step(model, x01, y, patches, regime, counts, reset_counts,
                  subtrees=SEG_SUBTREES, bf16=True, paths=None, **trainer_kw):
    """One `Trainer` step (bf16, or fp32 with `bf16` False; `trainer_kw`:
    its loss and softmax) of a copy of `model` with `patches`
    ((module, name, function) triples) in place for the step only. The
    regime: "full", the step as it trains; "encoder fp32", the same step
    with the CNN encoder (`model.encoder`, which runs none of K1-K6) run in
    fp32 outside autocast; "location gradient stopped", every MSDA call's
    sampling locations detached before the sampling core (no location
    gradient; values and attention weights keep theirs). Returns the loss,
    each subtree's flat fp64 gradient and the launches; `paths`, if given,
    takes the step's launches by kernel (`path_counts`)."""
    from adaptersis_tpu_torch.ops import ms_deform_attn
    from adaptersis_tpu_torch.train.trainer import Trainer
    trainer = Trainer(copy.deepcopy(model), bf16=bf16, **trainer_kw)
    if regime == "encoder fp32":
        encoder = trainer.model.encoder
        bf16_forward = encoder.forward

        def fp32_forward(x, *a, **kw):
            with torch.autocast(x.device.type, enabled=False):
                return bf16_forward(x.float(), *a, **kw)

        encoder.forward = fp32_forward
    core = ms_deform_attn.msda_fwd
    kept = [getattr(mod, name) for mod, name, _ in patches]
    reset_counts()
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        if regime == "location gradient stopped":
            fwd = ms_deform_attn.msda_fwd
            ms_deform_attn.msda_fwd = lambda v, loc, aw, shapes: fwd(v, loc.detach(), aw, shapes)
        loss = float(trainer.step(x01, y, epoch=0))
        if paths is not None:
            paths.update(path_counts())
    finally:
        for (mod, name, _), fn in zip(patches, kept):
            setattr(mod, name, fn)
        ms_deform_attn.msda_fwd = core
    grads = {sub: torch.cat([p.grad.double().flatten() for n, p in
                             trainer.model.named_parameters() if n.split(".")[0] == sub])
             for sub in subtrees}
    return loss, grads, counts()


def grad_distance(a, b) -> dict:
    """Normalised L2 distance and max|a − b| / max|b| of a against b."""
    nb = b.norm().item()
    return {"l2_dist": ((a - b).norm() / max(nb, 1e-30)).item(),
            "max_rel": ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item(),
            "norm_plain": nb}


def ln_fp64(x, w, b, eps):
    """ln_rows's arithmetic in float64."""
    xf, inv_c = x.double(), 1.0 / x.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv_c
    var = (xf * xf).sum(-1, keepdim=True) * inv_c - mean * mean
    return (xf - mean) * (torch.rsqrt(var + eps) * w.double()) + b.double()


def qkv_fp64(x, ln_w, ln_b, w, b, num_heads, eps=1e-6):
    """fused_ln_qkv_plain with float64 sums: the same roundings to x's
    dtype, other sums (an equally valid K4)."""
    with torch.autocast(x.device.type, enabled=False):
        dt = x.dtype
        xn = ln_fp64(x, ln_w, ln_b, eps).to(dt).double()
        return qkv_from_xn(xn, w, b, num_heads, dt)


def mlp_fp64(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps=1e-6):
    """fused_ln_mlp_plain with float64 sums (an equally valid K5)."""
    from adaptersis_tpu_torch.ops.fused_mlp import gelu_tanh
    with torch.autocast(x.device.type, enabled=False):
        dt = x.dtype
        xn = ln_fp64(x, ln_w, ln_b, eps).to(dt).double()
        h = gelu_tanh(xn @ w1.to(dt).double().t() + b1.double()).to(dt).double()
        return (x.double() + gamma.double() * (h @ w2.to(dt).double().t() + b2.double())).to(dt)


def flash_fp64(q, k, v, scale):
    """flash_fwd_plain with float64 sums, rounded to q's dtype (an equally
    valid K3)."""
    from adaptersis_tpu_torch.ops.flash_fwd import flash_fwd_plain
    with torch.autocast(q.device.type, enabled=False):
        return flash_fwd_plain(q.double(), k.double(), v.double(), scale).to(q.dtype)


def msda_fp64(value, loc, aw, shapes):
    """msda_plain with float64 sums, rounded to its fp32 output (an equally
    valid K1/K2: the same corners and weights)."""
    from adaptersis_tpu_torch.ops.msda_cuda import msda_plain
    with torch.autocast(value.device.type, enabled=False):
        return msda_plain(value.double(), loc.double(), aw.double(), shapes).float()


def seg_gate_sides(fp32=False) -> dict:
    """Phase 8e's sides, as patches: the kernels; the plain versions of
    K1-K6; the floor (those plain versions, but K4's and K5's sums in
    float64, or in fp32 (phase 8r, no K5) K3's and K4's: an equally valid
    implementation); and two planted faults on the kernel side, q, k and v
    moved by one head (K4) and K5 without b2."""
    from adaptersis_tpu_torch.models import layers
    qkv, mlp = layers.fused_ln_qkv, layers.fused_ln_mlp
    every = tuple(seg_gate_plain_versions())
    in_fp64 = {"K3": (layers, "flash_fwd", flash_fp64), "K4": (layers, "fused_ln_qkv", qkv_fp64),
               "K5": (layers, "fused_ln_mlp", mlp_fp64)}
    floor = ("K3", "K4") if fp32 else ("K4", "K5")
    return {"kernel": [], "plain": plain_patches(every),
            "floor": plain_patches(k for k in every if k not in floor)
            + [in_fp64[k] for k in floor],
            "heads moved": [(layers, "fused_ln_qkv",
                             lambda *a: [t.roll(1, dims=1) for t in qkv(*a)])],
            "b2 dropped": [(layers, "fused_ln_mlp", lambda x, lw, lb, w1, b1, w2, b2, *a: mlp(
                x, lw, lb, w1, b1, w2, torch.zeros_like(b2), *a))]}


# phase 8r (M9's fp32 half): the JAX gate's fp32/bs2 bounds
# (VERIFY_STEP_ONCHIP.md:3-13): the loss, and each subtree's normalised L2
# distance and max relative error
FP32_GATE_BATCH = 2
FP32_GATE_BOUND = {"l2_dist": 8e-2, "max_rel": 1e-1}
FP32_GATE_LOSS_BOUND = 2e-3


def seg_step_gate(counts, reset_counts, expected, seed=0, probes=(), arch="vit_large",
                  batch=SEG_GATE_BATCH, faults=("heads moved", "b2 dropped"),
                  fp32=False) -> dict:
    """Phase 8e (M9, the ViT-L half): the deployed configuration's train
    step (`seg_gate_inputs`: `bench`'s model, bf16, batch 8) on the five
    `seg_gate_sides`, all from the same seeded weights on the same augmented
    batch; phase 8j runs it on ViT-g/14 at batch 2 with `faults` = the heads
    moved alone (its SwiGLU blocks run no K5). Compared against the plain side: the loss (relative,
    `SSL_GATE_LOSS_BOUND`) and per trainable subtree the gradients
    (`grad_distance`: the JAX gate's measures). Each subtree's distance
    must lie within the JAX gate's bf16/bs8 bound `SSL_GATE_BOUND` or,
    where the floor lies further from the plain side, within twice the
    floor's distance: two correct implementations already move the
    encoder's gradients by more than 1e-1 (0.12-0.13 in L2 on two seeds;
    what sets that floor is in PERF.md §6). Both planted faults must
    break a bound. A subtree whose gradient is zero on the plain side
    fails, and so do launches other than `expected` (one forward and its
    MSDA backwards) on the kernel and fault sides, or any on the plain and
    floor sides. Each of `probes` (`SEG_GATE_PROBES`) runs the kernel,
    plain and floor sides once more in that regime, reported, not held.
    With `fp32` (phase 8r, M9's fp32 half): `train_seg`'s default step,
    fp32 with exact GELU (no K5), held to the JAX gate's fp32/bs2 bounds
    (`FP32_GATE_BOUND`, `FP32_GATE_LOSS_BOUND`) or twice the floor, which
    sums K3 and K4 in float64; the kernel side's K3 and K4 launches must
    all run the 3×TF32 kernels."""
    t0 = time.perf_counter()
    model, x01, y = seg_gate_inputs(seed, arch, batch, gelu_approx=not fp32)
    sides = {k: v for k, v in seg_gate_sides(fp32).items()
             if k in ("kernel", "plain", "floor") or k in faults}
    measures = ("l2_dist", "max_rel")
    bound = FP32_GATE_BOUND if fp32 else dict.fromkeys(measures, SSL_GATE_BOUND)
    loss_bound = FP32_GATE_LOSS_BOUND if fp32 else SSL_GATE_LOSS_BOUND
    out, launches, kernel_paths = {}, {}, {}
    for regime in ("full", *probes):
        losses, grads = {}, {}
        for side, patches in sides.items():
            if regime == "full" or side in ("kernel", "plain", "floor"):
                losses[side], grads[side], launches[f"{regime}: {side}"] = seg_gate_step(
                    model, x01, y, patches, regime, counts, reset_counts, bf16=not fp32,
                    paths=kernel_paths if (regime, side) == ("full", "kernel") else None)
        report, shares = {}, {f: {} for f in faults if f in grads}
        for sub, g in grads["plain"].items():
            r = grad_distance(grads["kernel"][sub], g)
            floor = grad_distance(grads["floor"][sub], g)
            r["floor"] = {k: floor[k] for k in measures}
            r["bound"] = {k: max(bound[k], 2 * floor[k]) for k in measures}
            report[sub] = r
            for side, f in shares.items():
                d = grad_distance(grads[side][sub], g)
                f[sub] = max(d[k] / r["bound"][k] for k in measures)
        out[regime] = {"losses": losses, "loss_rel_err": {
            side: abs(v - losses["plain"]) / max(abs(losses["plain"]), 1e-30)
            for side, v in losses.items() if side != "plain"}, "subtrees": report,
            "faults_share_of_bound": shares}
    say("seg_step_gate", arch=arch, batch=batch, seed=seed, dtype="fp32" if fp32 else "bf16",
        seconds=time.perf_counter() - t0, bound=bound, loss_bound=loss_bound,
        launches=launches, kernel_side_by_kernel=kernel_paths, **out)
    none = {k: 0 for k in expected}
    for key, got in launches.items():
        want = none if key.endswith((": plain", ": floor")) else expected
        if got != want:
            fail(f"segmentation step gate: launches {got} on {key}, expected {want}")
    if kernel_paths != paths_expected("tf32x3" if fp32 else "wgmma", launches["full: kernel"]):
        fail(f"segmentation step gate: the kernel side's launches by kernel {kernel_paths}")
    r = out["full"]
    dead = [sub for sub, s in r["subtrees"].items() if not s["norm_plain"] > 0]
    if dead:
        fail(f"segmentation step gate: zero gradient on the plain side in {dead}")
    if not all(math.isfinite(r["loss_rel_err"][side])
               and r["loss_rel_err"][side] <= loss_bound for side in ("kernel", "floor")):
        fail(f"segmentation step gate: losses differ {r['losses']}")
    for fault, shares in r["faults_share_of_bound"].items():
        if not max(shares.values()) > 1:
            fail(f"segmentation step gate: the bounds pass {fault}: {shares}")
    for sub, s in r["subtrees"].items():
        if not all(s[k] <= s["bound"][k] for k in measures):
            fail(f"segmentation step gate: {sub} gradients differ: {s}")
    del model
    torch.cuda.empty_cache()
    return out


def seg_gate_ablation(counts, reset_counts) -> dict:
    """`--gate`'s last part: one kernel at a time (the other five on their
    plain versions), and the plain step with MSDA's sums in float64
    (`msda_fp64`, the only change), each against the plain step: how far
    one change alone moves each subtree's gradients."""
    from adaptersis_tpu_torch.ops import ms_deform_attn
    model, x01, y = seg_gate_inputs()
    every = tuple(seg_gate_plain_versions())
    _, plain, _ = seg_gate_step(model, x01, y, plain_patches(every), "full", counts,
                                reset_counts)
    runs = {f"only {k}": plain_patches(j for j in every if j != k) for k in every}
    runs["MSDA in float64"] = (plain_patches(k for k in every if k != "K1+K2")
                               + [(ms_deform_attn, "msda_fwd", msda_fp64)])
    out = {}
    for name, patches in runs.items():
        _, grads, _ = seg_gate_step(model, x01, y, patches, "full", counts, reset_counts)
        out[name] = {sub: grad_distance(grads[sub], g) for sub, g in plain.items()}
    say("seg_gate_ablation", **out)
    del model
    torch.cuda.empty_cache()
    return out


# phase 8f: a Robust-MIS 2019 tree (its frame size, so the reader resizes to
# 588) and a ViT-L/14 checkpoint in the layout of `dinov2_vitl14_pretrain.pth`
REAL_TRAIN, REAL_VAL, REAL_FRAME = 32, 8, (540, 960)
REAL_BATCH = 8
SEG_SUBTREES = ("cross_vit", "cross_cnn", "encoder", "decoder", "level_embed")


def instrument_frame(rng, yy, xx):
    """An RGB frame (a smooth field with noise and darker metallic instrument
    shapes: 1-3 rotated ellipses with Robust-MIS's proportions at 960 px)
    and each shape's boolean mask, drawn from `rng`."""
    h, w = yy.shape
    phase = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([120 + 60 * np.sin(xx / (90 + 30 * c) + yy / 140 + phase[c])
                    for c in range(3)], -1)
    shapes = []
    for _ in range(rng.integers(1, 4)):
        cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
        ang = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        shapes.append((u / rng.uniform(120, 300)) ** 2 + (v / rng.uniform(15, 40)) ** 2 < 1)
    mask = np.logical_or.reduce(shapes)
    img[mask] = img[mask] * 0.35 + np.asarray([170.0, 175.0, 180.0]) * 0.65
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), shapes


def write_robomis_tree(root: Path, seed: int = 0, n_train: int = REAL_TRAIN,
                       n_val: int = REAL_VAL) -> None:
    """images/{training,validation}/*.png (RGB 960 × 540, `instrument_frame`)
    and annotations/ (8-bit gray, the shapes at 255), through the port's own
    PNG writer; frame k drawn from `default_rng((seed, k))`, 8 at a time in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptersis_tpu_torch.data.png_writer import write_png
    yy, xx = np.mgrid[0:REAL_FRAME[0], 0:REAL_FRAME[1]].astype(np.float32)
    frames = []
    for split, n in (("training", n_train), ("validation", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "annotations" / split).mkdir(parents=True)
        frames += [(split, f"{i:04d}.png") for i in range(n)]

    def write(k: int) -> None:
        split, name = frames[k]
        img, shapes = instrument_frame(np.random.default_rng((seed, k)), yy, xx)
        write_png(root / "images" / split / name, img)
        write_png(root / "annotations" / split / name,
                  np.logical_or.reduce(shapes).astype(np.uint8) * 255)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(frames))))


def dinov2_vitl14_state_dict(seed: int = 0) -> dict:
    """A flat fp32 state dict with the names and shapes of Meta's
    `dinov2_vitl14_pretrain.pth` (pos_embed (1, 1370, 1024), cls_token,
    mask_token, 24 blocks), seeded: weights N(0, 1/fan_in), norm scales
    1 + N(0, 0.1²), LayerScale γ ~ N(0, 0.1²) so that every block is live,
    biases N(0, 0.1²), tokens and pos_embed N(0, 0.02²)."""
    from adaptersis_tpu_torch.models.vit import build_backbone
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in build_backbone("vit_large", img_size=518, patch_size=14).state_dict().items():
        z = torch.randn(p.shape, generator=gen)
        if name.endswith("gamma"):
            z *= 0.1
        elif name.endswith("weight") and p.dim() >= 2:
            z /= math.sqrt(p[0].numel())
        elif name.endswith("weight"):
            z = 1.0 + 0.1 * z
        elif name in ("cls_token", "pos_embed", "mask_token"):
            z *= 0.02
        else:
            z *= 0.1
        out[name] = z
    return out


def subtree_distances(a: dict, b: dict, subtrees) -> dict:
    """Per subtree (name prefix), the normalised L2 distance of a from b
    over all its tensors, and whether they are bit-identical."""
    out = {}
    for sub in subtrees:
        keys = [k for k in b if k.startswith(sub)]
        if not keys:
            raise RuntimeError(f"no tensor under {sub}")
        diff = sum(float((a[k].double() - b[k].double()).norm() ** 2) for k in keys)
        norm = sum(float(b[k].double().norm() ** 2) for k in keys)
        out[sub] = {"l2_dist": math.sqrt(diff / max(norm, 1e-300)),
                    "identical": all(torch.equal(a[k], b[k]) for k in keys)}
    return out


def resume_rule(phase: str, a: dict, a2: dict, r: dict, subtrees) -> dict:
    """A resumed run R against an uninterrupted one A and its repeat A′: if
    A and A′ are bit-identical, R must equal A bit for bit; if the card's
    runs differ (atomics in a backward), each subtree of R must lie within
    twice A–A′'s distance of A (a second draw of the same spread; 2× for a
    single sample of it)."""
    spread = subtree_distances(a2, a, subtrees)
    resumed = subtree_distances(r, a, subtrees)
    deterministic = all(v["identical"] for v in spread.values())
    if deterministic:
        rule = "A = A' bit for bit, so R must equal A bit for bit"
        bad = [s for s, v in resumed.items() if not v["identical"]]
    else:
        rule = "A != A': each subtree's d(R, A) <= 2 d(A, A')"
        bad = [s for s in subtrees if resumed[s]["l2_dist"] > 2 * spread[s]["l2_dist"]]
    res = {"rule": rule, "a_vs_a2": spread, "r_vs_a": resumed, "held": not bad}
    if bad:
        fail(f"{phase}: the resumed run breaks the rule ({rule}) on {bad}: {res}")
    return res


def parity_checks(work: Path, reference: dict, code, identical: bool) -> dict:
    """Phase 8f's hold on run A′, made through `quality_parity.main` with
    A's last `test_*` row as its reference (`code` its exit code): parity.json's
    metrics are A′'s own last `test_*` row of log.txt, the exit code is 1
    exactly when parity_ok is false, and where A and A′ are bit-identical
    (`identical`) every Δ is 0 and every verdict PASS. Then A's dice + 0.05
    as the reference, compared on A′'s output_dir with `train_seg.run`
    replaced by nothing (no second training run), must FAIL with exit code
    1."""
    from adaptersis_tpu_torch import quality_parity, train_seg
    out = work / "A2"
    parity = json.loads((out / "parity.json").read_text())
    table = (out / "parity.md").read_text()
    rows = [json.loads(x) for x in (out / "log.txt").read_text().splitlines() if x.strip()]
    own = {k[len("test_"):]: v for k, v in [r for r in rows if any(
        k.startswith("test_") for k in r)][-1].items() if k.startswith("test_")}
    verdicts = {line.split(" | ")[0].strip("| "): line.rstrip(" |").rsplit(" | ", 1)[1]
                for line in table.splitlines()[2:]}
    failures = []
    if parity["metrics"] != own:
        failures.append(f"parity.json's metrics {parity['metrics']}, log.txt's last row {own}")
    if parity["reference"] != reference or code != (0 if parity["parity_ok"] else 1):
        failures.append(f"reference {parity['reference']}, parity_ok {parity['parity_ok']}, "
                        f"exit code {code}")
    if identical and (parity["metrics"] != reference or not parity["parity_ok"]
                      or any(v != "PASS" for v in verdicts.values())):
        failures.append(f"A = A' bit for bit, but parity reads {parity}, {verdicts}")
    worse = {**reference, "dice": reference["dice"] + 0.05}
    (work / "reference_worse.json").write_text(json.dumps(worse))
    plain_run = train_seg.run
    train_seg.run = lambda args: (None, [])
    try:
        quality_parity.main(["--output_dir", str(out),
                             "--reference_json", str(work / "reference_worse.json")])
        worse_code = 0
    except SystemExit as e:
        worse_code = e.code
    finally:
        train_seg.run = plain_run
    worse_parity = json.loads((out / "parity.json").read_text())
    worse_table = (out / "parity.md").read_text()
    dice_row = next(x for x in worse_table.splitlines() if x.startswith("| dice |"))
    if worse_code != 1 or worse_parity["parity_ok"] or not dice_row.endswith("| FAIL |"):
        failures.append(f"A's dice + 0.05: exit code {worse_code}, {worse_parity}, {dice_row}")
    res = {"exit_code": code, "parity": parity, "verdicts": verdicts,
           "a_equals_a2": identical, "worse_reference": {"exit_code": worse_code,
                                                          "parity_ok": worse_parity["parity_ok"],
                                                          "dice_row": dice_row}}
    say("quality_parity", **res)
    if failures:
        fail("8f quality_parity: " + "; ".join(failures))
    return res


def real_data_run(counts, reset_counts, smi) -> dict:
    """Phase 8f: `train_seg` on a Robust-MIS tree from a DINOv2 `.pth` at full
    width (ViT-L/14 at 588 px, bf16, batch 8, 2 epochs): runs A and A′, R
    stopped after an epoch and resumed, `--evaluate` on A, `evaluate` at
    batch 2 (`real_data_run`'s docstring in the module header)."""
    from adaptersis_tpu_torch import evaluate, quality_parity, train_seg
    from adaptersis_tpu_torch.data import native
    from adaptersis_tpu_torch.train.checkpoint import restore_checkpoint
    from adaptersis_tpu_torch.train.trainer import Trainer

    def parity_run(argv_):
        """`quality_parity.main(argv_)`: its exit code and the history of
        the `train_seg` run it made."""
        plain_run, kept = train_seg.run, []

        def run_kept(args):
            kept.append(plain_run(args))
            return kept[-1]

        train_seg.run = run_kept
        try:
            quality_parity.main(argv_)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            train_seg.run = plain_run
        return code, kept[0][1]

    work = ROOT / "build" / "smoke_real"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_robomis_tree(work / "robomis")
    pth_sd = dinov2_vitl14_state_dict()
    torch.save(pth_sd, work / "dinov2_vitl14_pretrain.pth")
    setup_s = time.perf_counter() - t0
    decoder = native.decoder()
    if decoder == "none":
        fail(f"8f: nothing can decode the tree: {native.build_error}")

    def argv(out):
        return ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588", "--bf16",
                "--gelu_approx", "--batch_size_per_gpu", str(REAL_BATCH), "--epochs", "2",
                "--dataset", "robomis", "--data_path", str(work / "robomis"),
                "--pretrained_weights", str(work / "dinov2_vitl14_pretrain.pth"),
                "--num_workers", "8", "--output_dir", str(work / out)]

    # the backbone as train_seg builds it, before the Trainer's bf16 cast,
    # and the trainables' start
    seen = {}
    plain_build = train_seg.build_model

    def build_checked(args):
        model = plain_build(args)
        got = model.backbone.state_dict()
        seen["backbone_equals_pth"] = (set(got) == set(pth_sd) and
                                       all(torch.equal(got[k], v) for k, v in pth_sd.items()))
        seen.setdefault("start", {k: v.detach().clone() for k, v in model.state_dict().items()
                                  if not k.startswith("backbone.")})
        return model

    # launches per train step and per validation forward, from the counters
    per = {"train": [], "eval": []}
    plain_train, plain_eval = Trainer.train_step, Trainer.eval_step

    def counted(kind, fn):
        def wrap(self, *a, **kw):
            before = counts()
            out = fn(self, *a, **kw)
            after = counts()
            per[kind].append({k: after[k] - before[k] for k in after})
            return out
        return wrap

    train_seg.build_model = build_checked
    Trainer.train_step = counted("train", plain_train)
    Trainer.eval_step = counted("eval", plain_eval)
    try:
        reset_counts()
        trainer, hist_a = train_seg.run(train_seg.get_args_parser().parse_args(argv("A")))
        launches_a = counts()
    finally:
        train_seg.build_model = plain_build
        Trainer.train_step, Trainer.eval_step = plain_train, plain_eval
    steps = len(per["train"])
    if not seen.get("backbone_equals_pth"):
        fail("8f: the loaded backbone differs from the .pth tensors")
    cast_ok = True
    for k, p_ in trainer.model.backbone.state_dict().items():
        # bf16 but pos_embed, which the trainer keeps fp32
        cast_ok &= bool(torch.equal(p_.cpu(), pth_sd[k].to(p_.dtype)))
    now = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()
           if not k.startswith("backbone.")}
    unchanged = [k for k, v in seen["start"].items()
                 if k in dict(trainer.model.named_parameters()) and torch.equal(now[k], v)]
    del trainer, now
    torch.cuda.empty_cache()

    # A′ through the quality-parity harness, against A's last validation
    reference = quality_parity.final_metrics(str(work / "A"))
    (work / "reference_a.json").write_text(json.dumps(reference))
    parity_code, hist_a2 = parity_run(argv("A2") + ["--reference_json",
                                                    str(work / "reference_a.json")])
    torch.cuda.empty_cache()
    os.environ["ASN_STOP_AFTER_EPOCHS"] = "1"
    try:
        _, hist_r1 = train_seg.run(train_seg.get_args_parser().parse_args(argv("R")))
    finally:
        del os.environ["ASN_STOP_AFTER_EPOCHS"]
    torch.cuda.empty_cache()
    _, hist_r2 = train_seg.run(train_seg.get_args_parser().parse_args(argv("R")))
    torch.cuda.empty_cache()

    def state(out):
        st = restore_checkpoint(work / out)
        flat = dict(st["model"])
        for i, s_ in st["optimizer"]["state"].items():
            flat[f"momentum.{i}"] = s_["momentum_buffer"]
        return st, flat

    (st_a, a), (st_a2, a2), (st_r, r) = state("A"), state("A2"), state("R")
    rule = resume_rule("8f", a, a2, r, SEG_SUBTREES + ("momentum",))
    parity = parity_checks(work, reference, parity_code,
                           all(v["identical"] for v in rule["a_vs_a2"].values()))
    _, hist_ev = train_seg.run(train_seg.get_args_parser().parse_args(argv("A") + ["--evaluate"]))
    torch.cuda.empty_cache()
    reset_counts()
    ev = evaluate.main(["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
                        "--bf16", "--gelu_approx", "--batch_size_per_gpu", str(FULL_BATCH),
                        "--dataset", "robomis", "--data_path", str(work / "robomis"),
                        "--pretrained_weights", str(work / "dinov2_vitl14_pretrain.pth"),
                        "--num_workers", "8"])
    ev_launches = counts()
    torch.cuda.empty_cache()

    losses = [x for h in hist_a + hist_a2 + hist_r1 + hist_r2 for x in h["train_losses"]]
    timed = [h for h in hist_a + hist_a2 + hist_r1 + hist_r2]
    res = {"decoder": decoder, "setup_s": setup_s, "steps": steps,
           "per_train_step": per["train"][0] if per["train"] else None,
           "train_steps_alike": all(d == per["train"][0] for d in per["train"]),
           "per_validation_forward": per["eval"][0] if per["eval"] else None,
           "launches_run_a": launches_a,
           "img_per_s": [h["train_img_per_s"] for h in timed],
           "loader_wait_s_per_step": [h["loader_wait_s"] for h in timed],
           "peak_mem_bytes": max(h["peak_mem_bytes"] for h in timed),
           "train_losses_a": [h["train_losses"] for h in hist_a],
           "test_acc1_a": hist_a[-1].get("test_acc1"), "evaluate_acc1": hist_ev[0]["test_acc1"],
           "backbone_equals_pth": seen["backbone_equals_pth"],
           "backbone_equals_pth_cast_after_training": cast_ok,
           "unchanged_trainables": unchanged, "resume": rule, "quality_parity": parity,
           "evaluate_b2": {k: ev[k] for k in ("images", "batches", "loss", "dice", "acc1",
                                               "logits_finite", "img_per_s", "decoder")},
           "evaluate_b2_launches": ev_launches,
           "nvidia_smi": smi[0] if smi else "unavailable"}
    say("real_data_training", **res)
    if steps != 8 or len(per["eval"]) != 2:
        fail(f"8f: run A took {steps} train steps and {len(per['eval'])} validation forwards, "
             "expected 8 and 2")
    if not all(math.isfinite(x) for x in losses):
        fail(f"8f: non-finite train losses {losses}")
    if not cast_ok:
        fail("8f: the frozen backbone moved in training (against the .pth in bf16)")
    if unchanged:
        fail(f"8f: trainables left unchanged: {unchanged}")
    if not res["train_steps_alike"] or per["train"][0] != expect(1, 7):
        fail(f"8f: launches per train step {per['train']}, expected {expect(1, 7)}")
    if any(d != expect(1, 0) for d in per["eval"]):
        fail(f"8f: launches per validation forward {per['eval']}, expected {expect(1, 0)}")
    if launches_a != expect(steps + len(per["eval"]), 7 * steps):
        fail(f"8f: run A's launches {launches_a}")
    if ev_launches != expect(ev["batches"], 0) or not ev["logits_finite"]:
        fail(f"8f: evaluate at batch 2: {ev}, launches {ev_launches}")
    if ev["decoder"] != decoder or hist_a[0]["decoder"] != decoder:
        fail(f"8f: decoders {ev['decoder']}, {hist_a[0]['decoder']}, expected {decoder}")
    # the same checkpoint in another process: only cuDNN's algorithm choice
    # may differ, moving acc1 by a pixel or two of 8 · 588²
    if abs(res["evaluate_acc1"] - res["test_acc1_a"]) > 1e-3:
        fail(f"8f: --evaluate acc1 {res['evaluate_acc1']} against A's {res['test_acc1_a']}")
    del pth_sd
    shutil.rmtree(work, ignore_errors=True)
    return res


# phase 8z: `train_multi_class` (8 classes, the iou_multi loss) on an
# EndoVis 2017 tree at its frame size (1280 × 1024, resized to 588), two
# training sequences and one test sequence
EV17_TRAIN, EV17_TEST, EV17_FRAME = 24, 8, (1024, 1280)
EV17_BATCH = 8


def write_endovis2017_tree(root: Path, seed: int = 0) -> None:
    """train/instrument_dataset_{1,2}/ (`EV17_TRAIN` frames between them)
    and test/instrument_dataset_1/ (`EV17_TEST`), each with images/*.png
    (RGB, `instrument_frame`), binary_masks/ (the shapes at 255) and
    instruments_masks/ (each shape an instrument id in 1..7, stored as
    id·32), through the port's own PNG writer; frame k drawn from
    `default_rng((seed, k))`, 8 frames at a time in threads."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptersis_tpu_torch.data.png_writer import write_png
    yy, xx = np.mgrid[0:EV17_FRAME[0], 0:EV17_FRAME[1]].astype(np.float32)
    frames = []
    for sub, seq, n in (("train", 1, EV17_TRAIN // 2), ("train", 2, EV17_TRAIN - EV17_TRAIN // 2),
                        ("test", 1, EV17_TEST)):
        d = root / sub / f"instrument_dataset_{seq}"
        for kind in ("images", "binary_masks", "instruments_masks"):
            (d / kind).mkdir(parents=True)
        frames += [(d, f"frame{i:03d}.png") for i in range(n)]

    def write(k: int) -> None:
        d, name = frames[k]
        rng = np.random.default_rng((seed, k))
        img, shapes = instrument_frame(rng, yy, xx)
        label = np.zeros(EV17_FRAME, np.uint8)
        for shape, instrument in zip(shapes, rng.integers(1, 8, len(shapes))):
            label[shape] = instrument
        write_png(d / "images" / name, img)
        write_png(d / "binary_masks" / name, (label > 0).astype(np.uint8) * 255)
        write_png(d / "instruments_masks" / name, label * 32)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(frames))))


def multi_class_counted(counts, reset_counts, argv) -> dict:
    """`train_multi_class.main(argv)` with what phases 8z and 8zb hold it to
    recorded: the seconds, the labels of every training batch, the launches
    of each train step and validation forward, the logit convs' and the
    logits' channels, the trainables left unchanged and frozen parameters
    moved, K3's launches by kernel, the epoch's stats and log.txt's
    `test_ch_iou` and `test_isi_iou` (`--output_dir` is the argv's last)."""
    from adaptersis_tpu_torch import train_multi_class, train_seg
    from adaptersis_tpu_torch.models.decoders import LogitConv
    from adaptersis_tpu_torch.train.trainer import Trainer

    seen, per, labels, channels = {}, {"train": [], "eval": []}, set(), set()
    plain_build = train_seg.build_model
    plain_train, plain_eval = Trainer.train_step, Trainer.eval_step

    def build_recorded(args):
        model = plain_build(args)
        seen["model"] = model
        seen["start"] = {k: v.detach().clone() for k, v in model.named_parameters()}
        return model

    def train_counted(self, imgs, masks, *a, **kw):
        labels.update(torch.unique(masks).tolist())
        before = counts()
        out = plain_train(self, imgs, masks, *a, **kw)
        per["train"].append({k: v - before[k] for k, v in counts().items()})
        return out

    def eval_counted(self, *a, **kw):
        before = counts()
        out = plain_eval(self, *a, **kw)
        per["eval"].append({k: v - before[k] for k, v in counts().items()})
        channels.add(out["logits"].shape[-1])
        return out

    train_seg.build_model = build_recorded
    Trainer.train_step, Trainer.eval_step = train_counted, eval_counted
    try:
        t0 = time.perf_counter()
        reset_counts()
        hist = train_multi_class.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        train_seg.build_model = plain_build
        Trainer.train_step, Trainer.eval_step = plain_train, plain_eval
    by_kernel = path_counts()
    m, start = seen.pop("model"), seen.pop("start")
    unchanged, frozen_moved = [], []
    for n_, p_ in m.named_parameters():
        was = start[n_].to(p_.device, p_.dtype)
        if p_.requires_grad and torch.equal(p_.detach(), was):
            unchanged.append(n_)
        elif not p_.requires_grad and not torch.equal(p_.detach(), was):
            frozen_moved.append(n_)
    head = [mod.out_channels for mod in m.modules() if isinstance(mod, LogitConv)]
    del m, start
    logged = [json.loads(x) for x in (Path(argv[-1]) / "log.txt").read_text().splitlines()]
    return {"seconds": seconds, "hist": hist, "per": per, "labels": labels,
            "channels": channels, "head": head, "unchanged": unchanged,
            "frozen_moved": frozen_moved, "by_kernel": by_kernel,
            "challenge": {k: logged[-1].get(k) for k in ("test_ch_iou", "test_isi_iou")}}


def multi_class_checks(run: dict, steps: int, val_forwards: int, classes: int,
                       want_t: dict, want_e: dict, path: str) -> list:
    """What phases 8z and 8zb hold a `multi_class_counted` run to: the steps
    and validation forwards, finite losses, every trainable moved and the
    frozen backbone unchanged, `classes` logit channels, the launches per
    train step and validation forward, every K3 launch on `path`, and
    finite challenge metrics in [0, 1]. Returns the failures."""
    ep, per, failures = run["hist"][0], run["per"], []
    if len(per["train"]) != steps or len(per["eval"]) != val_forwards:
        failures.append(f"{len(per['train'])} steps, {len(per['eval'])} validation forwards")
    if not ep["train_losses_finite"]:
        failures.append(f"losses {ep['train_losses']}")
    if run["unchanged"] or run["frozen_moved"]:
        failures.append(f"trainables unchanged {run['unchanged'][:5]}, frozen moved "
                        f"{run['frozen_moved'][:5]}")
    if run["head"] != [classes] or run["channels"] != {classes}:
        failures.append(f"logit convs of {run['head']} channels, logits with "
                        f"{run['channels']} channels")
    if any(d != want_t for d in per["train"]):
        failures.append(f"launches per train step {per['train']}, expected {want_t}")
    if any(d != want_e for d in per["eval"]):
        failures.append(f"launches per validation forward {per['eval']}, expected {want_e}")
    launched = {k: sum(d[k] for d in per["train"] + per["eval"]) for k in want_t}
    if run["by_kernel"] != paths_expected(path, launched):
        failures.append(f"launches by kernel {run['by_kernel']}")
    if not all(isinstance(v, float) and math.isfinite(v) and 0.0 <= v <= 1.0
               for v in run["challenge"].values()):
        failures.append(f"log.txt's challenge metrics {run['challenge']}")
    return failures


def multi_class_run(counts, reset_counts, smi) -> dict:
    """Phase 8z: `python -m adaptersis_tpu_torch.train_multi_class --arch
    vit_large --patch_size 14 --imsize 588 --bf16 --gelu_approx` (8 classes,
    the iou_multi loss, --dataset endovis2017), batch 8, seeded weights, one
    epoch of 3 steps and a validation of one forward on
    `write_endovis2017_tree`'s frames. Finite losses; every trainable moved
    and the frozen backbone unchanged (as its bf16 cast); the head's 8
    output channels; launches per train step `expect(1, 7)` and per
    validation forward `expect(1, 0)`; `test_ch_iou` and `test_isi_iou` in
    log.txt, finite, within [0, 1]; img/s, loader wait, peak memory and
    seconds (`multi_class_counted`, `multi_class_checks`). Under the
    recipe's defaults both packages read `binary_masks`, so the labels
    trained on are {0, 1} (recorded)."""
    work = ROOT / "build" / "smoke_endovis2017"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_endovis2017_tree(work / "endovis2017")
    setup_s = time.perf_counter() - t0
    argv = ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588", "--bf16",
            "--gelu_approx", "--batch_size_per_gpu", str(EV17_BATCH), "--epochs", "1",
            "--seed", "0", "--data_path", str(work / "endovis2017"), "--num_workers", "8",
            "--output_dir", str(work / "out")]
    run = multi_class_counted(counts, reset_counts, argv)
    ep, per = run["hist"][0], run["per"]
    res = {"argv": argv, "setup_s": setup_s, "seconds": run["seconds"],
           "head_channels": run["head"], "logit_channels": sorted(run["channels"]),
           "labels_trained_on": sorted(run["labels"]),
           "steps": len(per["train"]), "validation_forwards": len(per["eval"]),
           "train_losses": ep["train_losses"], "test_loss": ep.get("test_loss"),
           "test_dice": ep.get("test_dice"), "test_acc1": ep.get("test_acc1"),
           **run["challenge"],
           "train_img_per_s": ep["train_img_per_s"], "loader_wait_s": ep["loader_wait_s"],
           "peak_mem_bytes": ep["peak_mem_bytes"], "decoder": ep["decoder"],
           "per_train_step": per["train"][:1], "per_validation_forward": per["eval"][:1],
           "unchanged_trainables": run["unchanged"], "frozen_moved": run["frozen_moved"],
           "by_kernel": run["by_kernel"], "nvidia_smi": smi[0] if smi else "unavailable"}
    say("multi_class_training", **res)
    failures = multi_class_checks(run, EV17_TRAIN // EV17_BATCH, 1, 8, expect(1, 7),
                                  expect(1, 0), "wgmma")
    if not run["labels"] <= {0, 1}:
        failures.append(f"trained on labels {sorted(run['labels'])}, binary_masks expected")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        fail("8z: " + "; ".join(failures))
    return res


# phase 8zb: three datasets from their raw release layouts through the
# port's converters into train_multi_class at ViT-S/14, 224 px, fp32, batch
# DATASET_BATCH: EndoVis 2018 (1280 × 1024 frames, 7 instrument classes and
# the background), CholecSeg8k (854 × 480, 13 classes by the watershed
# masks' gray levels), AutoLaparo task 3 (1920 × 1080, 10 classes by gray
# level); DATASET_TRAIN training frames (DATASET_STEPS steps) and
# DATASET_VAL validation frames (one forward) each
DATASET_TRAIN, DATASET_VAL, DATASET_BATCH, DATASET_STEPS = 16, 4, 8, 2
RAW_DATASETS = {  # --dataset: (converter module, frame (h, w), classes)
    "endovis2018": ("endovis2018", (1024, 1280), 8),
    "cholecseg8k": ("cholec8k", (480, 854), 13),
    "autolaparo": ("autolaparo", (1080, 1920), 10)}
# AutoLaparo's converter writes the split DATA_TYPE names: converted under
# the names the trainers ask the reader for
AUTOLAPARO_SPLITS = ("training", "validation")
# the releases' label codes: EndoVis 2018's instrument colours (labels.json;
# the kidney's colour maps to the background), CholecSeg8k's watershed gray
# level of each of its 13 classes in class order, AutoLaparo's gray levels
# of its 10 classes
EV18_INSTRUMENTS = {"bipolar forceps": [0, 255, 0], "prograsp forceps": [0, 255, 255],
                    "large needle driver": [125, 255, 12],
                    "monopolar curved scissors": [255, 55, 0],
                    "ultrasound probe": [24, 55, 125], "suction instrument": [187, 155, 25],
                    "clip applier": [0, 255, 125]}
EV18_KIDNEY = [255, 0, 0]
CHOLEC_GRAY = [50, 11, 21, 13, 12, 31, 23, 24, 25, 32, 22, 33, 5]
CHOLEC_TRAIN_VIDEOS, CHOLEC_VAL_VIDEO = ("video01", "video09"), "video12"
AUTOLAPARO_GRAY = [0, 180, 20, 40, 60, 80, 100, 120, 140, 160]


def labelled_frame(rng, yy, xx, classes: int):
    """`instrument_frame` with a class id in 1..classes − 1 for each shape
    (the first shape the highest class), 0 elsewhere: (RGB frame, label ids
    uint8)."""
    img, shapes = instrument_frame(rng, yy, xx)
    label = np.zeros(yy.shape, np.uint8)
    ids = [classes - 1] + list(rng.integers(1, classes, len(shapes) - 1))
    for shape, c in zip(shapes, ids):
        label[shape] = c
    return img, label


def write_raw_dataset(name: str, raw: Path, seed: int = 0) -> None:
    """A raw tree of dataset `name` in its release's layout (what its
    converter reads), `DATASET_TRAIN` training and `DATASET_VAL`
    validation frames at the release's frame size, through the port's PNG
    writer (AutoLaparo's frames as JPEG, through PIL); frame k drawn from
    `default_rng((seed, k))`, 8 at a time in threads:
      endovis2018: train_val/miccai_challenge_2018_release_1/seq_{1,2,3}/
        left_frames/ and labels/ (each class's colour, the kidney's beside
        them) and labels.json; seq 1 and 2 the training frames, seq 3 the
        validation ones;
      cholecseg8k: <video>/<video>_<k>/frame_<k>_endo.png and
        frame_<k>_endo_watershed_mask.png (RGB, each class's gray level):
        two of the converter's training videos, one of its test videos;
      autolaparo: autolaparo/imgs/{training,validation}/<k>.jpg and
        autolaparo/masks/{training,validation}/<k>.png (each class's gray
        level), the split names the trainers read (`AUTOLAPARO_SPLITS`)."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptersis_tpu_torch.data.png_writer import write_png
    frame, classes = RAW_DATASETS[name][1:]
    yy, xx = np.mgrid[0:frame[0], 0:frame[1]].astype(np.float32)
    half = DATASET_TRAIN // 2
    if name == "endovis2018":
        release = raw / "train_val" / "miccai_challenge_2018_release_1"
        places = [(release / f"seq_{1 + k // half}", f"frame{k:03d}.png")
                  for k in range(DATASET_TRAIN)]
        places += [(release / "seq_3", f"frame{k:03d}.png") for k in range(DATASET_VAL)]
        table = np.asarray([[0, 0, 0], *EV18_INSTRUMENTS.values()], np.uint8)
        for seq in sorted({d for d, _ in places}):
            for sub in ("left_frames", "labels"):
                (seq / sub).mkdir(parents=True)
            (seq / "labels.json").write_text(json.dumps(
                [{"name": n, "color": c} for n, c in
                 [("background tissue", [0, 0, 0]), *EV18_INSTRUMENTS.items(),
                  ("kidney parenchyma", EV18_KIDNEY)]]))
    elif name == "cholecseg8k":
        videos = [CHOLEC_TRAIN_VIDEOS[k // half] for k in range(DATASET_TRAIN)]
        videos += [CHOLEC_VAL_VIDEO] * DATASET_VAL
        places = [(raw / v / f"{v}_{80 * (k + 1):05d}", f"frame_{80 * (k + 1)}_endo.png")
                  for k, v in enumerate(videos)]
        for d, _ in places:
            d.mkdir(parents=True)
        gray = np.asarray(CHOLEC_GRAY, np.uint8)
    else:
        places = [(raw / "autolaparo", split, f"{k:05d}")
                  for split, n in zip(AUTOLAPARO_SPLITS, (DATASET_TRAIN, DATASET_VAL))
                  for k in range(n)]
        for split in AUTOLAPARO_SPLITS:
            for kind in ("imgs", "masks"):
                (raw / "autolaparo" / kind / split).mkdir(parents=True)
        gray = np.asarray(AUTOLAPARO_GRAY, np.uint8)

    def write(k: int) -> None:
        d, *fname = places[k]
        rng = np.random.default_rng((seed, k))
        img, label = labelled_frame(rng, yy, xx, classes)
        if name == "endovis2018":
            coded = table[label]
            coded[(label == 0) & (yy > 2 * frame[0] / 3)] = EV18_KIDNEY
            write_png(d / "left_frames" / fname[0], img)
            write_png(d / "labels" / fname[0], coded)
        elif name == "cholecseg8k":
            write_png(d / fname[0], img)
            write_png(d / fname[0].replace("_endo.png", "_endo_watershed_mask.png"),
                      np.repeat(gray[label][..., None], 3, -1))
        else:
            from PIL import Image
            split, stem = fname
            Image.fromarray(img).save(d / "imgs" / split / f"{stem}.jpg", quality=90)
            write_png(d / "masks" / split / f"{stem}.png", gray[label])

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(places))))


def convert_datasets(work: Path) -> dict:
    """Each dataset's converter run as a module on <work>/<name>/raw, all of
    them at once, each in its own process (AutoLaparo's once per split,
    `DATA_TYPE`), and the reader's root each gives: <work>/<name>/converted,
    but for EndoVis 2018, whose converter writes each training sequence's
    labels under <raw>/train/seq_N/labels, beside which the sequence's
    left_frames are linked, and whose validation sequence (3) goes to
    test/seq_1."""
    jobs = []
    for name, (module, _, _) in RAW_DATASETS.items():
        raw, out = work / name / "raw", work / name / "converted"
        argv = [sys.executable, "-m", f"adaptersis_tpu_torch.data.process.{module}", str(raw)]
        if name == "endovis2018":
            jobs.append((name, argv, {}))
        elif name == "autolaparo":
            jobs += [(name, argv + [str(out)], {"DATA_TYPE": split})
                     for split in AUTOLAPARO_SPLITS]
        else:
            jobs.append((name, argv + [str(out)], {}))
    procs = [(name, subprocess.Popen(argv, cwd=ROOT, env={**os.environ, **env},
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for name, argv, env in jobs]
    failed = []
    try:
        for name, proc in procs:
            text = proc.communicate(timeout=300)[0]
            if proc.returncode:
                failed.append(f"{name}'s converter exited {proc.returncode}: {text[-2000:]}")
    finally:
        stop([p for _, p in procs])
    if failed:
        fail("8zb: " + "; ".join(failed))
    roots = {name: work / name / "converted" for name in RAW_DATASETS}
    raw = roots["endovis2018"] = work / "endovis2018" / "raw"
    release = raw / "train_val" / "miccai_challenge_2018_release_1"
    for seq in (1, 2, 3):
        (raw / "train" / f"seq_{seq}" / "left_frames").symlink_to(
            release / f"seq_{seq}" / "left_frames")
    (raw / "test").mkdir()
    (raw / "train" / "seq_3").rename(raw / "test" / "seq_1")
    return roots


def read_labels(name: str, root: Path) -> dict:
    """Every label id of the reader's training and validation frames (at
    224 px, read on the host in 8 threads), and each split's frame count."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptersis_tpu_torch.data.datasets import DATASETS
    out = {}
    for split in ("training", "validation"):
        ds = DATASETS[name](str(root), split, imsize=224)
        with ThreadPoolExecutor(8) as pool:
            masks = list(pool.map(lambda i: ds[i][1], range(len(ds))))
        out[split] = {"frames": len(ds), "labels": sorted(
            set(np.unique(np.stack(masks)).tolist()) if masks else set())}
    return out


DATASET_WORK = ROOT / "build" / "smoke_datasets"
DATASET_LOG = ROOT / "build" / "smoke_datasets.log"


def make_datasets():
    """The three raw trees (`write_raw_dataset`) and their conversion
    (`convert_datasets`) under DATASET_WORK: (the readers' roots, the
    seconds each part took)."""
    shutil.rmtree(DATASET_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    for name in RAW_DATASETS:
        write_raw_dataset(name, DATASET_WORK / name / "raw")
    written = time.perf_counter() - t0
    roots = convert_datasets(DATASET_WORK)
    return roots, {"write_s": written, "convert_s": time.perf_counter() - t0 - written}


def start_datasets() -> subprocess.Popen:
    """`make_datasets` in a child process (`--datasets-child`) from now on,
    so that its host work (the PNG encoding of the converters' 1920 × 1080
    outputs takes tens of seconds) overlaps the kernel checks without
    taking the main process's interpreter: the child, whose output goes to
    DATASET_LOG and whose result phase 8zb reads (`datasets_made`); it is
    stopped at exit if the script ends first."""
    import atexit
    DATASET_LOG.parent.mkdir(parents=True, exist_ok=True)
    with DATASET_LOG.open("w") as log:
        child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                  "--datasets-child"], cwd=ROOT, stdout=log,
                                 stderr=subprocess.STDOUT)
    atexit.register(stop, [child])
    return child


def datasets_child() -> None:
    sys.path.insert(0, str(ROOT))
    roots, seconds = make_datasets()
    print("datasets " + json.dumps({"roots": {k: str(v) for k, v in roots.items()},
                                    "seconds": seconds}), flush=True)


def datasets_made(child: subprocess.Popen):
    """Wait for `start_datasets`'s child: (the readers' roots, the seconds
    its parts took)."""
    try:
        child.wait(timeout=600)
    finally:
        stop([child])
    text = DATASET_LOG.read_text()
    if child.returncode:
        fail(f"8zb: making the trees exited {child.returncode}: {text[-3000:]}")
    made = child_result(text, "datasets")
    return {k: Path(v) for k, v in made["roots"].items()}, made["seconds"]


def dataset_runs(counts, reset_counts, smi, trees) -> dict:
    """Phase 8zb: for EndoVis 2018, CholecSeg8k and AutoLaparo, a raw tree
    in the release's layout (`write_raw_dataset`), the port's converter as
    a module (`convert_datasets`), both made since `start_datasets` (whose
    child `trees` is), every label the reader gives checked on
    the host to lie in [0, classes) before any step (`read_labels`: a label
    out of range fails the phase here, with a message), then
    `train_multi_class --dataset <name> --num_labels C --num_classes C` at
    ViT-S/14, 224 px, fp32, batch DATASET_BATCH, DATASET_STEPS steps and a
    validation, held as 8z holds its run (`multi_class_checks`: launches
    per step those of the adapter model's fp32 step at 12 blocks, K3 on
    3×TF32); the labels trained on within [0, C). Then CholecSeg8k at the
    recipe's default 8 classes must stop before its first step with
    `evaluate.check_labels`'s message, not at a device-side assert."""
    from adaptersis_tpu_torch.data import native

    work = DATASET_WORK
    want_t = variant_expect("adapter", True, False, VITS_DEPTH)
    want_e = variant_expect("adapter", False, False, VITS_DEPTH)
    res, failures = {}, []

    def argv(name, classes, out):
        return ["--arch", "vit_small", "--patch_size", "14", "--imsize", "224",
                "--batch_size_per_gpu", str(DATASET_BATCH), "--epochs", "1", "--seed", "0",
                "--dataset", name, *(["--num_labels", str(classes)] if classes else []),
                *(["--num_classes", str(classes)] if classes else []),
                "--data_path", str(roots[name]), "--num_workers", "8", "--output_dir", str(out)]

    t0 = time.perf_counter()
    roots, made = datasets_made(trees)
    say("dataset_trees", waited_s=time.perf_counter() - t0, **made)
    for name, (_, frame, classes) in RAW_DATASETS.items():
        read = read_labels(name, roots[name])
        say("dataset_labels", dataset=name, classes=classes, frame=list(frame), read=read)
        if read["training"]["frames"] != DATASET_TRAIN or read["validation"]["frames"] != DATASET_VAL:
            fail(f"8zb {name}: the reader gives {read} frames, {DATASET_TRAIN} and "
                 f"{DATASET_VAL} written")
        bad = [v for s in read.values() for v in s["labels"] if not 0 <= v < classes]
        if bad:
            fail(f"8zb {name}: labels {sorted(set(bad))} outside [0, {classes}) before the "
                 "first step")
        run = multi_class_counted(counts, reset_counts, argv(name, classes,
                                                             work / name / "out"))
        ep, per = run["hist"][0], run["per"]
        res[name] = {"classes": classes, "seconds": run["seconds"],
                     "labels_trained_on": sorted(run["labels"]),
                     "head_channels": run["head"], "steps": len(per["train"]),
                     "validation_forwards": len(per["eval"]),
                     "train_losses": ep["train_losses"], "test_loss": ep.get("test_loss"),
                     "test_dice": ep.get("test_dice"), "test_acc1": ep.get("test_acc1"),
                     **run["challenge"], "train_img_per_s": ep["train_img_per_s"],
                     "loader_wait_s": ep["loader_wait_s"], "decoder": ep["decoder"],
                     "native_decoder": native.decoder(), "peak_mem_bytes": ep["peak_mem_bytes"],
                     "per_train_step": per["train"][:1],
                     "per_validation_forward": per["eval"][:1], "by_kernel": run["by_kernel"],
                     "nvidia_smi": smi[0] if smi else "unavailable"}
        say("dataset_training", dataset=name, **res[name])
        failures += [f"{name}: {f}" for f in multi_class_checks(
            run, DATASET_STEPS, 1, classes, want_t, want_e, "tf32x3")]
        if not run["labels"] <= set(range(classes)):
            failures.append(f"{name}: trained on labels {sorted(run['labels'])}")
        torch.cuda.empty_cache()
    # CholecSeg8k's 13 classes under the recipe's default 8: the host check
    # must stop the run with its message before the first step
    from adaptersis_tpu_torch import train_multi_class
    try:
        train_multi_class.main(argv("cholecseg8k", 0, work / "too_few_classes"))
        stopped = None
    except SystemExit as e:
        stopped = str(e.code)
    res["default_classes_on_cholecseg8k"] = stopped
    say("dataset_label_check", dataset="cholecseg8k", num_classes=8, stopped_with=stopped)
    if not (stopped and "outside [0, 8)" in stopped):
        failures.append(f"cholecseg8k at 8 classes: {stopped!r}, expected the label check's "
                        "message")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        fail("8zb: " + "; ".join(failures))
    return res


# phase 8za: the reference eval scripts' entry points at their published
# width, ViT-S/14 at all VITS_DEPTH blocks, each with its own imsize, loss,
# input norm and precision (fp32, exact GELU), batch ENTRY_BATCH, one epoch
# cut to ENTRY_STEPS steps and a validation of 2 forwards; phase 8zc trains
# vit_tiny the same way
VITS_DEPTH, ENTRY_STEPS = 12, 2
EVAL_ENTRIES = (("eval_dinov2_setr", "tap_setr"), ("eval_dinov2_unet", "tap_unet"),
                ("eval_dinov2_or_unet_fuse", "tap_unet_fuse"),
                ("eval_dinov2_masktrans", "tap_masktrans"),
                ("eval_dinov2_masktrans_inov", "tap_masktrans"),
                ("eval_dinov2_setr_cross_ete", "tap_setr_ete"))
TINY_RUNS = [("vit_tiny fp32", "train_seg", [], "adapter"),
             ("vit_tiny bf16", "train_seg", ["--bf16", "--gelu_approx"], "adapter")]


def entry_argv() -> list:
    """Phase 8za's flags: the scripts' published backbone, batch 16; the
    rest each script's own defaults."""
    return ["--arch", "vit_small", "--patch_size", "14", "--batch_size_per_gpu",
            str(ENTRY_BATCH)]


def tiny_argv() -> list:
    return ["--arch", "vit_tiny", "--patch_size", "14", "--imsize", "224",
            "--batch_size_per_gpu", str(ENTRY_BATCH)]


def eval_entry_runs(counts, reset_counts, smi) -> dict:
    """Phase 8za: `adaptersis_tpu_torch.eval.eval_dinov2_*.main` with
    `entry_argv`'s flags (`variant_runs`: finite losses and metrics, every
    trainable moved, the frozen backbone unchanged, launches per train step
    and validation forward as `variant_expect` says at 12 blocks with the
    exact GELU, K3 and K4 on 3×TF32). eval_dinov2_setr_cross_ete trains its
    backbone on a Robust-MIS tree (`write_robomis_tree`: ENTRY_STEPS
    batches of 960 × 540 frames and 2 validation batches) with
    `--cross_test_path` on a second tree from another seed (finite cross_*
    metrics), then `--evaluate` on its checkpoint gives its last acc1; the
    others train on synthetic frames."""
    work = ROOT / "build" / "smoke_entry_trees"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_robomis_tree(work / "robomis", seed=1, n_train=ENTRY_STEPS * ENTRY_BATCH,
                       n_val=2 * ENTRY_BATCH)
    write_robomis_tree(work / "robomis_cross", seed=2, n_train=0, n_val=2 * ENTRY_BATCH)
    say("eval_entry_trees", seconds=time.perf_counter() - t0)
    trees = ["--dataset", "robomis", "--data_path", str(work / "robomis"),
             "--cross_test_path", str(work / "robomis_cross")]
    runs = [(name, f"eval.{name}", trees if model == "tap_setr_ete" else [], model)
            for name, model in EVAL_ENTRIES]
    try:
        return variant_runs(counts, reset_counts, smi, runs=runs, flags=entry_argv,
                            want=partial(variant_expect, depth=VITS_DEPTH),
                            evaluated=EVAL_ENTRIES[-1][0], phase="8za", arch="vit_small",
                            depth=None, batch=ENTRY_BATCH, steps=ENTRY_STEPS)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def tiny_runs(counts, reset_counts, smi) -> dict:
    """Phase 8zc: `train_seg --arch vit_tiny --patch_size 14 --imsize 224
    --synthetic` with the adapter model at its 12 blocks, batch 16, in fp32
    and with `--bf16 --gelu_approx` (K5), checked as 8h checks its runs
    (`variant_runs`; --evaluate on the bf16 run's checkpoint)."""
    return variant_runs(counts, reset_counts, smi, runs=TINY_RUNS, flags=tiny_argv,
                        want=partial(variant_expect, depth=VITS_DEPTH),
                        evaluated=TINY_RUNS[-1][0], phase="8zc", arch="vit_tiny", depth=None,
                        batch=ENTRY_BATCH, steps=ENTRY_STEPS)


SSL_SUBTREES = ("student.", "teacher.", "dino_center", "ibot_center", "adam_mu", "adam_nu")


def ssl_resume_run(counts, reset_counts, expect_ssl, smi) -> dict:
    """Phase 8g: `pretrain` at its defaults (ViT-S/14, batch 32, 65536
    prototypes, bf16) for 2 epochs of 2 steps with a checkpoint every
    epoch: runs P and P′, R preempted after iteration 3 and resumed."""
    from adaptersis_tpu_torch import pretrain
    from adaptersis_tpu_torch.train.checkpoint import restore_checkpoint

    work = ROOT / "build" / "smoke_ssl"
    shutil.rmtree(work, ignore_errors=True)

    def run(out, preempt=None):
        argv = ["--bf16", "--synthetic", "--epochs", "2", "--steps_per_epoch", "2",
                "--warmup_epochs", "0", "--saveckp_freq", "1", "--output_dir", str(work / out)]
        if preempt:
            os.environ["ASN_PREEMPT_AT"] = str(preempt)
        reset_counts()
        try:
            arch, hist = pretrain.run(pretrain.get_args_parser().parse_args(argv))
        finally:
            os.environ.pop("ASN_PREEMPT_AT", None)
        got = counts()
        del arch
        torch.cuda.empty_cache()
        return hist, got

    runs = {"P": run("P"), "P2": run("P2"), "R1": run("R", preempt=3), "R2": run("R")}
    steps = {"P": 4, "P2": 4, "R1": 3, "R2": 2}

    def state(out):
        st = restore_checkpoint(work / out, "model_final")
        flat = dict(st["model"])
        flat.update({f"adam_mu.{i}": t for i, t in enumerate(st["mu"])})
        flat.update({f"adam_nu.{i}": t for i, t in enumerate(st["nu"])})
        return st, flat

    tags = {d: (work / d / "last_checkpoint").read_text() for d in ("P", "P2", "R")}
    files = {d: sorted(p_.name for p_ in (work / d).iterdir()) for d in ("P", "R")}
    (sp, p1), (_, p2), (sr, r) = state("P"), state("P2"), state("R")
    rule = resume_rule("8g", p1, p2, r, SSL_SUBTREES)
    res = {"launches": {k: v[1] for k, v in runs.items()},
           "losses": {k: [h["total_loss"] for h in v[0]] for k, v in runs.items()},
           "img_per_s": {k: [h["img_per_s"] for h in v[0]] for k, v in runs.items()},
           "last_checkpoint": tags, "files": files,
           "iterations": {"P": sp["iteration"], "R": sr["iteration"]}, "resume": rule,
           "nvidia_smi": smi[0] if smi else "unavailable"}
    say("ssl_resume", **res)
    for k, (hist, got) in runs.items():
        if got != expect_ssl(steps[k]):
            fail(f"8g: run {k} launched {got} in {steps[k]} steps, expected {SSL_PER_STEP} "
                 "per step")
        if not all(math.isfinite(h["total_loss"]) for h in hist):
            fail(f"8g: run {k}: non-finite losses {hist}")
    if set(tags.values()) != {"model_final"} or "model_final.pth" not in files["R"]:
        fail(f"8g: last_checkpoint tags {tags}, files {files}")
    if sp["iteration"] != 4 or sr["iteration"] != 4:
        fail(f"8g: final iterations {res['iterations']}, expected 4")
    shutil.rmtree(work, ignore_errors=True)
    return res


# phase 8h: `train_seg`'s other models and decoders at the paper's width,
# ViT-L/14 cut to 4 of its 24 blocks (12 until phase 8z and the two
# profiles came in, 8 until phases 8za-8zc did; the n_last_blocks taps
# need 4), to keep the whole script well inside its 1200 s limit
VARIANT_STEPS, VARIANT_DEPTH = 3, 4
# (name, entry point, its extra flags, --model)
VARIANTS = [("adapter mla", "train_mla", [], "adapter"),
            ("adapter setr", "train_seg", ["--decoder", "setr"], "adapter"),
            *((m, "train_seg", ["--model", m], m)
              for m in ("tap_setr", "tap_unet", "tap_unet_fuse", "tap_masktrans",
                        "tap_setr_ete"))]
# the model whose checkpoint `--evaluate` validates again
VARIANT_EVALUATED = "tap_setr_ete"


def variant_expect(model: str, train: bool, gelu_approx: bool = True,
                   depth: int = VARIANT_DEPTH) -> dict:
    """Launches per train step (or per validation forward) of `model` at D =
    `depth` blocks (ViT-L/14 cut to VARIANT_DEPTH), with tanh GELU: the
    adapter model's 2D K3, K4 and K5, 4 K6, 7 K1 (and 7 K2); each frozen
    walk of the taps D K3, K4 and K5 (unet_fuse walks three times), one K6
    per tap it norms (setr and masktrans read 4 blocks, the UNets 1 per
    walk); tap_setr_ete's trained backbone D K7 forwards, and in training D
    backwards. With the exact GELU (not `gelu_approx`) each frozen block
    takes K6 before its plain MLP in place of K5."""
    D = depth
    if model == "adapter":
        per = {"flash_fwd": 2 * D, "msda_fwd": 7, "fused_ln_qkv": 2 * D,
               "fused_ln_mlp": 2 * D, "layernorm": 4}
        out = expect(1, 7 if train else 0, per)
    else:
        out = {k: 0 for k in expect(0, 0)}
        if model == "tap_setr_ete":
            return {**out, "flash_attn": D, "flash_attn_bwd": D if train else 0}
        walks, norms = {"tap_setr": (1, 4), "tap_masktrans": (1, 4), "tap_unet": (1, 1),
                        "tap_unet_fuse": (3, 3)}[model]
        out = {**out, "flash_fwd": D * walks, "fused_ln_qkv": D * walks,
               "fused_ln_mlp": D * walks, "layernorm": norms}
    if not gelu_approx:
        out = {**out, "fused_ln_mlp": 0, "layernorm": out["layernorm"] + out["fused_ln_mlp"]}
    return out


@contextlib.contextmanager
def arch_depth(arch: str, depth):
    """`models.vit.ARCHS[arch]` cut to `depth` blocks inside the block (as
    it is where `depth` is None)."""
    from adaptersis_tpu_torch.models import vit
    full = vit.ARCHS[arch]
    if depth is not None:
        vit.ARCHS[arch] = partial(full, depth=depth)
    try:
        yield
    finally:
        vit.ARCHS[arch] = full


def variant_argv() -> list:
    """Phase 8h's flags: ViT-L/14 at 588 px, bf16, tanh GELU, batch 8 (its depth
    cut by `variant_runs`)."""
    return ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588", "--bf16",
            "--gelu_approx", "--batch_size_per_gpu", str(VARIANT_BATCH)]


def variant_runs(counts, reset_counts, smi, runs=VARIANTS, flags=variant_argv,
                 want=variant_expect, evaluated=VARIANT_EVALUATED, phase="8h",
                 arch="vit_large", depth=VARIANT_DEPTH, batch=VARIANT_BATCH,
                 steps=VARIANT_STEPS) -> dict:
    """Phase 8h: `train_seg` (for the MLA decoder `train_mla`) on every
    other `--model` and `--decoder` at the paper's width: ViT-L/14 at 588
    px cut to `VARIANT_DEPTH` blocks, bf16, tanh GELU, synthetic frames,
    batch 8, one epoch of 3 steps and a
    validation of 2 forwards, each model from its seed. Each run must give
    finite losses and metrics, move every trainable parameter and leave a
    frozen backbone bit for bit (as its bf16 cast), and launch per train
    step and per validation forward what `variant_expect` says. Then
    `--evaluate` on `VARIANT_EVALUATED`'s checkpoint (its trained backbone
    restored from it) must give the last validation's acc1. `depth` (if
    not None) cuts `arch`'s blocks for these runs. Phase 8j runs the same on
    ViT-g/14 at its full depth (`runs`, `flags`, `want`, `evaluated`), phase
    8s on ViT-L/14 in fp32 at `batch` 12, 8za the eval scripts' entry points
    (`runs` names "eval.<module>") and 8zc vit_tiny. A run whose flags
    name a `--data_path` reads that tree, not synthetic frames, and one with
    a `--cross_test_path` validates twice as many forwards and must give
    finite `cross_*` metrics. Every K3, K4 and K5 launch of a run must take
    the tensor-core kernel of the run's dtype (`path_counts`: "tf32x3" in
    fp32, "wgmma" with --bf16)."""
    import importlib

    from adaptersis_tpu_torch import train_mla, train_seg
    from adaptersis_tpu_torch.train.trainer import Trainer

    work = ROOT / "build" / f"smoke_variants_{phase}"
    shutil.rmtree(work, ignore_errors=True)
    entries = {"train_seg": train_seg, "train_mla": train_mla}
    entries.update({e: importlib.import_module(f"adaptersis_tpu_torch.{e}")
                    for _, e, _, _ in runs if e.startswith("eval.")})
    seen, per = {}, {"train": [], "eval": []}
    plain_build, plain_synthetic = train_seg.build_model, train_seg.SyntheticSeg
    plain_train, plain_eval = Trainer.train_step, Trainer.eval_step

    def build_recorded(args):
        model = plain_build(args)
        seen.update(model=model, imsize=args.imsize,
                    start={k: v.detach().clone() for k, v in model.named_parameters()})
        return model

    def counted(kind, fn):
        def wrap(self, *a, **kw):
            before = counts()
            out = fn(self, *a, **kw)
            after = counts()
            per[kind].append({k: after[k] - before[k] for k in after})
            return out
        return wrap

    def argv(name, extra):
        data = [] if "--data_path" in extra else ["--synthetic"]
        return flags() + extra + data + ["--epochs", "1", "--seed", "0", "--num_workers", "4",
                                         "--output_dir", str(work / name.replace(" ", "_"))]

    report, failures = {}, []
    with arch_depth(arch, depth):
        train_seg.build_model = build_recorded
        train_seg.SyntheticSeg = lambda n, **kw: plain_synthetic(n=steps * batch, **kw)
        Trainer.train_step = counted("train", plain_train)
        Trainer.eval_step = counted("eval", plain_eval)
        try:
            for name, entry, extra, model in runs:
                run_argv = argv(name, extra)
                dtype = "bf16" if "--bf16" in run_argv else "fp32"
                path = "wgmma" if dtype == "bf16" else "tf32x3"
                gelu = "--gelu_approx" in run_argv
                cross = "--cross_test_path" in run_argv
                per["train"].clear()
                per["eval"].clear()
                t0 = time.perf_counter()
                reset_counts()
                hist = entries[entry].main(run_argv)
                seconds = time.perf_counter() - t0
                by_kernel, launched = path_counts(), counts()
                m = seen.pop("model")
                start = seen.pop("start")
                unchanged, frozen_moved = [], []
                for n_, p_ in m.named_parameters():
                    was = start[n_].to(p_.device, p_.dtype)
                    if p_.requires_grad and torch.equal(p_.detach(), was):
                        unchanged.append(n_)
                    elif not p_.requires_grad and not torch.equal(p_.detach(), was):
                        frozen_moved.append(n_)
                trained = sorted({n_.split(".")[0] for n_, p_ in m.named_parameters()
                                  if p_.requires_grad})
                del m, start
                ep = hist[0]
                cross_rows = {k: v for k, v in ep.items() if k.startswith("cross_")}
                r = {"entry": entry, "flags": extra, "seconds": seconds, "steps": len(per["train"]),
                     "validation_forwards": len(per["eval"]), "train_losses": ep["train_losses"],
                     "test_loss": ep.get("test_loss"), "test_dice": ep.get("test_dice"),
                     "test_acc1": ep.get("test_acc1"), **cross_rows,
                     "train_img_per_s": ep["train_img_per_s"],
                     "peak_mem_bytes": ep["peak_mem_bytes"], "trained_subtrees": trained,
                     "per_train_step": per["train"][0] if per["train"] else None,
                     "per_validation_forward": per["eval"][0] if per["eval"] else None,
                     "unchanged_trainables": unchanged, "frozen_moved": frozen_moved,
                     "by_kernel": by_kernel}
                report[name] = r
                say("variant_training", name=name, arch=arch, depth=depth,
                    imsize=seen.pop("imsize"), dtype=dtype, batch=batch, **r)
                if by_kernel != paths_expected(path, launched):
                    failures.append(f"{name}: launches by kernel {by_kernel}")
                want_t, want_e = want(model, True, gelu), want(model, False, gelu)
                if r["steps"] != steps or r["validation_forwards"] != (4 if cross else 2):
                    failures.append(f"{name}: {r['steps']} steps, {r['validation_forwards']} "
                                    "validation forwards")
                if not ep["train_losses_finite"] or not all(
                        math.isfinite(ep.get(k, float("nan"))) for k in
                        ("test_loss", "test_dice", "test_acc1")):
                    failures.append(f"{name}: losses or metrics not finite: {ep}")
                if cross and not (cross_rows and all(math.isfinite(v)
                                                     for v in cross_rows.values())):
                    failures.append(f"{name}: cross_* metrics {cross_rows}")
                if any(d != want_t for d in per["train"]):
                    failures.append(f"{name}: launches per train step {per['train']}, "
                                    f"expected {want_t}")
                if any(d != want_e for d in per["eval"]):
                    failures.append(f"{name}: launches per validation forward {per['eval']}, "
                                    f"expected {want_e}")
                if unchanged or frozen_moved:
                    failures.append(f"{name}: trainables unchanged {unchanged[:5]}, frozen "
                                    f"parameters moved {frozen_moved[:5]}")
                if ("backbone" in trained) != (model == "tap_setr_ete"):
                    failures.append(f"{name}: trained subtrees {trained}")
                if name != evaluated:
                    shutil.rmtree(work / name.replace(" ", "_"), ignore_errors=True)
                torch.cuda.empty_cache()
            per["eval"].clear()
            reset_counts()
            _, entry_ev, extra_ev, model_ev = next(r for r in runs if r[0] == evaluated)
            argv_ev = argv(evaluated, extra_ev)
            ev = entries[entry_ev].main(argv_ev + ["--evaluate"])
            seen.clear()
        finally:
            train_seg.build_model, train_seg.SyntheticSeg = plain_build, plain_synthetic
            Trainer.train_step, Trainer.eval_step = plain_train, plain_eval
    last = report[evaluated]["test_acc1"]
    res = {"evaluated": evaluated, "evaluate_acc1": ev[0]["test_acc1"],
           "last_validation_acc1": last, "evaluate_launches": counts(),
           "nvidia_smi": smi[0] if smi else "unavailable"}
    say("variant_evaluate", arch=arch, **res)
    # the same checkpoint in the same process: only cuDNN's algorithm choice
    # may differ, moving acc1 by a pixel or two of 16 · 588²
    if abs(res["evaluate_acc1"] - last) > 1e-3:
        failures.append(f"--evaluate acc1 {res['evaluate_acc1']} against the last "
                        f"validation's {last}")
    want_ev = want(model_ev, False, "--gelu_approx" in argv_ev)
    if res["evaluate_launches"] != {k: 2 * v for k, v in want_ev.items()}:
        failures.append(f"--evaluate launches {res['evaluate_launches']}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        fail(f"{phase}: " + "; ".join(failures))
    return {**report, "evaluate": res}


# phase 8i: tap_setr_ete's train step, K7 against its plain version
ETE_GATE_BATCH = 2
ETE_SUBTREES = ("backbone", "head")


def ete_gate_inputs(seed=0):
    """tap_setr_ete at full width (ViT-L/14 at 588 px, the trained block
    configuration, tanh GELU) from `seed`, every LayerScale γ drawn from
    N(0, 0.1²) so that each block moves its tokens; one augmented batch
    (with CLAHE) of `ETE_GATE_BATCH` seeded frames and masks."""
    from adaptersis_tpu_torch.data.augment import (
        apply_train_augment, draw_train_augment, draws_to)
    from adaptersis_tpu_torch.models.layers import TRAINED
    from adaptersis_tpu_torch.models.tap_segmentor import TapSegmentor
    from adaptersis_tpu_torch.models.vit import build_backbone
    from adaptersis_tpu_torch.train.convert import seeded_init_

    dev, B, size = torch.device("cuda"), ETE_GATE_BATCH, 588
    impls = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
    backbone = build_backbone("vit_large", img_size=518, patch_size=14, gelu_approx=True,
                              **impls)
    model = seeded_init_(TapSegmentor(backbone, num_classes=2, decoder="setr_ete"), seed=seed)
    rng = np.random.default_rng(32 + seed)
    with torch.no_grad():
        for n, p in backbone.named_parameters():
            if n.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, np.float32)))
    imgs = torch.from_numpy(rng.integers(0, 256, (B, size, size, 3), np.uint8)).to(dev)
    masks = torch.from_numpy((rng.uniform(size=(B, size, size)) > 0.8)
                             .astype(np.int32)).to(dev)
    draws = draws_to(draw_train_augment(torch.Generator().manual_seed(5 + seed), B, size), dev)
    return model.to(dev), *apply_train_augment(imgs, masks, draws)


def ete_step_gate(fa, counts, reset_counts) -> dict:
    """Phase 8i: tap_setr_ete's bf16 train step (`ete_gate_inputs`, its loss
    CE + DC on the raw logits) on four sides from the same weights and
    batch: K7 (the kernel side); `flash_attn_plain` patched into
    `models.layers` (the plain side); PyTorch's SDPA there (the floor: an
    equally valid attention, with its own roundings); and a planted fault,
    K7 on q, k and v moved by one head. Against the plain side: the loss
    (relative, `SSL_GATE_LOSS_BOUND`) and per subtree (backbone, head) the
    gradients' `grad_distance`, held as phase 8e holds its subtrees: within
    max(1e-1, 2 × the floor's distance); the fault must break a bound. A
    zero gradient on the plain side fails, and so do K7 launches other than
    24 forwards and 24 backwards on the kernel and fault sides and none on
    the others."""
    from adaptersis_tpu_torch.models import layers
    F = torch.nn.functional
    t0 = time.perf_counter()
    model, x01, y = ete_gate_inputs()
    kernel = layers.flash_attn
    sides = {"kernel": [], "plain": [(layers, "flash_attn", fa.flash_attn_plain)],
             "floor": [(layers, "flash_attn", lambda q, k, v, scale, seg:
                        F.scaled_dot_product_attention(q, k, v, scale=scale))],
             "heads moved": [(layers, "flash_attn", lambda q, k, v, scale, seg: kernel(
                 *(t.roll(1, dims=1) for t in (q, k, v)), scale, seg))]}
    losses, grads, launches = {}, {}, {}
    for side, patches in sides.items():
        losses[side], grads[side], launches[side] = seg_gate_step(
            model, x01, y, patches, "full", counts, reset_counts, subtrees=ETE_SUBTREES,
            loss="ce_dc", softmax=False)
    measures = ("l2_dist", "max_rel")
    report, fault = {}, {}
    for sub, g in grads["plain"].items():
        r = grad_distance(grads["kernel"][sub], g)
        floor = grad_distance(grads["floor"][sub], g)
        r["floor"] = {k: floor[k] for k in measures}
        r["bound"] = {k: max(SSL_GATE_BOUND, 2 * floor[k]) for k in measures}
        report[sub] = r
        d = grad_distance(grads["heads moved"][sub], g)
        fault[sub] = max(d[k] / r["bound"][k] for k in measures)
    loss_err = {side: abs(v - losses["plain"]) / max(abs(losses["plain"]), 1e-30)
                for side, v in losses.items() if side != "plain"}
    out = {"losses": losses, "loss_rel_err": loss_err, "subtrees": report,
           "fault_share_of_bound": fault, "launches": launches,
           "seconds": time.perf_counter() - t0}
    say("ete_step_gate", arch="vit_large", imsize=588, batch=ETE_GATE_BATCH, dtype="bf16",
        bound=SSL_GATE_BOUND, loss_bound=SSL_GATE_LOSS_BOUND, **out)
    k7 = {**{k: 0 for k in expect(0, 0)}, "flash_attn": 24, "flash_attn_bwd": 24}
    for side, got in launches.items():
        want = k7 if side in ("kernel", "heads moved") else {k: 0 for k in k7}
        if got != want:
            fail(f"8i: launches {got} on the {side} side, expected {want}")
    dead = [sub for sub, r in report.items() if not r["norm_plain"] > 0]
    if dead:
        fail(f"8i: zero gradient on the plain side in {dead}")
    if not all(math.isfinite(loss_err[side]) and loss_err[side] <= SSL_GATE_LOSS_BOUND
               for side in ("kernel", "floor")):
        fail(f"8i: losses differ {losses}")
    if not max(fault.values()) > 1:
        fail(f"8i: the bounds pass q, k and v moved by one head: {fault}")
    for sub, r in report.items():
        if not all(r[k] <= r["bound"][k] for k in measures):
            fail(f"8i: {sub} gradients differ: {r}")
    del model
    torch.cuda.empty_cache()
    return out


# phase 8j: ViT-g/14 through `train_seg` at full width (M2b): its config file
# selects vit_giant2; the adapter model, bf16, 588 px, batch 8, 3 steps
G_CONFIG = ROOT / "configs" / "vitg14_pretrain.yaml"
G_RUNS = [("vitg adapter", "train_seg", [], "adapter")]
G_GATE_BATCH = 2


# phase 8s: `train_seg` at train.py's own example precision (its docstring's
# command: no --bf16, no --gelu_approx) on ViT-L/14 at 588 px, batch 12,
# one epoch cut to VARIANT_STEPS steps (`variant_runs`)
FP32_RUNS = [("train_seg fp32", "train_seg", ["--lr", "0.01"], "adapter")]
FP32_TRAIN_BATCH = 12


def fp32_argv() -> list:
    return ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
            "--batch_size_per_gpu", str(FP32_TRAIN_BATCH)]


def vitg_argv() -> list:
    return ["--config_file", str(G_CONFIG), "--imsize", "588", "--bf16",
            "--batch_size_per_gpu", str(VARIANT_BATCH)]


def vitg_expect(model: str, train: bool, gelu_approx: bool) -> dict:
    """Launches per ViT-g adapter train step (or validation forward); its
    SwiGLU blocks run no K5 with either GELU."""
    return expect(1, 7 if train else 0, G_PER_FORWARD)


def vitg_ssl_run(counts, reset_counts, expect_ssl, smi) -> dict:
    """Phase 8k: `pretrain --arch vit_giant2 --bf16 --synthetic` at its
    default crops (224 and 98 px, 8 local crops), batch `G_SSL_BATCH`, two
    steps: finite losses and parts, img/s (of the second step), peak memory,
    and `G_SSL_PER_STEP` K7 launches per step at 24 heads (run with ViT-g
    cut to `G_DEPTH` blocks)."""
    from adaptersis_tpu_torch import pretrain
    argv = ["--arch", "vit_giant2", "--bf16", "--synthetic", "--batch_size_per_gpu",
            str(G_SSL_BATCH), "--epochs", "1", "--steps_per_epoch", "2", "--warmup_epochs", "0"]
    t0 = time.perf_counter()
    reset_counts()
    arch, hist = pretrain.run(pretrain.get_args_parser().parse_args(argv))
    launches = counts()
    del arch
    torch.cuda.empty_cache()
    res = {"argv": argv, "epochs": hist, "launches": launches,
           "per_step": {k: v / 2 for k, v in launches.items()},
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi[0] if smi else "unavailable"}
    say("vitg_ssl", arch="vit_giant2", batch=G_SSL_BATCH, dtype="bf16", **res)
    if len(hist) != 1 or hist[0]["steps"] != 2 or not all(
            math.isfinite(hist[0][k]) for k in ("total_loss", "dino", "ibot", "koleo",
                                                 "img_per_s", "peak_mem_bytes")):
        fail(f"8k: {hist}")
    if launches != expect_ssl(2, G_SSL_PER_STEP):
        fail(f"8k: launches {launches} in 2 steps, expected {G_SSL_PER_STEP} per step")
    return res


def attention_map_run(counts, reset_counts, smi) -> dict:
    """Phase 8l: `visualize_attention` on the card at its default 448 px,
    on a seeded ViT-S/14 `.pth` (the same run on the CPU's plain path must
    give the same probabilities within 1e-4: fp32 on both, other summation
    orders through 12 blocks) and on vit_giant2's seeded draw; each writes
    2 × heads PNGs, each probability row sums to 1 within 1e-5, and the
    walk launches K4 in every block, K3 and K6 in all but the last (whose
    attention the hook computes in plain torch) and no K5."""
    from adaptersis_tpu_torch import visualize_attention
    from adaptersis_tpu_torch.models.vit import ARCHS
    from adaptersis_tpu_torch.train.convert import seeded_init_
    work = ROOT / "build" / "smoke_attention"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pth = work / "vits14.pth"
    torch.save({"teacher": seeded_init_(ARCHS["vit_small"](), seed=4).state_dict()}, pth)
    res = {}
    for arch, heads, depth, weights in (("vit_small", 6, 12, pth),
                                        ("vit_giant2", 24, G_DEPTH, None)):
        def run(device):
            argv = ["--arch", arch, "--device", device, "--output_dir", str(work / device / arch)]
            argv += ["--pretrained_weights", str(weights)] if weights else []
            return visualize_attention.run(visualize_attention.get_args_parser().parse_args(argv))

        reset_counts()
        attn, paths = run("cuda")
        launches = counts()
        r = {"heads": attn.shape[0], "tokens": attn.shape[1], "pngs": len(paths),
             "row_sum_max_err": (attn.sum(-1) - 1).abs().max().item(), "launches": launches}
        want = {**{k: 0 for k in launches}, "fused_ln_qkv": depth, "flash_fwd": depth - 1,
                "layernorm": depth - 1}
        if weights:
            r["vs_cpu_max_abs_err"] = (attn - run("cpu")[0]).abs().max().item()
        res[arch] = r
        if not (attn.shape[0] == heads and len(paths) == 2 * heads
                and all(os.path.isfile(q) for q in paths) and torch.isfinite(attn).all()
                and r["row_sum_max_err"] <= 1e-5 and r.get("vs_cpu_max_abs_err", 0) <= 1e-4
                and launches == want):
            fail(f"8l: {arch}: {r}, expected {heads} heads and launches {want}")
    say("attention_maps", **res, nvidia_smi=smi[0] if smi else "unavailable")
    shutil.rmtree(work, ignore_errors=True)
    return res


# phases 8m-8p: the ViT-Adapter + Mask2Former stack (M12) through its entry
# points at ViT-L/14 width, 518 px
M2F_STEPS = 3
M2F_GATE_BATCH = 2
M2F_SUBTREES = {"adapter": lambda n: n.startswith("adapter."),
                "pixel decoder": lambda n: n.startswith("head.pixel_decoder."),
                "decoder layers": lambda n: n.startswith("head.dec_"),
                "prediction heads": lambda n: n.startswith("head.") and not n.startswith(
                    ("head.dec_", "head.pixel_decoder."))}


class FirstItems:
    """The first `n` items of a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, min(n, len(dataset))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.dataset[i]


def per_forward(step: dict) -> dict:
    """A validation forward's launches: a train step's without K2."""
    return {**step, "msda_bwd": 0}


def m2f_entry_runs(counts, reset_counts, smi) -> dict:
    """Phases 8m-8o. 8m: `segment_m2f --arch vit_large --imsize 518
    --batch_size_per_gpu 4 --synthetic` at its fp32 default (exact GELU),
    one epoch cut to `M2F_STEPS` steps, its validation (2 forwards), its
    checkpoint, then the same command with `--epochs 2` resumes at epoch 1;
    launches per step and per validation forward as `M2F_FP32_STEP` says,
    img/s over the steps after the first, peak memory. 8n: `segment_m2f` at
    its defaults (vit_small: the adapters' D = 48), one step. 8o:
    `bench_m2f` at its defaults (ViT-L/14, bf16, batch 4, 2 warm-up steps
    and 3 windows of 5: `M2F_BENCH_STEP` a step), then `--arch
    vit_large_windowed --steps 1 --repeats 1` (3 steps,
    `M2F_WINDOWED_STEP`)."""
    from adaptersis_tpu_torch import bench_m2f, segment_m2f

    work = ROOT / "build" / "smoke_m2f"
    shutil.rmtree(work, ignore_errors=True)
    trainer_cls = segment_m2f.M2FTrainer
    plain_step, plain_eval, plain_sets = trainer_cls.step, trainer_cls.eval_step, \
        segment_m2f.datasets
    per = {"train": [], "eval": []}
    steps = [M2F_STEPS]

    def counted(kind, fn):
        def wrap(self, *a, **kw):
            before = counts()
            out = fn(self, *a, **kw)
            after = counts()
            per[kind].append({k: after[k] - before[k] for k in after})
            return out
        return wrap

    def first_batches(args):
        train, val = plain_sets(args)
        return FirstItems(train, steps[0] * args.batch_size_per_gpu), val

    report, failures = {}, []

    def run(name, argv, want, n_steps, resumed_from=0):
        per["train"].clear()
        per["eval"].clear()
        t0 = time.perf_counter()
        reset_counts()
        hist = segment_m2f.main(argv)
        r = {"argv": argv, "seconds": time.perf_counter() - t0,
             "epochs": [h["epoch"] for h in hist], "steps": len(per["train"]),
             "validation_forwards": len(per["eval"]),
             "train_losses": [h["train_losses"] for h in hist],
             "logged": [{k: v for k, v in h.items() if k not in ("train_losses",)}
                        for h in hist],
             "per_train_step": per["train"][:1], "per_validation_forward": per["eval"][:1],
             "nvidia_smi": smi[0] if smi else "unavailable"}
        report[name] = r
        say("m2f_training", name=name, **r)
        if r["epochs"] != [resumed_from] or r["steps"] != n_steps \
                or r["validation_forwards"] != 2:
            failures.append(f"{name}: epochs {r['epochs']}, {r['steps']} steps, "
                            f"{r['validation_forwards']} validation forwards")
        finite = all(math.isfinite(v) for h in hist for v in h["train_losses"]) and all(
            math.isfinite(h[k]) for h in hist for k in ("val_dice", "val_acc1", "train_loss"))
        if not finite:
            failures.append(f"{name}: losses or metrics not finite: {r['logged']}")
        if any(d != want for d in per["train"]):
            failures.append(f"{name}: launches per train step {per['train']}, expected {want}")
        if any(d != per_forward(want) for d in per["eval"]):
            failures.append(f"{name}: launches per validation forward {per['eval']}")
        # segment_m2f's default is fp32: every K3 launch on 3×TF32
        if path_counts() != paths_expected("tf32x3", counts()):
            failures.append(f"{name}: launches by kernel {path_counts()}")
        return hist

    trainer_cls.step = counted("train", plain_step)
    trainer_cls.eval_step = counted("eval", plain_eval)
    segment_m2f.datasets = first_batches
    try:
        out = work / "vit_large"
        argv = ["--arch", "vit_large", "--imsize", "518", "--batch_size_per_gpu",
                str(M2F_BATCH), "--synthetic", "--num_workers", "4", "--output_dir", str(out)]
        run("segment_m2f vit_large fp32", argv + ["--epochs", "1"], M2F_FP32_STEP, M2F_STEPS)
        ckpt = torch.load(out / "m2f_checkpoint.pth", map_location="cpu", weights_only=True)
        if ckpt["epoch"] != 1:
            failures.append(f"8m: the checkpoint holds epoch {ckpt['epoch']}")
        run("segment_m2f vit_large fp32 resumed", argv + ["--epochs", "2"], M2F_FP32_STEP,
            M2F_STEPS, resumed_from=1)
        lines = (out / "log.txt").read_text().splitlines()
        if [json.loads(x)["epoch"] for x in lines] != [0, 1]:
            failures.append(f"8m: log.txt holds {lines}")
        del ckpt
        torch.cuda.empty_cache()
        steps[0] = 1
        run("segment_m2f defaults", ["--synthetic", "--epochs", "1", "--num_workers", "4",
                                     "--output_dir", str(work / "defaults")], M2F_SMALL_STEP, 1)
    finally:
        trainer_cls.step, trainer_cls.eval_step = plain_step, plain_eval
        segment_m2f.datasets = plain_sets
    torch.cuda.empty_cache()
    # bench_m2f: 2 warm-up steps, 3 windows of 5 and 3 profiled steps
    for name, argv, want, n in (("bench_m2f", ["--profile"], M2F_BENCH_STEP, 2 + 3 * 5 + 3),
                                ("bench_m2f windowed", ["--arch", "vit_large_windowed",
                                                        "--steps", "1", "--repeats", "1"],
                                 M2F_WINDOWED_STEP, 3)):
        reset_counts()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = bench_m2f.main(argv)
        got = counts()
        report[name] = {"result": res, "launches": got, "seconds": time.perf_counter() - t0,
                        "per_step": {k: v / n for k, v in got.items()}}
        say("entry_point", module=bench_m2f.__name__, argv=argv, **report[name])
        if "--profile" in argv:
            report[name]["profile"] = check_profile(bench_m2f.__name__, printed.getvalue(),
                                                    res, smi)
        if not all(math.isfinite(res[k]) for k in ("value", "ms_step", "peak_mem_gib", "loss")):
            failures.append(f"{name}: values not finite: {res}")
        if got != {k: v * n for k, v in want.items()}:
            failures.append(f"{name}: launches {got} in {n} steps, expected {want} per step")
        if path_counts() != paths_expected("wgmma", got):
            failures.append(f"{name}: launches by kernel {path_counts()}")
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    if failures:
        fail("8m-8o: " + "; ".join(failures))
    return report


def m2f_step_gate(counts, reset_counts, seed=0, faults=("heads moved",)) -> dict:
    """Phase 8p: `bench_m2f`'s train step (ViT-L/14, 518 px, bf16, tanh
    GELU, 100 queries, 9 decoder layers) at batch 2 from one seeded model
    (every LayerScale γ ~ N(0, 0.1²)) on one seeded batch and one set of
    random points, on phase 8e's sides (`seg_gate_sides`): the plain
    versions of K1-K6, the kernels, the floor (plain, K4's and K5's sums in
    float64: two correct implementations), and the planted `faults`. The
    loss within `SSL_GATE_LOSS_BOUND` of the plain side's, each subtree's
    gradients (adapter, pixel decoder, decoder layers, prediction heads)
    within max(`SSL_GATE_BOUND`, 2 × floor) in normalised L2 distance and
    max relative error; each fault must break a bound. bf16 noise can flip
    a near-tied Hungarian match, which moves the loss by a jump: every side
    is fed the plain side's assignments, and the output says how many of
    its own pairs of a present segment would have differed (a padded slot's
    query is a tie by construction: its cost column is constant). The
    plain side's device LAPJV is held against scipy on the same costs
    (the total cost within 1e-5)."""
    import argparse

    from adaptersis_tpu_torch.models import m2f_loss
    from adaptersis_tpu_torch.ops.hungarian import lapjv
    from adaptersis_tpu_torch.segment_m2f import M2FTrainer, build_model

    t0 = time.perf_counter()
    dev, B, S = torch.device("cuda"), M2F_GATE_BATCH, 518
    args = argparse.Namespace(arch="vit_large", patch_size=14, num_classes=2, num_queries=100,
                              feat_channels=256, num_decoder_layers=9, seed=seed,
                              pretrained_weights="")
    model = build_model(args, gelu_approx=True)
    rng = np.random.default_rng(40 + seed)
    with torch.no_grad():
        for n_, p_ in model.backbone.named_parameters():
            if n_.endswith(".gamma"):
                p_.copy_(torch.from_numpy(0.1 * rng.standard_normal(p_.shape, np.float32)))
    model = model.to(dev)
    x01 = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), np.uint8)).to(dev).float() / 255
    masks = torch.from_numpy((rng.uniform(size=(B, S, S)) > 0.8).astype(np.int32)).to(dev)
    draws = m2f_loss.loss_draws(torch.Generator(dev).manual_seed(seed),
                                args.num_decoder_layers + 1, B, args.num_classes)
    sides = {k: v for k, v in seg_gate_sides().items()
             if k in ("kernel", "plain", "floor") or k in faults}
    order = ["plain"] + [k for k in sides if k != "plain"]
    matcher, kept = {}, m2f_loss.lapjv
    losses, grads, launches, flipped = {}, {}, {}, {}

    def fed(cost):
        own = lapjv(cost)
        if "plain" not in matcher:
            matcher["plain"] = own
            # the device LAPJV against scipy on these costs (near ties
            # included): the same total cost
            from scipy.optimize import linear_sum_assignment
            c = cost.double().cpu().numpy()
            pairs = own.cpu().numpy()
            for n_ in range(c.shape[0]):
                r_, k_ = linear_sum_assignment(c[n_])
                gap = c[n_][pairs[n_, 0], pairs[n_, 1]].sum() - c[n_][r_, k_].sum()
                matcher["scipy_gap"] = max(matcher.get("scipy_gap", 0.0),
                                           abs(gap) / max(1.0, abs(c[n_][r_, k_].sum())))
        present = ~(cost == 1e6).all(1)                                 # (N, G)
        differ = (own != matcher["plain"]).any(1) & present
        flipped[side] = flipped.get(side, 0) + int(differ.sum())
        return matcher["plain"]

    for side in order:
        trainer = M2FTrainer(copy.deepcopy(model), 2, bf16=True)
        saved = [getattr(mod, name) for mod, name, _ in sides[side]]
        reset_counts()
        try:
            for mod, name, fn in sides[side]:
                setattr(mod, name, fn)
            m2f_loss.lapjv = fed
            loss, _ = trainer.loss(x01, masks, draws)
            loss.backward()
        finally:
            for (mod, name, _), fn in zip(sides[side], saved):
                setattr(mod, name, fn)
            m2f_loss.lapjv = kept
        launches[side] = counts()
        losses[side] = float(loss.detach())
        named = [(n_, p_) for n_, p_ in trainer.model.named_parameters() if p_.requires_grad]
        grads[side] = {sub: torch.cat([(p_.grad if p_.grad is not None
                                        else torch.zeros_like(p_)).double().flatten()
                                       for n_, p_ in named if f(n_)])
                       for sub, f in M2F_SUBTREES.items()}
        del trainer, loss, named
        torch.cuda.empty_cache()
    measures = ("l2_dist", "max_rel")
    report, shares = {}, {f: {} for f in faults}
    for sub, g in grads["plain"].items():
        r = grad_distance(grads["kernel"][sub], g)
        floor = grad_distance(grads["floor"][sub], g)
        r["floor"] = {k: floor[k] for k in measures}
        r["bound"] = {k: max(SSL_GATE_BOUND, 2 * floor[k]) for k in measures}
        report[sub] = r
        for f in faults:
            d = grad_distance(grads[f][sub], g)
            shares[f][sub] = max(d[k] / r["bound"][k] for k in measures)
    loss_err = {side: abs(v - losses["plain"]) / max(abs(losses["plain"]), 1e-30)
                for side, v in losses.items() if side != "plain"}
    out = {"losses": losses, "loss_rel_err": loss_err, "subtrees": report,
           "faults_share_of_bound": shares, "launches": launches,
           "own_assignments_differing_from_plain": flipped,
           "fed_the_plain_assignment": True,
           "lapjv_vs_scipy_total_cost_rel_gap": matcher["scipy_gap"]}
    say("m2f_step_gate", arch="vit_large", imsize=S, batch=B, seed=seed, dtype="bf16",
        seconds=time.perf_counter() - t0, bound=SSL_GATE_BOUND,
        loss_bound=SSL_GATE_LOSS_BOUND, **out)
    for side, got in launches.items():
        want = {k: 0 for k in got} if side in ("plain", "floor") else M2F_BENCH_STEP
        if got != want:
            fail(f"m2f step gate: launches {got} on {side}, expected {want}")
    dead = [sub for sub, r in report.items() if not r["norm_plain"] > 0]
    if dead:
        fail(f"m2f step gate: zero gradient on the plain side in {dead}")
    if not matcher["scipy_gap"] <= 1e-5:       # fp32 costs summed over G = 2 pairs
        fail(f"m2f step gate: the device LAPJV misses scipy's optimum by "
             f"{matcher['scipy_gap']} of the total cost")
    if not all(math.isfinite(loss_err[s_]) and loss_err[s_] <= SSL_GATE_LOSS_BOUND
               for s_ in ("kernel", "floor")):
        fail(f"m2f step gate: losses differ {losses}")
    for f, sh in shares.items():
        if not max(sh.values()) > 1:
            fail(f"m2f step gate: the bounds pass {f}: {sh}")
    for sub, r in report.items():
        if not all(r[k] <= r["bound"][k] for k in measures):
            fail(f"m2f step gate: {sub} gradients differ: {r}")
    del model, grads
    torch.cuda.empty_cache()
    return out


# phase 8q: the DETR stack's deformable decoder (M12's last module) on the
# card: 6 layers at C 256 in 8 heads (K1 and K2 at D = 32 over 4 levels),
# 100 queries on a 64², 31², 16², 8² pyramid, batch 2, fp32
DETR_LEVELS = [(64, 64), (31, 31), (16, 16), (8, 8)]


def detr_decoder_check(counts, reset_counts) -> dict:
    """Phase 8q: `models/detr.py:DeformableDetrTransformerDecoder` with a
    refinement branch, seeded (every parameter drawn by `seeded_init_`),
    fp32 with TF32 off, on the card twice: with K1 and K2, and with the
    plain MSDA patched into `ops.ms_deform_attn` (everything else the same
    card ops, so both sides sample at the same fp32 locations; against the
    CPU a point within rounding of a pixel edge takes the other side's
    location gradient). Every layer's output and points within 1e-5 of
    their scale, every parameter's gradient of a seeded linear loss within
    1e-4 of its leaf's largest (at least 1e-3 of the largest of all: a
    leaf whose gradient vanishes analytically, the self-attention's key
    bias, holds rounding noise); 6 K1 and 6 K2 launches, none on the plain
    side."""
    from adaptersis_tpu_torch.models.detr import DeformableDetrTransformerDecoder
    from adaptersis_tpu_torch.ops import ms_deform_attn, msda_cuda as mc
    from adaptersis_tpu_torch.ops._build import plain
    from adaptersis_tpu_torch.train.convert import seeded_init_

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    C, nq, B, L = 256, 100, 2, len(DETR_LEVELS)
    S = sum(h * w for h, w in DETR_LEVELS)
    dec = seeded_init_(DeformableDetrTransformerDecoder(C, 6, 8, 1024, 4, L), seed=5).to(dev)
    # the refinement moves each point by a small delta per layer, as a
    # trained branch does: with the seeded N(0, 1/C) weights the six-layer
    # loop amplifies fp32 rounding ≈ 7× a layer (measured on the card), so
    # the branch's weights are scaled by 0.1
    reg = seeded_init_(torch.nn.Linear(C, 2), seed=6).to(dev)
    with torch.no_grad():
        reg.weight.mul_(0.1)
    g = torch.Generator().manual_seed(7)
    q, qpos = torch.randn(B, nq, C, generator=g), torch.randn(B, nq, C, generator=g)
    mem = torch.randn(B, S, C, generator=g)
    refs = (0.1 + 0.8 * torch.rand(B, nq, 1, 2, generator=g)).expand(B, nq, L, 2).contiguous()
    w_out = torch.randn(6, B, nq, C, generator=g)
    args = [t.to(dev) for t in (q, mem, refs)]
    res, core = {}, ms_deform_attn.msda_fwd
    for side in ("kernel", "plain"):
        d = copy.deepcopy(dec)
        reset_counts()
        try:
            if side == "plain":
                ms_deform_attn.msda_fwd = plain(mc.msda_plain)
            out, pts = d(*args, DETR_LEVELS, qpos.to(dev), reg_branch=reg)
            (out * w_out.to(dev)).sum().backward()
        finally:
            ms_deform_attn.msda_fwd = core
        res[side] = {"out": out.detach(), "pts": pts, "launches": counts(),
                     "grads": {n_: p_.grad for n_, p_ in d.named_parameters()}}
    ker, ref = res["kernel"], res["plain"]
    err = {k: ((ker[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1.0)).item()
           for k in ("out", "pts")}
    top = max(gr.abs().max().item() for gr in ref["grads"].values())
    rel = {n_: (ker["grads"][n_] - gr).abs().max().item() / max(gr.abs().max().item(),
                                                                1e-3 * top)
           for n_, gr in ref["grads"].items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    report = {"rel_err": err, "grad_worst": worst, "launches": ker["launches"],
              "plain_launches": ref["launches"], "levels": DETR_LEVELS, "queries": nq,
              "seconds": time.perf_counter() - t0}
    say("detr_decoder_check", **report)
    want = {k: 0 for k in ker["launches"]}
    if ref["launches"] != want:
        fail(f"detr decoder: launches on the plain side {ref['launches']}")
    want.update(msda_fwd=6, msda_bwd=6)
    if ker["launches"] != want:
        fail(f"detr decoder: launches {ker['launches']}, expected {want}")
    if not all(e <= 1e-5 for e in err.values()):
        fail(f"detr decoder: K1/K2 outputs differ from the plain MSDA's: {err}")
    if not worst[0][1] <= 1e-4:
        fail(f"detr decoder: gradients differ, worst (name, share of scale): {worst}")
    return report


def narrow_model():
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.train.convert import seeded_init_
    vit_kw = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2,
                  gelu_approx=True)
    return seeded_init_(AdapterSegmentor(DinoVisionTransformer(**vit_kw), encoder_inplanes=16,
                                         decoder_features=(128, 32, 16, 16, 8)), seed=0)


# phases 8t-8v (M10, M13): the port's data-parallel layer on the card. 8t
# and 8v's first half run the entry points under `torchrun --standalone
# --nproc_per_node 1` (NCCL at W = 1): the script itself is torchrun's
# program (`--torchrun-child`), which runs the module's `main` as `-m`
# would and prints its launches and the group's backend. 8u and 8v's second
# half run two ranks on the one card over gloo (NCCL refuses two ranks on
# one GPU): each rank (`--gloo-child`) calls init_process_group("gloo")
# itself and then the port's library functions, on its rows of the global
# batch, against one process at the global batch.
DP_TRAIN_STEPS = 3                      # 8t: steps of each torchrun epoch
DP_SEG_BATCH = 4                        # 8u: the global batch, 2 a rank
DP_SSL_STEPS = 2                        # 8v: pretrain's steps
GLOO_RANKS = 2


def child_result(text: str, tag: str) -> dict:
    """The JSON a child printed after `tag` (its last such line)."""
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    if not lines:
        raise ValueError(f"no {tag} line in the child's output")
    return json.loads(lines[-1][len(tag) + 1:])


def torchrun(args: list, timeout: float = 300) -> dict:
    """`torchrun --standalone --nproc_per_node 1` of this script as
    `--torchrun-child` (see `torchrun_child`); returns what it reports:
    one entry of `runs` per `RUNS_APART`-separated argv."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", str(ROOT / "chip_smoke.py"), "--torchrun-child", *map(str, args)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    if proc.returncode:
        fail(f"torchrun {' '.join(map(str, args))} exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return {**child_result(proc.stdout, "TORCHRUN_CHILD"),
            "seconds_with_startup": time.perf_counter() - t0}


RUNS_APART = "::"


def torchrun_child(steps: int, module: str, argv: list) -> None:
    """Under torchrun: `module`'s main(argv), as `python -m module argv`
    runs it, with `train_seg`'s synthetic epoch cut to `steps` global
    batches when `steps` > 0; `argv` split at `RUNS_APART` runs main once
    for each part in turn, in the same process and process group (a save,
    then a resume from it, without a second start-up). Then one line of the
    group's backend and world size and, per run, its launches and returned
    history."""
    import importlib

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch import train_seg
    from adaptersis_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    counts, reset_counts = launch_counters()
    if steps:
        plain = train_seg.SyntheticSeg
        batch = int(argv[argv.index("--batch_size_per_gpu") + 1])
        train_seg.SyntheticSeg = lambda n, **kw: plain(
            n=steps * batch * int(os.environ["WORLD_SIZE"]), **kw)
    main = importlib.import_module(module).main
    parts, runs = [[]], []
    for a in argv:
        parts.append([]) if a == RUNS_APART else parts[-1].append(a)
    for part in parts:
        reset_counts()
        runs.append({"history": main(part), "launches": counts()})
    out = {"module": module, "runs": runs,
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "world_size": dist.get_world_size() if dist.is_initialized() else 1}
    if dist.is_initialized():
        dist.destroy_process_group()
    print("TORCHRUN_CHILD " + json.dumps(out), flush=True)


def torchrun_train_seg(counts, reset_counts, smi, phase8_img_s) -> dict:
    """Phase 8t: `train_seg` under torchrun at W = 1 over NCCL, ViT-L/14 at
    588 px, bf16, batch 16, an epoch of `DP_TRAIN_STEPS` steps saved, then
    (in the same launch) the same flags with --epochs 2, which must resume
    from it and train the second epoch alone. Each run: the train steps'
    and the validation's launches, finite losses and metrics; its img/s
    beside phase 8's."""
    work = ROOT / "build" / "smoke_torchrun"
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--arch", "vit_large", "--patch_size", "14", "--imsize", "588",
            "--batch_size_per_gpu", str(TRAIN_BATCH), "--bf16", "--gelu_approx", "--synthetic",
            "--seed", "0", "--num_workers", "4", "--output_dir", str(work)]
    launch = torchrun([DP_TRAIN_STEPS, "adaptersis_tpu_torch.train_seg", *argv, "--epochs",
                       "1", RUNS_APART, *argv, "--epochs", "2"])
    if launch["backend"] != "nccl" or launch["world_size"] != 1:
        fail(f"8t: backend {launch['backend']} at world size {launch['world_size']}, "
             "expected nccl, 1")
    runs = {}
    for epochs, r in zip((1, 2), launch["runs"]):
        runs[f"epochs {epochs}"] = r
        ep = r["history"][-1] if r["history"] else {}
        val_forwards = 2                # 2 global batches of validation frames
        want = expect(DP_TRAIN_STEPS + val_forwards, 7 * DP_TRAIN_STEPS)
        say("torchrun_train_seg", run=f"--epochs {epochs}", backend=launch["backend"],
            world_size=launch["world_size"], epochs_run=[h["epoch"] for h in r["history"]],
            steps=len(ep.get("train_losses", [])), train_losses=ep.get("train_losses"),
            test_acc1=ep.get("test_acc1"), launches=r["launches"], expected=want,
            train_img_per_s=ep.get("train_img_per_s"), phase8_train_img_per_s=phase8_img_s,
            launch_seconds_with_startup=launch["seconds_with_startup"],
            nvidia_smi=smi[0] if smi else "unavailable")
        if [h["epoch"] for h in r["history"]] != [epochs - 1]:
            fail(f"8t: --epochs {epochs} ran epochs {[h['epoch'] for h in r['history']]} "
                 "(the second run must resume after the first)")
        if len(ep["train_losses"]) != DP_TRAIN_STEPS or not ep["train_losses_finite"] or \
                not all(math.isfinite(ep[k]) for k in ("test_loss", "test_dice", "test_acc1")):
            fail(f"8t: {ep}")
        if r["launches"] != want:
            fail(f"8t: launches {r['launches']}, expected {want}")
    shutil.rmtree(work, ignore_errors=True)
    return runs


GLOO_WORK = ROOT / "build" / "smoke_gloo"


def gloo_ranks(job: str, args: list) -> list:
    """Start `GLOO_RANKS` processes of this script as `--gloo-child job`,
    with torchrun's variables, their output in files under `GLOO_WORK`;
    `gloo_reports` collects them."""
    GLOO_WORK.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(GLOO_RANKS):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(GLOO_RANKS),
               "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        with open(GLOO_WORK / f"{job}.rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-child", job,
                 *map(str, args)], env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    return procs


def stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def gloo_reports(procs: list, job: str, timeout: float = 300) -> list:
    """Each rank's report; fails if a rank fails or outlives `timeout`."""
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(procs)
    logs = [(GLOO_WORK / f"{job}.rank{r}.log").read_text() for r in range(len(procs))]
    for p, log in zip(procs, logs):
        if p.returncode:
            fail(f"gloo rank of {job} exited {p.returncode}:\n{log[-4000:]}")
    return [child_result(log, "GLOO_CHILD") for log in logs]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_refusal(err: Exception) -> bool:
    """An error of a collective that gloo does not carry (on CUDA tensors)."""
    msg = str(err).lower()
    return "gloo" in msg or "not supported" in msg or "not implemented" in msg


def gloo_child(job: str, args: list) -> None:
    """One rank of `gloo_ranks`: init_process_group("gloo") on the card, then
    `job` ("seg" or "ssl") through the port's library functions; prints its
    report. A collective gloo refuses is reported as such."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    _build.library()
    counts, reset_counts = launch_counters()
    rank, W = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world_size": W, "backend": dist.get_backend()}
    if job == "seg":
        model, x01, y = seg_gate_inputs(0, batch=DP_SEG_BATCH)
        mine = torch.arange(rank, DP_SEG_BATCH, W, device=x01.device)
        for fsdp in (1, 2):
            try:
                loss, grads, launched = dp_seg_step(model, x01[mine], y[mine], counts,
                                                    reset_counts, fsdp)
                out[f"fsdp {fsdp}"] = {"loss": loss, "launches": launched,
                                       "grads": {k: v.cpu() for k, v in grads.items()}}
            except RuntimeError as e:
                if fsdp == 1 or not gloo_refusal(e):
                    raise
                out[f"fsdp {fsdp}"] = {"refused": f"{type(e).__name__}: {str(e)[:400]}"}
        torch.save(out, Path(args[0]) / f"seg.rank{rank}.pt")
        for fsdp in (1, 2):
            out[f"fsdp {fsdp}"].pop("grads", None)
    else:
        for fsdp in (1, 2):
            arch, g, l, masks = dp_ssl_inputs(rank, W, fsdp)
            reset_counts()
            try:
                losses = {k: float(v)
                          for k, v in arch.train_step(g, l, masks, **DP_SSL_STEP).items()}
                out[f"fsdp {fsdp}"] = {
                    "losses": losses, "launches": counts(),
                    "centres": {c: getattr(arch, c).double().cpu().tolist()
                                for c in ("dino_center", "ibot_center")}}
            except RuntimeError as e:
                if fsdp == 1 or not gloo_refusal(e):
                    raise
                out[f"fsdp {fsdp}"] = {"refused": f"{type(e).__name__}: {str(e)[:400]}"}
            del arch
    dist.barrier()
    dist.destroy_process_group()
    print("GLOO_CHILD " + json.dumps(out), flush=True)


def dp_seg_step(model, x01, y, counts, reset_counts, fsdp):
    """One bf16 `Trainer` step of a copy of `model` over the job's ranks
    (the mesh of `fsdp`): the loss (the ranks' mean), each subtree's flat
    fp64 gradient (all-reduced) and this rank's launches."""
    from adaptersis_tpu_torch.parallel.mesh import get_mesh
    from adaptersis_tpu_torch.train.trainer import Trainer
    trainer = Trainer(copy.deepcopy(model), bf16=True, mesh=get_mesh(fsdp, "cuda"))
    reset_counts()
    loss = float(trainer.step(x01, y, epoch=0))
    grads = {sub: torch.cat([p.grad.double().flatten() for n, p in
                             trainer.model.named_parameters() if n.split(".")[0] == sub])
             for sub in SEG_SUBTREES}
    return loss, grads, counts()


def gloo_seg_check(counts, reset_counts) -> dict:
    """Phase 8u: the adapter step at ViT-L/14 width (`seg_gate_inputs`, bf16,
    seed 0) at two gloo ranks of 2 images each against one process at the 4
    images, all with the kernels: the loss (relative, `SSL_GATE_LOSS_BOUND`)
    and each subtree's gradient within max(`SSL_GATE_BOUND`, 2 × floor), as
    phase 8e holds them; the floor is the one-process step on the same 4
    images in the ranks' row order (0, 2, 1, 3), which moves only the
    batch sums. Each rank launches one forward's kernels and 7 MSDA
    backwards. Then the same at --fsdp 2 (the frozen backbone sharded
    over both ranks), or the line naming the collective gloo refused."""
    work = GLOO_WORK
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    procs = gloo_ranks("seg", [work])          # they run while this process steps
    try:
        model, x01, y = seg_gate_inputs(0, batch=DP_SEG_BATCH)
        ref_loss, ref, ref_launches = seg_gate_step(model, x01, y, [], "full", counts,
                                                    reset_counts)
        order = torch.tensor([0, 2, 1, 3], device=x01.device)
        floor_loss, floor, _ = seg_gate_step(model, x01[order], y[order], [], "full", counts,
                                             reset_counts)
        del model
    except BaseException:
        stop(procs)
        raise
    ranks = gloo_reports(procs, "seg")
    measures = ("l2_dist", "max_rel")
    saved = [torch.load(work / f"seg.rank{r}.pt") for r in range(GLOO_RANKS)]
    report, failures = {}, []
    for fsdp in (1, 2):
        got = saved[0][f"fsdp {fsdp}"]
        if "refused" in got:
            report[f"fsdp {fsdp}"] = {"gloo_refused": got["refused"]}
            say("gloo_refused", phase="8u", fsdp=fsdp, collective_error=got["refused"])
            continue
        subs = {}
        for sub, g in ref.items():
            d = grad_distance(got["grads"][sub].to(g.device), g)
            fl = grad_distance(floor[sub], g)
            d["floor"] = {k: fl[k] for k in measures}
            d["bound"] = {k: max(SSL_GATE_BOUND, 2 * fl[k]) for k in measures}
            subs[sub] = d
            if not all(d[k] <= d["bound"][k] for k in measures):
                failures.append(f"fsdp {fsdp} {sub}: {d}")
        loss_err = abs(got["loss"] - ref_loss) / max(abs(ref_loss), 1e-30)
        if not loss_err <= SSL_GATE_LOSS_BOUND:
            failures.append(f"fsdp {fsdp}: loss {got['loss']} against {ref_loss}")
        for r in range(GLOO_RANKS):
            if saved[r][f"fsdp {fsdp}"]["launches"] != expect(1, 7):
                failures.append(f"fsdp {fsdp} rank {r}: launches "
                                f"{saved[r][f'fsdp {fsdp}']['launches']}")
        same = all(torch.equal(saved[1][f"fsdp {fsdp}"]["grads"][s], got["grads"][s])
                   for s in got["grads"])
        if not same:
            failures.append(f"fsdp {fsdp}: the ranks' all-reduced gradients differ")
        report[f"fsdp {fsdp}"] = {"loss": got["loss"], "loss_rel_err": loss_err,
                                  "subtrees": subs, "launches_rank0": got["launches"]}
    say("gloo_seg_step", arch="vit_large", imsize=588, dtype="bf16", ranks=GLOO_RANKS,
        backend=ranks[0]["backend"], batch_per_rank=DP_SEG_BATCH // GLOO_RANKS,
        reference_loss=ref_loss, floor_loss=floor_loss, reference_launches=ref_launches,
        seconds=time.perf_counter() - t0, **report)
    if ref_launches != expect(1, 7):
        failures.append(f"reference launches {ref_launches}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        fail("8u: " + "; ".join(failures))
    return report


DP_SSL_STEP = dict(lr=1e-3, wd=0.04, momentum=0.992, teacher_temp=0.07, last_layer_lr=1e-3)


def dp_ssl_inputs(rank: int, W: int, fsdp: int = 1):
    """`bench_ssl`'s model (ViT-S/14, bf16, 65536 prototypes, 8 local crops,
    seed 0; over W ranks on the mesh of `fsdp`), its global batch of
    `SSL_BATCH` images, crops and masks, and a rank's share of them (the
    rows of images rank, rank + W, ...; one process: all)."""
    from adaptersis_tpu_torch.data.augment import draws_to, rank_rows
    from adaptersis_tpu_torch.models import layers
    from adaptersis_tpu_torch.models.vit import build_backbone
    from adaptersis_tpu_torch.parallel.mesh import get_mesh
    from adaptersis_tpu_torch.ssl.augment import apply_multicrop, draw_multicrop
    from adaptersis_tpu_torch.ssl.masking import (MaskingGenerator, collate_masks_with_indices,
                                                  rank_masks)
    from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to

    G, L, B, n_local, patch, dev = 224, 98, SSL_BATCH, 8, 14, torch.device("cuda")
    attn_impl, ln_impl, qkv_impl, mlp_impl = layers.TRAINED
    torch.manual_seed(0)
    backbone = build_backbone("vit_small", img_size=G, patch_size=patch, attn_impl=attn_impl,
                              ln_impl=ln_impl, qkv_impl=qkv_impl, mlp_impl=mlp_impl)
    cfg = SSLConfig(dino_out_dim=65536, ibot_out_dim=65536, n_local_crops=n_local)
    arch = SSLMetaArch(backbone, cfg, bf16=True).to(dev).shard(get_mesh(fsdp, "cuda"))
    imgs = np.random.default_rng(0).integers(0, 256, (B, G + 32, G + 32, 3), np.uint8)
    imgs = torch.from_numpy(imgs[rank::W]).to(dev)
    draws = rank_rows(draw_multicrop(torch.Generator().manual_seed(1), B, n_local))
    g, l = apply_multicrop(imgs, draws_to(draws, dev), G, L)
    grid = G // patch
    info = collate_masks_with_indices(2 * B, grid * grid, MaskingGenerator(
        (grid, grid), num_masking_patches=grid * grid // 2), seed=7)
    return arch, g, l, masks_to(rank_masks(info, grid * grid, rank, W), dev)


def gloo_ssl_check(counts, reset_counts, expect_ssl) -> dict:
    """Phase 8v's second half: one SSL step (`dp_ssl_inputs`) at two gloo
    ranks of 16 images each, at --fsdp 1 (whole modules, the gradients'
    flat all-reduce) and --fsdp 2 (FSDP2 over both ranks), against one
    process at the 32: the losses (relative, `SSL_GATE_LOSS_BOUND`) and
    both centres (max |a − b| within `SSL_GATE_LOSS_BOUND` of the
    one-process centre's largest value), each rank launching K7 for its
    step; at --fsdp 2, or the line naming the collective gloo refused."""
    t0 = time.perf_counter()
    shutil.rmtree(GLOO_WORK, ignore_errors=True)
    procs = gloo_ranks("ssl", [])              # they run while this process steps
    try:
        arch, g, l, masks = dp_ssl_inputs(0, 1)
        reset_counts()
        want = {k: float(v) for k, v in arch.train_step(g, l, masks, **DP_SSL_STEP).items()}
        ref_launches = counts()
        centres = {c: getattr(arch, c).double().cpu() for c in ("dino_center", "ibot_center")}
        del arch
        torch.cuda.empty_cache()
    except BaseException:
        stop(procs)
        raise
    ranks = gloo_reports(procs, "ssl")
    out, failures = {}, []
    for fsdp in (1, 2):
        got = [r[f"fsdp {fsdp}"] for r in ranks]
        if "refused" in got[0]:
            say("gloo_refused", phase="8v", fsdp=fsdp, collective_error=got[0]["refused"])
            out[f"fsdp {fsdp}"] = {"gloo_refused": got[0]["refused"]}
            continue
        loss_err = {k: abs(got[0]["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in want.items()}
        centre_err = {c: (torch.tensor(got[0]["centres"][c], dtype=torch.float64) - v).abs()
                      .max().item() / max(v.abs().max().item(), 1e-30)
                      for c, v in centres.items()}
        out[f"fsdp {fsdp}"] = {"losses": got[0]["losses"], "loss_rel_err": loss_err,
                               "centre_rel_err": centre_err,
                               "launches": [r["launches"] for r in got]}
        failures += [f"fsdp {fsdp} loss {k}: {e}" for k, e in loss_err.items()
                     if not (math.isfinite(e) and e <= SSL_GATE_LOSS_BOUND)]
        failures += [f"fsdp {fsdp} centre {c}: {e}" for c, e in centre_err.items()
                     if not e <= SSL_GATE_LOSS_BOUND]
        if any(r["launches"] != expect_ssl(1) for r in got):
            failures.append(f"fsdp {fsdp} launches {[r['launches'] for r in got]}")
        if any(r["losses"] != got[0]["losses"] for r in got):
            failures.append(f"fsdp {fsdp}: the ranks report different losses")
    say("gloo_ssl_step", arch="vit_small", dtype="bf16", ranks=GLOO_RANKS,
        backend=ranks[0]["backend"], batch_per_rank=SSL_BATCH // GLOO_RANKS,
        one_process_losses=want, one_process_launches=ref_launches,
        seconds=time.perf_counter() - t0, **out)
    if ref_launches != expect_ssl(1):
        failures.append(f"one-process launches {ref_launches}")
    shutil.rmtree(GLOO_WORK, ignore_errors=True)
    if failures:
        fail("8v: " + "; ".join(failures))
    return out


def torchrun_pretrain(expect_ssl, smi) -> dict:
    """Phase 8v's first half: `pretrain` under torchrun at W = 1 over NCCL:
    ViT-S/14, DINOv2's recipe (its defaults: batch 32, 2 global crops of
    224 and 8 of 98, 65536 prototypes), bf16, `DP_SSL_STEPS` steps."""
    launch = torchrun([0, "adaptersis_tpu_torch.pretrain", "--bf16", "--synthetic", "--epochs",
                       "1", "--steps_per_epoch", str(DP_SSL_STEPS), "--warmup_epochs", "0"])
    r = launch["runs"][0]
    ep = r["history"][0] if r["history"] else {}
    say("torchrun_pretrain", backend=launch["backend"], world_size=launch["world_size"],
        epoch=ep, launches=r["launches"],
        launch_seconds_with_startup=launch["seconds_with_startup"],
        nvidia_smi=smi[0] if smi else "unavailable")
    if launch["backend"] != "nccl" or launch["world_size"] != 1:
        fail(f"8v: backend {launch['backend']} at world size {launch['world_size']}")
    if len(r["history"]) != 1 or ep.get("steps") != DP_SSL_STEPS or not all(
            math.isfinite(ep[k]) for k in ("total_loss", "dino", "ibot", "koleo")):
        fail(f"8v: pretrain {r['history']}")
    if r["launches"] != expect_ssl(DP_SSL_STEPS):
        fail(f"8v: pretrain launches {r['launches']}, expected {expect_ssl(DP_SSL_STEPS)}")
    return launch


def expect_eval(forwards: int) -> dict:
    """Launches of `forwards` extraction forwards of the fp32 ViT-L/14."""
    return {**{k: v * forwards for k, v in EVAL_PER_FORWARD.items()}, "msda_bwd": 0,
            "flash_attn": 0, "flash_attn_bwd": 0}


def write_folder_tree(root: Path, per_class: int = EVAL_BATCH, seed: int = 0) -> None:
    """An image-folder tree, <root>/<split>/<class>/<n>.jpg: two classes of
    `per_class` 240 × 320 JPEG frames a split (the second class brighter)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for c, name in enumerate(("class_a", "class_b")):
            d = root / split / name
            d.mkdir(parents=True)
            for i in range(per_class):
                img = rng.integers(0, 160, (240, 320, 3), np.uint8) + np.uint8(90 * c)
                Image.fromarray(img).save(d / f"{i:04d}.jpg", quality=90)


def evals_cli_runs(counts, reset_counts, smi) -> dict:
    """Phase 8w (M14): `python -m adaptersis_tpu_torch.evals_cli
    {knn,logreg,linear} --arch vit_large --patch_size 14 --imsize 224
    --batch_size 64 --synthetic` from a seeded `.pth` in
    `dinov2_vitl14_pretrain.pth`'s layout (linear with `--epochs 2`), then
    knn on an image-folder tree (`--dataset imagefolder`: `data/loaders.py`,
    `data/imagenet.py`). Each run extracts 256 train and 256 val images (the
    tree 128 each) on the card; its launches must be `EVAL_PER_FORWARD` per
    forward, every K3 on the 3×TF32 kernel; accuracies in [0, 1]. Prints
    the extraction img/s per split beside each split's loader alone (the
    CLI's `build_loader`, iterated without the model), the launches per
    forward by kind and the peak memory; then the forward alone
    (`extraction_forward`).
    Returns the runs and the `.pth`'s path."""
    from adaptersis_tpu_torch import evals_cli
    work = ROOT / "build" / "smoke_evals"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    pth = work / "dinov2_vitl14_pretrain.pth"
    torch.save(dinov2_vitl14_state_dict(), pth)
    write_folder_tree(work / "tree")
    setup_s = time.perf_counter() - t0
    base = ["--arch", "vit_large", "--patch_size", "14", "--imsize", str(EVAL_IMSIZE),
            "--batch_size", str(EVAL_BATCH), "--pretrained_weights", str(pth)]
    runs = [(mode, [mode, *base, "--synthetic", "--epochs", str(EVAL_EPOCHS)],
             EVAL_FORWARDS[mode], 4 * EVAL_BATCH) for mode in ("knn", "logreg", "linear")]
    # 128 train images a split: k up to 100
    runs.append(("knn imagefolder", ["knn", *base, "--dataset", "imagefolder", "--data_path",
                                     str(work / "tree"), "--nb_knn", "10", "20", "100"],
                 4, 2 * EVAL_BATCH))
    out = {}
    for name, argv, forwards, images in runs:
        # the split's loader alone, no card: its img/s is the most the
        # extraction can reach if the loader sets the pace
        loader_rate = {}
        for split in ("train", "val"):
            t = time.perf_counter()
            n = sum(len(b[0]) for b in evals_cli.build_loader(
                evals_cli.get_args_parser().parse_args(argv), split))
            loader_rate[split] = n / (time.perf_counter() - t)
        reset_counts()
        t = time.perf_counter()
        res = evals_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        got, by_kernel = counts(), path_counts()
        accs = list(res["accuracy"].values())
        out[name] = {"seconds": seconds, "extract_img_per_s": res["extract_img_per_s"],
                     "loader_alone_img_per_s": loader_rate,
                     "peak_mem_bytes": res.get("peak_mem_bytes"), "launches": got,
                     "forwards": forwards,
                     "per_forward": {k: v / forwards for k, v in got.items()},
                     "by_kernel": by_kernel, "num_classes": res["num_classes"],
                     "best": res.get("best"),
                     "accuracy": res["accuracy"] if name != "linear" else
                     {"best": res["accuracy"][res["best"]], "heads": len(accs)}}
        say("evals_cli", run=name, argv=argv, setup_s=setup_s, **out[name],
            nvidia_smi=smi[0] if smi else "unavailable")
        if (res["train_images"], res["val_images"]) != (images, images):
            fail(f"8w {name}: extracted {res['train_images']} / {res['val_images']} images")
        if not accs or not all(0.0 <= a <= 1.0 for a in accs):
            fail(f"8w {name}: accuracies {res['accuracy']}")
        if got != expect_eval(forwards):
            fail(f"8w {name}: launches {got}, expected {EVAL_PER_FORWARD} per forward × "
                 f"{forwards}")
        if by_kernel != paths_expected("tf32x3", got):
            fail(f"8w {name}: K3's launches by kernel {by_kernel}")
        torch.cuda.empty_cache()
    out["forward"] = extraction_forward(pth)
    say("evals_forward", **out["forward"], nvidia_smi=smi[0] if smi else "unavailable")
    return {"runs": out, "pth": pth}


def extraction_forward(pth: Path, top: int = 12) -> dict:
    """8w's extraction forward alone, on one seeded uint8 batch of 64 on the
    card: ms per forward (CUDA events around 5 forwards after 2 warm-ups)
    and img/s, then the device time of 2 forwards by kernel name from
    torch.profiler's trace (the `top` largest, and the total)."""
    from adaptersis_tpu_torch import hub
    from adaptersis_tpu_torch.evals import ModelWithIntermediateLayers
    fm = ModelWithIntermediateLayers(hub.build_model_for_eval("vit_large", str(pth)), 4)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (EVAL_BATCH, EVAL_IMSIZE, EVAL_IMSIZE, 3), np.uint8)).cuda()

    def forward():
        return fm(x.float() / 255.0)

    ms = cuda_ms(forward, iters=5, warmup=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 2e3
    del fm, x
    torch.cuda.empty_cache()
    return {"ms": ms, "img_per_s": EVAL_BATCH / ms * 1e3,
            "device_ms_profiled": sum(by_name.values()),
            "by_kernel_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}


def knn_scale_run(smi) -> dict:
    """Phase 8x (M14): `eval_knn` at ImageNet-1k's sizes on seeded random
    features on the card (N = 1,281,167 train rows of D = 1024, M = 50,000
    test rows, 1000 classes, k ∈ {10, 20, 100, 200}, test chunks of 1024):
    seconds per k and the peak memory beside the features' bytes and one
    chunk's (chunk, N) similarities; then one C of `logreg_sweep` (100,000
    × 1024, 1000 classes, 100 L-BFGS iterations). TF32 is off: fp32
    products on the CUDA cores, as the JAX package's."""
    from adaptersis_tpu_torch.evals import logreg_sweep
    from adaptersis_tpu_torch.evals.knn import eval_knn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    train = torch.randn(KNN_TRAIN, KNN_DIM, device=dev, generator=gen)
    train_y = torch.randint(0, KNN_CLASSES, (KNN_TRAIN,), device=dev, generator=gen)
    test = torch.randn(KNN_TEST, KNN_DIM, device=dev, generator=gen)
    test_y = torch.randint(0, KNN_CLASSES, (KNN_TEST,), device=dev, generator=gen)
    data_bytes = torch.cuda.memory_allocated() - base
    accs, seconds = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for k in KNN_KS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        accs.update(eval_knn(train, train_y, test, test_y, KNN_CLASSES, nb_knn=(k,)))
        torch.cuda.synchronize()
        seconds[k] = time.perf_counter() - t
    knn = {"accuracy": accs, "seconds": seconds, "features_bytes": data_bytes,
           "chunk_similarity_bytes": 1024 * KNN_TRAIN * 4,
           "peak_mem_bytes": torch.cuda.max_memory_allocated() - base}
    del train, train_y, test, test_y
    torch.cuda.empty_cache()
    f = torch.randn(LOGREG_TRAIN, KNN_DIM, device=dev, generator=gen)
    y = torch.randint(0, KNN_CLASSES, (LOGREG_TRAIN,), device=dev, generator=gen)
    vf = torch.randn(LOGREG_VAL, KNN_DIM, device=dev, generator=gen)
    vy = torch.randint(0, KNN_CLASSES, (LOGREG_VAL,), device=dev, generator=gen)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    best, lr_accs = logreg_sweep(f, y, vf, vy, KNN_CLASSES, Cs=(1.0,))
    torch.cuda.synchronize()
    logreg = {"C": best, "accuracy": lr_accs[best], "seconds": time.perf_counter() - t,
              "peak_mem_bytes": torch.cuda.max_memory_allocated() - base}
    del f, y, vf, vy
    torch.cuda.empty_cache()
    say("knn_scale", train=KNN_TRAIN, test=KNN_TEST, dim=KNN_DIM, classes=KNN_CLASSES,
        knn=knn, logreg=logreg, nvidia_smi=smi[0] if smi else "unavailable")
    if not all(0.0 <= a <= 1.0 for a in accs.values()) or len(accs) != len(KNN_KS):
        fail(f"8x: k-NN accuracies {accs}")
    if not 0.0 <= logreg["accuracy"] <= 1.0:
        fail(f"8x: logreg accuracy {logreg}")
    return {"knn": knn, "logreg": logreg}


def depther_run(counts, reset_counts, smi, pth: Path) -> dict:
    """Phase 8y (M14): `DepthEncoderDecoder` at ViT-L/14 width (fp32,
    exact GELU, the `.pth` of 8w) with the linear (256 bins) and the DPT
    head, batch 4 at 420 × 560 (30 × 40 patches), 3 SGD steps on the head
    (the backbone under no_grad): finite losses, every head parameter
    moved, the backbone unchanged, `EVAL_PER_FORWARD` launches a step, the
    step's seconds and peak memory. The linear head's steps run under
    `profile_trace`, whose trace must hold the card's kernels."""
    from adaptersis_tpu_torch.models.depther import DepthEncoderDecoder
    from adaptersis_tpu_torch.models.vit import build_backbone
    from adaptersis_tpu_torch.train.convert import load_dinov2_backbone
    from adaptersis_tpu_torch.utils.logging import profile_trace
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    H, W = DEPTH_HW
    x = torch.rand(DEPTH_BATCH, H, W, 3, generator=gen).to(dev)
    target = (0.5 + 4.5 * torch.rand(DEPTH_BATCH, H, W, generator=gen)).to(dev)
    target[:, :8] = 0.0                                   # invalid rows
    backbone = build_backbone("vit_large", img_size=518, patch_size=14)
    load_dinov2_backbone(backbone, pth)
    backbone = backbone.to(dev).eval()
    frozen = {k: v.clone() for k, v in backbone.state_dict().items()}
    trace_dir = ROOT / "build" / "smoke_evals" / "trace"
    out = {}
    for head in ("linear", "dpt"):
        torch.manual_seed(0)
        model = DepthEncoderDecoder(backbone, head=head).to(dev).train()
        start = {k: v.detach().clone() for k, v in model.decode_head.named_parameters()}
        opt = torch.optim.SGD(model.decode_head.parameters(), lr=1e-3, momentum=0.9)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        reset_counts()
        with profile_trace(str(trace_dir), enabled=head == "linear"):
            for _ in range(DEPTH_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                pred = model(x)
                loss = model.loss(pred, target)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                step_s.append(time.perf_counter() - t)
        got = counts()
        moved = [k for k, p in model.decode_head.named_parameters()
                 if not torch.equal(p.detach(), start[k])]
        out[head] = {"losses": losses, "step_s": step_s, "launches": got,
                     "per_step": {k: v / DEPTH_STEPS for k, v in got.items()},
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "pred_shape": list(pred.shape), "head_params_moved": len(moved),
                     "head_params": len(start)}
        if head == "linear":
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            kernels = 0
            if traces:
                events = json.loads(traces[-1].read_text()).get("traceEvents", [])
                kernels = sum(1 for e in events if e.get("cat") == "kernel")
            out[head]["trace"] = {"files": len(traces), "kernel_events": kernels}
        say("depther", head=head, batch=DEPTH_BATCH, hw=list(DEPTH_HW), **out[head],
            nvidia_smi=smi[0] if smi else "unavailable")
        if pred.shape != (DEPTH_BATCH, H, W, 1) or not all(math.isfinite(v) for v in losses):
            fail(f"8y {head}: prediction {tuple(pred.shape)}, losses {losses}")
        if len(moved) != len(start):
            fail(f"8y {head}: {len(start) - len(moved)} head parameters did not move")
        if got != expect_eval(DEPTH_STEPS):
            fail(f"8y {head}: launches {got}, expected {EVAL_PER_FORWARD} per step")
        if head == "linear" and not out[head]["trace"]["kernel_events"]:
            fail(f"8y: profile_trace wrote no kernel events: {out[head]['trace']}")
        del model, opt, pred, loss
        torch.cuda.empty_cache()
    if any(not torch.equal(v, frozen[k]) for k, v in backbone.state_dict().items()):
        fail("8y: the frozen backbone changed")
    return out


def eval_kernel_checks(ff, ln, fq, fm) -> dict:
    """Phases 2e and 4g (M14): K3, and K6 and K4 (no K5: exact GELU), at
    evals_cli's 257 tokens, batch 2 and 64, and the depther's 1201 tokens,
    batch 4 (`EVAL_FLASH_SHAPES`, `EVAL_ROW_SHAPES`), bf16 and fp32, each element
    within its bound, with the planted faults and repeats of phases 2 and
    4b (`check_k3`, `check_row_kernels`). Returns the largest bf16 errors."""
    err = {"flash_fwd": check_k3(ff, EVAL_FLASH_SHAPES)}
    err.update(check_row_kernels(ln, fq, fm, EVAL_ROW_SHAPES, HEADS, k5=False))
    del err["fused_ln_mlp"]
    torch.cuda.empty_cache()
    return err


def entry_kernel_checks(ff, mc, ln, fq, fm, fa) -> dict:
    """Phases 2f, 3d, 4h and 4i, each element within its bound, with
    the planted faults and five bit-identical repeats of phases 2-4c, in
    bf16 and fp32: K3 at the eval scripts' ViT-S/14 walks and vit_tiny's
    3 heads (`VITS_FLASH_SHAPES`); K1 and K2 at vit_tiny's adapters, D =
    24, on uniform, model-like and hot-token points (`TINY_MSDA_CASES`); K6,
    K4 and K5 at C = 384, H = 6 (`VITS_ROW_SHAPES`); K7 at
    eval_dinov2_setr_cross_ete's (16, 6, 257, 64), no ids, forward and
    backward (`VITS_K7_CASE`). Returns the largest errors by kernel."""
    err = {"flash_fwd": check_k3(ff, VITS_FLASH_SHAPES, by_dtype=True),
           "msda_fwd": check_msda_fwd(mc, TINY_MSDA_CASES, TINY_MSDA_POINTS),
           "msda_bwd": check_msda_bwd(mc, TINY_MSDA_CASES, TINY_MSDA_POINTS),
           "rows": check_row_kernels(ln, fq, fm, VITS_ROW_SHAPES, VITS_HEADS),
           "flash_attn": check_k7(fa, [(VITS_K7_CASE, VITS_K7_SHAPE, None, 0.125)])}
    torch.cuda.empty_cache()
    return err


# the hand-written kernels by the names torch.profiler records for them
# (CUPTI's demangled names): K4 is the GEMM's qkv epilogue, K5 its GELU and
# residual epilogues; K2 is four kernels, of which the point pass and the dV
# sum take the time; K6's kernel also runs as K4's and K5's LayerNorm pass in
# bf16 (`ops/layernorm.py:ln_input`), so it runs in bench_m2f's step too,
# whose frozen walk calls no K6 of its own (`M2F_BENCH_STEP`)
PROFILE_NAMES = {"msda_fwd": ("msda_fwd_kernel",), "msda_bwd": ("point_kernel", "sum_kernel"),
                 "flash_fwd": ("flash_fwd_wgmma_kernel",),
                 "fused_ln_qkv": ("gemm_wgmma_kernel<0>",),
                 "fused_ln_mlp": ("gemm_wgmma_kernel<1>", "gemm_wgmma_kernel<2>"),
                 "layernorm": ("layernorm_kernel",)}


def check_profile(module: str, printed: str, result: dict, smi, top: int = 15) -> dict:
    """Phases 8b and 8o: a bench's `--profile` output (its JSON line, then
    `train_seg.profile_table`) must hold the JSON line it returned and a
    device table that names every kernel of `PROFILE_NAMES`; prints the
    table's first `top` device rows."""
    lines = printed.splitlines()
    rows = [x for x in lines if " ms/step " in x and " calls  " in x]
    busy = next((x for x in lines if x.startswith("device activity ")), None)
    named = {k: {n: [" ".join(r.split()[:5]) for r in rows if n in r] for n in names}
             for k, names in PROFILE_NAMES.items()}
    missing = [n for k in named for n, found in named[k].items() if not found]
    res = {"device_activity": busy, "device_rows": len(rows), "top_rows": rows[:top],
           "kernels": named, "missing": missing, "nvidia_smi": smi[0] if smi else "unavailable"}
    say("profile", module=module, **res)
    if not lines or json.loads(lines[0]) != json.loads(json.dumps(result)):
        fail(f"{module} --profile: its first line is not its result: {lines[:1]}")
    if busy is None or missing:
        fail(f"{module} --profile: the device table lacks {missing} (activity: {busy})")
    return res


def launch_counters():
    """(counts, reset_counts): read and zero every kernel wrapper's launch
    count (and K3's counts by kernel, `path_counts`)."""
    from adaptersis_tpu_torch.ops import flash_attn as fa, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.ops import fused_mlp as fm, fused_qkv as fq, layernorm as ln

    def reset_counts():
        ff.launches = mc.launches = mc.bwd_launches = fq.launches = fm.launches = 0
        ln.launches = fa.launches = fa.bwd_launches = 0
        ff.path_launches.update(dict.fromkeys(ff.path_launches, 0))

    def counts():
        return {"flash_fwd": ff.launches, "msda_fwd": mc.launches, "msda_bwd": mc.bwd_launches,
                "fused_ln_qkv": fq.launches, "fused_ln_mlp": fm.launches,
                "layernorm": ln.launches, "flash_attn": fa.launches,
                "flash_attn_bwd": fa.bwd_launches}

    return counts, reset_counts


def path_counts() -> dict:
    """K3's launches since the last reset by the kernel `asis_flash_fwd`
    reported launching: "wgmma" (bf16), "tf32x3" (fp32, 3×TF32 on the
    tensor cores), "cuda_cores" (Dh 16, 32). K4's and K5's launcher has one
    kernel per dtype (fp32: the 3×TF32 `gemm_tf32_kernel`), so their
    launches in a run of one dtype all took that dtype's kernel."""
    from adaptersis_tpu_torch.ops import flash_fwd as ff
    return dict(ff.path_launches)


def paths_expected(path: str, launches: dict) -> dict:
    """`path_counts` when every K3 launch in `launches` (`counts`) ran the
    tensor-core kernel of one dtype, `path` ("tf32x3" in fp32, "wgmma" in
    bf16): none on the CUDA cores."""
    return {k: launches["flash_fwd"] if k == path else 0 for k in path_counts()}


def expect(forwards, backwards, per=PER_FORWARD):
    """Launches of `forwards` full-width forwards (`per`: ViT-L's, or
    G_PER_FORWARD) and `backwards` MSDA backwards (the segmentation paths
    run no K7)."""
    return {**{k: v * forwards for k, v in per.items()}, "msda_bwd": backwards,
            "flash_attn": 0, "flash_attn_bwd": 0}


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

    counts, reset_counts = launch_counters()

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
    # phase 8zb's raw trees and converters, on the host from now on
    datasets = start_datasets()

    # ---- 2. K3 (forward-only attention) vs its plain version, per element
    # (`check_k3`)
    flash_err = check_k3(ff)

    # ---- 2b. K3 at tap_unet_fuse's extra walks (N = 3970 and 442)
    fuse_k3_err = check_k3(ff, FUSE_K3_SHAPES)

    # ---- 2c. K3 at ViT-g/14's 24 heads
    vitg_err = {"flash_fwd": check_k3(ff, G_FLASH_SHAPES)}

    # ---- 2d. K3 at the m2f walk's 1370 tokens (M12)
    m2f_err = {"flash_fwd": check_k3(ff, M2F_FLASH_SHAPES)}

    # ---- 3. K1 (deformable attention forward) vs its plain version, per
    # element (`check_msda_fwd`)
    msda_err = check_msda_fwd(mc)
    # 3b. at ViT-g/14's adapters: D = 192, bf16 and fp32
    vitg_err["msda_fwd"] = check_msda_fwd(mc, G_MSDA_CASES, G_MSDA_POINTS)
    # 3c. at the m2f geometries (M12): the pixel decoder's D = 32 over 3
    # levels with Lq = S = 5313, ViTAdapter's injector and extractor at 518
    # px (D = 128, and 48 under vit_small), bf16 and fp32, batch 2
    m2f_err["msda_fwd"] = check_msda_fwd(mc, m2f_msda_cases(FULL_BATCH), M2F_MSDA_POINTS)

    # ---- 4. K2 (deformable attention backward) vs the plain version's
    # autograd, per element (`check_msda_bwd`)
    bwd_err = check_msda_bwd(mc)
    # 4a. at ViT-g/14's adapters: D = 192 (K2's two-pass sum), bf16 and fp32
    vitg_err["msda_bwd"] = check_msda_bwd(mc, G_MSDA_CASES, G_MSDA_POINTS)
    # 4f. at the m2f geometries (M12)
    m2f_err["msda_bwd"] = check_msda_bwd(mc, m2f_msda_cases(FULL_BATCH), M2F_MSDA_POINTS)

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
    row_err = check_row_kernels(ln, fq, fm)
    # ViT-g/14's C = 1536, 24 heads (no K5: SwiGLU), and vit_tiny's C = 192,
    # 3 heads
    vitg_err["rows"] = check_row_kernels(ln, fq, fm, G_ROW_SHAPES, G_HEADS, k5=False)
    vitg_err["vit_tiny rows"] = check_row_kernels(ln, fq, fm, TINY_ROW_SHAPES, TINY_HEADS)
    # the m2f walk's 1370 rows (M12)
    m2f_err["rows"] = check_row_kernels(ln, fq, fm, M2F_ROW_SHAPES, HEADS)
    torch.cuda.empty_cache()

    # ---- 4c. K7 (flash attention with segment ids) vs its plain version
    # (`check_k7`)
    k7_err = check_k7(fa)

    # ---- 4d. K7 at tap_setr_ete's geometry: one 1765-token segment, no ids
    ete_k7_err = check_k7(fa, [(ETE_CASE, ETE_SHAPE, None, 0.125)])

    # ---- 4e. K7 at ViT-g/14's SSL step: 24 heads
    vitg_err["flash_attn"] = check_k7(fa, [
        (case, shape, packed_ids(shape[0], STUDENT_SEGMENTS) if case.endswith("student")
         else None, 0.125) for case, shape in G_K7_SHAPES.items()])

    # ---- 2e, 4g. K3, and K6 and K4, at evals_cli's 257 tokens and the
    # depther's 1201 (M14)
    eval_err = eval_kernel_checks(ff, ln, fq, fm)

    # ---- 2f, 3d, 4h, 4i. K3, K1, K2, K6, K4, K5 and K7 at the eval scripts'
    # ViT-S/14 shapes and vit_tiny's adapters (`entry_kernel_checks`)
    entry_err = entry_kernel_checks(ff, mc, ln, fq, fm, fa)

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
        metric_err=metric_err, launches=small_launches, by_kernel=path_counts())
    if not err <= bound:
        fail(f"small slice: CUDA logits differ from CPU by {err} > {bound}")
    if not metric_err <= 1e-4 * max(1.0, float(cpu["loss"])):
        fail(f"small slice: CUDA metrics differ from CPU by {metric_err}")
    small_expect = {"flash_fwd": 10, "msda_fwd": 7, "msda_bwd": 0, "fused_ln_qkv": 10,
                    "fused_ln_mlp": 10, "layernorm": 4, "flash_attn": 0, "flash_attn_bwd": 0}
    if small_launches != small_expect:
        fail(f"small slice: kernel launches {small_launches}, expected {small_expect}")
    # fp32 at Dh 64: every K3, K4 and K5 launch on the 3×TF32 kernels
    if path_counts() != paths_expected("tf32x3", small_launches):
        fail(f"small slice: launches by kernel {path_counts()}")
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
    train_small_paths = path_counts()
    param_err = max((p.detach().cpu() - named["cpu"][n].detach()).abs().max().item()
                    / (1.0 + named["cpu"][n].detach().abs().max().item())
                    for n, p in named["cuda"].items())
    say("small_train_step", steps=len(batches), augment_vs_cpu=aug_diff,
        steps_report=step_report,
        grad_max_rel_err=grad_rel, grads_compared=n_grads, grad_worst=grad_errs[:3],
        param_err_after_2_steps=param_err,
        launches=train_small_launches, by_kernel=train_small_paths)
    if not param_err <= 1e-5:           # two lr·momentum updates of the gradients above
        fail(f"narrow train step: parameters differ by {param_err} after 2 steps")
    if train_small_launches != {k: 2 * (7 if k == "msda_bwd" else v)
                                for k, v in small_expect.items()}:
        fail(f"narrow train step: launches {train_small_launches}, expected {small_expect} "
             "and 7 MSDA backwards per step")
    if train_small_paths != paths_expected("tf32x3", train_small_launches):
        fail(f"narrow train step: launches by kernel {train_small_paths}")
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
    phase8_img_s = epoch["train_img_per_s"]
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
    for mod, backwards, argv in ((bench, 7, ["--profile"]), (bench_infer, 0, [])):
        reset_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = mod.main(argv)
        got = counts()
        # the defaults: 2 warm-up steps, 3 windows of 10, and 3 profiled steps
        n = 2 + 3 * 10 + (3 if argv else 0)
        entry[mod.__name__.rsplit(".", 1)[-1]] = (res, got)
        say("entry_point", module=mod.__name__, argv=argv, result=res, launches=got,
            per_step={k: v / n for k, v in got.items()})
        if argv:
            check_profile(mod.__name__, printed.getvalue(), res, smi)
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

    # ---- 8d. the SSL step at full width, K7 against its plain version
    # (`ssl_step_gate`)
    ssl_step_gate(fa, counts, reset_counts)

    # ---- 8e. the ViT-L train step at full width, K1-K6 against their plain
    # versions, on two seeds (`seg_step_gate`)
    for seed in (0, 1):
        seg_step_gate(counts, reset_counts, expect(1, 7), seed=seed)

    # ---- 8f. train.py's real-data run at full width: a Robust-MIS tree and a
    # DINOv2 .pth; checkpoint, resume, --evaluate (`real_data_run`)
    real_data_run(counts, reset_counts, smi)

    # ---- 8g. the SSL checkpoint and resume at full width (`ssl_resume_run`)
    ssl_resume_run(counts, reset_counts, expect_ssl, smi)

    # ---- 8h. the other models and decoders at the paper's width,
    # VARIANT_DEPTH ViT-L blocks (`variant_runs`)
    variant_runs(counts, reset_counts, smi)

    # ---- 8i. tap_setr_ete's train step, K7 against its plain version
    # (`ete_step_gate`)
    ete_step_gate(fa, counts, reset_counts)

    with arch_depth("vit_giant2", G_DEPTH):
        # ---- 8j. ViT-g/14 through train_seg at full width (the config file
        # selects it), then its train step gate at batch 2 (M2b)
        vitg_run = variant_runs(counts, reset_counts, smi, runs=G_RUNS, flags=vitg_argv,
                                want=vitg_expect, evaluated=G_RUNS[0][0], phase="8j",
                                arch="vit_giant2", depth=None)
        seg_step_gate(counts, reset_counts, expect(1, 7, G_PER_FORWARD), arch="vit_giant2",
                      batch=G_GATE_BATCH, faults=("heads moved",))

        # ---- 8k. ViT-g/14's SSL step (`vitg_ssl_run`)
        vitg_ssl = vitg_ssl_run(counts, reset_counts, expect_ssl, smi)

        # ---- 8l. the attention-map tool on the card (`attention_map_run`)
        attention_map_run(counts, reset_counts, smi)

    # ---- 8m-8o. segment_m2f and bench_m2f at ViT-L/14 width (`m2f_entry_runs`)
    m2f_run = m2f_entry_runs(counts, reset_counts, smi)

    # ---- 8p. the m2f train step, K1-K5 against their plain versions
    # (`m2f_step_gate`)
    m2f_step_gate(counts, reset_counts)

    # ---- 8q. the DETR stack's deformable decoder, K1/K2 against the plain
    # MSDA on the card (`detr_decoder_check`)
    detr_decoder_check(counts, reset_counts)

    # ---- 8r. the ViT-L train step in fp32 (train_seg's default precision),
    # K1-K4 and K6 against their plain versions, on two seeds (M9's fp32
    # half: `seg_step_gate` with fp32)
    for seed in (0, 1):
        seg_step_gate(counts, reset_counts, expect(1, 7, PER_FORWARD_FP32), seed=seed,
                      batch=FP32_GATE_BATCH, faults=("heads moved",), fp32=True)

    # ---- 8s. train_seg at train.py's own example precision, ViT-L/14 at
    # 588 px, batch 12 (`variant_runs` with FP32_RUNS)
    fp32_run = variant_runs(counts, reset_counts, smi, runs=FP32_RUNS, flags=fp32_argv,
                            want=partial(variant_expect, depth=24),
                            evaluated=FP32_RUNS[0][0], phase="8s",
                            depth=None, batch=FP32_TRAIN_BATCH)

    # ---- 8t. train_seg under torchrun at W = 1 over NCCL, saved and resumed
    # (`torchrun_train_seg`, M10)
    torchrun_train_seg(counts, reset_counts, smi, phase8_img_s)

    # ---- 8u. the adapter step at two gloo ranks on the card against one
    # process at the global batch, --fsdp 1 and 2 (`gloo_seg_check`)
    gloo_seg_check(counts, reset_counts)

    # ---- 8v. pretrain under torchrun at W = 1 over NCCL, then the SSL step at
    # two gloo ranks against one process (`torchrun_pretrain`,
    # `gloo_ssl_check`, M13)
    torchrun_pretrain(expect_ssl, smi)
    gloo_ssl_check(counts, reset_counts, expect_ssl)

    # ---- 8w-8y. the frozen-feature evals at ViT-L/14 (M14): evals_cli's
    # three modes, k-NN and logreg at ImageNet's sizes, the depther
    evals_run = evals_cli_runs(counts, reset_counts, smi)
    knn_scale_run(smi)
    depther_run(counts, reset_counts, smi, evals_run["pth"])

    # ---- 8z. train_multi_class, the 8-class EndoVis 2017 recipe, at full
    # width on a fabricated tree (`multi_class_run`)
    multi_class_run(counts, reset_counts, smi)

    # ---- 8za-8zc. the eval scripts' entry points at ViT-S/14, three datasets
    # from their raw release layouts to training, vit_tiny trained
    entry_run = eval_entry_runs(counts, reset_counts, smi)
    dataset_runs(counts, reset_counts, smi, datasets)
    tiny_run = tiny_runs(counts, reset_counts, smi)

    # ---- 9. kernel vs plain (and library) time at the main-path shapes
    # (`kernel_times`)
    times, bounds, extra, dev, host = kernel_times(ff, mc, fq, fm, ln, fa)
    say_times(name, smi, times, bounds, extra, dev, host)
    say("variant_geometries", k3_unet_fuse_max_abs_err=fuse_k3_err,
        k7_setr_ete_max_abs_err=ete_k7_err, vitg_and_vit_tiny_max_abs_err=vitg_err,
        m2f_max_abs_err=m2f_err, eval_max_abs_err=eval_err, entry_max_abs_err=entry_err,
        device=name,
        nvidia_smi=smi[0] if smi else "unavailable")

    def on_path(key, prefix):
        return (key.startswith(prefix) and f"B={TRAIN_BATCH}" in key
                and not key.endswith((" model", " hot token")))

    def mean(prefix, i, table=times):
        vals = [v[i] for k, v in table.items() if on_path(k, prefix)]
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
                     "bound_by": b_by, "library_ms": mean(kname, 2),
                     "device_ms": mean(kname, 0, dev)})
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
                     "bound_by": bounds[keys[0]][1], "library_ms": avg[2],
                     "device_ms": sum(dev[k][0] for k in keys) / len(keys)})
    # beside each row, its numbers at this slice's new shapes (batch 16, bf16;
    # phase 9's "vitg ..." and "vit_tiny ..." keys) and the launches of
    # ViT-g's train step (8j) and SSL step (8k)
    vitg_step = vitg_run["vitg adapter"]["per_train_step"]
    labels = {"flash_fwd": ["vitg"], "msda_fwd": ["vitg"], "msda_bwd": ["vitg"],
              "fused_ln_qkv": ["vitg", "vit_tiny"], "fused_ln_mlp": ["vit_tiny"],
              "layernorm": ["vitg", "vit_tiny"]}
    k7_keys = {"flash_attn": ["vitg flash_attn student", "vitg flash_attn teacher"],
               "flash_attn_bwd": ["vitg flash_attn_bwd student"]}
    rows_err = entry_err["rows"]
    vits_err = {"flash_fwd": entry_err["flash_fwd"], "msda_fwd": entry_err["msda_fwd"],
                "msda_bwd": entry_err["msda_bwd"],
                **{k: {"bfloat16": rows_err[k], "float32": rows_err[f"{k} fp32"]}
                   for k in ("layernorm", "fused_ln_qkv", "fused_ln_mlp")},
                **{k: {"bfloat16": entry_err["flash_attn"][d],
                       "float32": entry_err["flash_attn"][f"{d} fp32"]}
                   for k, d in (("flash_attn", "fwd"), ("flash_attn_bwd", "bwd"))}}
    for row in rows:
        kname = row["name"]
        groups = ({"vitg": k7_keys[kname]} if kname in k7_keys else
                  {lab: [k for k in times if k.startswith(f"{lab} ")
                         and on_path(k[len(lab) + 1:], kname)] for lab in labels[kname]})
        row["new_shapes"] = {}
        for label, keys in groups.items():
            lib = [times[k][2] for k in keys]
            row["new_shapes"][label] = {
                "ms": sum(times[k][0] for k in keys) / len(keys),
                "plain_ms": sum(times[k][1] for k in keys) / len(keys),
                "bound_ms": sum(bounds[k][0] for k in keys) / len(keys),
                "bound_by": bounds[keys[0]][1],
                "library_ms": None if None in lib else sum(lib) / len(lib),
                "device_ms": sum(dev[k][0] for k in keys) / len(keys), "keys": keys}
        row["launches_vitg_step"] = (vitg_ssl["launches"][kname] // 2
                                     if kname.startswith("flash_attn") else vitg_step[kname])
        # M12: each timed key of phase 9 at the m2f shapes (batch 4) and the
        # launches per step of bench_m2f (bf16) and segment_m2f (fp32)
        row["m2f_shapes"] = {
            k: {"ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": times[k][2], "device_ms": dev[k][0],
                **{e: extra[k][e] for e in ("l2_tb_per_s", "tflops_device",
                                         "bound_fp32_cuda_cores")
                   if e in extra.get(k, {})}}
            for k in times if k.startswith("m2f ") and kname in k.split()}
        row["launches_m2f_step"] = {
            "bench_m2f": m2f_run["bench_m2f"]["per_step"][kname],
            "segment_m2f": m2f_run["segment_m2f vit_large fp32"]["per_train_step"][0][kname]}
        # the fp32 kernels at train_seg's batch 16 ("fp32 ..." keys), each
        # bound that of 3×TF32 with the CUDA cores' fp32 bound beside it,
        # and the launches per step of 8s (train_seg in fp32, batch 12)
        row["fp32_shapes"] = {
            k: {"ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": times[k][2], "device_ms": dev[k][0],
                **{e: extra[k][e] for e in ("bound_fp32_cuda_cores", "cublas_gemm", "unfused",
                                            "tflops_device") if e in extra.get(k, {})}}
            for k in times if k.startswith("fp32 ") and kname in k.split()}
        row["launches_fp32_step"] = fp32_run["train_seg fp32"]["per_train_step"][kname]
        # M14: the fp32 kernels at evals_cli's batch 64, 257 tokens ("eval ..."
        # keys), and the launches per extraction forward of 8w's knn run
        row["eval_shapes"] = {
            k: {"ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": times[k][2], "device_ms": dev[k][0],
                **{e: extra[k][e] for e in ("bound_fp32_cuda_cores", "cublas_gemm", "unfused",
                                            "tflops_device") if e in extra.get(k, {})}}
            for k in times if k.startswith("eval ") and kname in k.split()}
        row["launches_eval_forward"] = evals_run["runs"]["knn"]["per_forward"][kname]
        # each timed key of phase 9 at the eval scripts' ViT-S/14 and
        # vit_tiny's shapes (batch 16, "vits ..." and "vit_tiny adapter ..."
        # keys), the largest errors of phases 2f-4i by dtype, and the
        # launches per train step of each run of 8za and 8zc
        row["vits_shapes"] = {
            k: {"ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": times[k][2], "device_ms": dev[k][0],
                **{e: extra[k][e] for e in ("bound_fp32_cuda_cores", "cublas_gemm", "unfused",
                                            "tflops_device", "l2_tb_per_s")
                   if e in extra.get(k, {})}}
            for k in times if k.startswith(("vits ", "vit_tiny adapter ")) and kname in k.split()}
        row["vits_max_abs_err"] = vits_err[kname]
        row["launches_vits_step"] = {n: r["per_train_step"][kname]
                                     for n, r in {**entry_run, **tiny_run}.items()
                                     if n != "evaluate"}
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def times_only() -> None:
    """`--times`: the build and phase 9 alone, plus `row_hashes` and
    `k3_hashes`, with no checks: to compare two trees' kernels in one call
    on one card."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build, flash_attn as fa, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.ops import fused_mlp as fm, fused_qkv as fq, layernorm as ln
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=name, root=str(ROOT), nvidia_smi=smi[0] if smi else "unavailable",
        torch=torch.__version__, cuda=torch.version.cuda, build_s=time.perf_counter() - t0)
    say("row_hashes", **row_hashes(ln))
    say("k3_hashes", **k3_hashes(ff))
    say_times(name, smi, *kernel_times(ff, mc, fq, fm, ln, fa))


def data_parallel_only() -> None:
    """`--data-parallel`: the build and phases 8t-8v alone (8t without phase
    8's img/s beside its own)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi[0] if smi else
        "unavailable", torch=torch.__version__, cuda=torch.version.cuda,
        build_s=time.perf_counter() - t0)
    counts, reset_counts = launch_counters()

    def expect_ssl(steps):
        return {**{k: 0 for k in counts()}, **{k: v * steps for k, v in SSL_PER_STEP.items()}}

    torchrun_train_seg(counts, reset_counts, smi, None)
    gloo_seg_check(counts, reset_counts)
    torchrun_pretrain(expect_ssl, smi)
    gloo_ssl_check(counts, reset_counts, expect_ssl)


def gate_only() -> None:
    """`--gate`: the build, phase 8e (seed 0 with `SEG_GATE_PROBES`, then
    seed 1) and `seg_gate_ablation`: to measure the gate's floor, or to run
    the gate on another tree's kernels (copy this script into its root; it
    reads K3's counts by kernel, `path_counts`)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=torch.cuda.get_device_name(0), root=str(ROOT),
        nvidia_smi=smi[0] if smi else "unavailable", build_s=time.perf_counter() - t0)
    counters = launch_counters()
    seg_step_gate(*counters, expect(1, 7), probes=SEG_GATE_PROBES)
    seg_step_gate(*counters, expect(1, 7), seed=1)
    seg_gate_ablation(*counters)


def evals_only() -> None:
    """`--evals`: the build, phases 2e and 4g (K3, K6 and K4 at evals_cli's
    257 tokens and the depther's 1201 against their plain versions), 8w-8y (evals_cli's three
    modes at ViT-L/14, k-NN and logreg at ImageNet's sizes, the depther)
    and phase 9's "eval ..." keys, with the card's name and power limit."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build, flash_attn as fa, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.ops import fused_mlp as fm, fused_qkv as fq, layernorm as ln
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=name, root=str(ROOT), nvidia_smi=smi[0] if smi else "unavailable",
        torch=torch.__version__, cuda=torch.version.cuda, build_s=time.perf_counter() - t0)
    counts, reset_counts = launch_counters()
    say("eval_kernels", max_abs_err=eval_kernel_checks(ff, ln, fq, fm))
    run = evals_cli_runs(counts, reset_counts, smi)
    knn_scale_run(smi)
    depther_run(counts, reset_counts, smi, run["pth"])
    say_times(name, smi, *kernel_times(ff, mc, fq, fm, ln, fa, only="eval"))
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)


def entries_only() -> None:
    """`--entries`: the build, phases 2f, 3d, 4h and 4i (K3, K1, K2, K6, K4,
    K5 and K7 at the eval scripts' ViT-S/14 shapes and vit_tiny's adapters
    against their plain versions), 8za-8zc (the six eval_dinov2_* entry
    points, the three datasets from raw release to training, vit_tiny) and
    phase 9's "vits ..." and "vit_tiny adapter ..." keys, with the card's
    name and power limit."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch.ops import _build, flash_attn as fa, flash_fwd as ff, msda_cuda as mc
    from adaptersis_tpu_torch.ops import fused_mlp as fm, fused_qkv as fq, layernorm as ln
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=name, root=str(ROOT), nvidia_smi=smi[0] if smi else "unavailable",
        torch=torch.__version__, cuda=torch.version.cuda, build_s=time.perf_counter() - t0)
    counts, reset_counts = launch_counters()
    datasets = start_datasets()
    say("entry_kernels", max_abs_err=entry_kernel_checks(ff, mc, ln, fq, fm, fa))
    eval_entry_runs(counts, reset_counts, smi)
    dataset_runs(counts, reset_counts, smi, datasets)
    tiny_runs(counts, reset_counts, smi)
    say_times(name, smi, *kernel_times(ff, mc, fq, fm, ln, fa, only="entries"))
    print(smi[0] if smi else f"{name}, power limit unavailable", flush=True)


# `--fp32-steps`: 8s's and 8m's commands whole (train_seg's synthetic epoch
# is 8 steps, segment_m2f's 4, run for FP32_STEP_EPOCHS epochs)
FP32_STEP_EPOCHS = 3


def fp32_steps_only() -> None:
    """`--fp32-steps`: the build, then the user's fp32 steps as phases 8s and
    8m run them, uncut: `train_seg --arch vit_large --patch_size 14 --imsize
    588 --batch_size_per_gpu 12 --lr 0.01 --synthetic` (exact GELU, one
    epoch) and `segment_m2f --arch vit_large --imsize 518
    --batch_size_per_gpu 4 --synthetic` (`FP32_STEP_EPOCHS` epochs), each
    epoch's img/s over its steps after the first, peak memory and the
    launches, failing only on a loss that is not finite: to compare two
    trees' fp32 steps in one call (copy this script into the other tree's
    root). It reads no counter but the wrappers' totals, and keeps
    PyTorch's precision defaults, as the user's command runs (matmuls in
    fp32, cuDNN's convolutions allowed TF32; 8s turns cuDNN's TF32 off)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from adaptersis_tpu_torch import segment_m2f, train_seg
    from adaptersis_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    say("device", name=torch.cuda.get_device_name(0), root=str(ROOT),
        nvidia_smi=smi[0] if smi else "unavailable", build_s=time.perf_counter() - t0)
    counts = launch_counters()[0]
    work = ROOT / "build" / "fp32_steps"
    shutil.rmtree(work, ignore_errors=True)
    runs = (("train_seg fp32", train_seg,
             [*fp32_argv(), "--lr", "0.01", "--synthetic", "--epochs", "1", "--seed", "0"]),
            ("segment_m2f vit_large fp32", segment_m2f,
             ["--arch", "vit_large", "--imsize", "518", "--batch_size_per_gpu", str(M2F_BATCH),
              "--synthetic", "--epochs", str(FP32_STEP_EPOCHS)]))
    for name, entry, argv in runs:
        torch.cuda.reset_peak_memory_stats()
        before, t = counts(), time.perf_counter()
        hist = entry.main([*argv, "--num_workers", "4",
                           "--output_dir", str(work / name.split()[0])])
        after = counts()
        say("fp32_step", name=name, argv=argv, seconds=time.perf_counter() - t,
            img_per_s=[h["train_img_per_s"] for h in hist],
            peak_mem_bytes=[h["peak_mem_bytes"] for h in hist],
            launches={k: after[k] - before[k] for k in after},
            nvidia_smi=smi[0] if smi else "unavailable")
        if not all(math.isfinite(v) for h in hist for v in h["train_losses"]):
            fail(f"{name}: losses not finite")
        del hist
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--times"]:
        times_only()
    elif sys.argv[1:] == ["--gate"]:
        gate_only()
    elif sys.argv[1:] == ["--fp32-steps"]:
        fp32_steps_only()
    elif sys.argv[1:] == ["--data-parallel"]:
        data_parallel_only()
    elif sys.argv[1:] == ["--evals"]:
        evals_only()
    elif sys.argv[1:] == ["--entries"]:
        entries_only()
    elif sys.argv[1:] == ["--datasets-child"]:
        datasets_child()
    elif sys.argv[1:2] == ["--torchrun-child"]:
        torchrun_child(int(sys.argv[2]), sys.argv[3], sys.argv[4:])
    elif sys.argv[1:2] == ["--gloo-child"]:
        gloo_child(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:]:
        fail(f"usage: python3 chip_smoke.py [--times | --gate | --fp32-steps | "
             f"--data-parallel | --evals | --entries], "
             f"got {sys.argv[1:]}")
    else:
        main()
