// GEMMs with fused epilogues after a LayerNorm pass: the frozen ViT
// block's LN → qkv → head split (K4) and LN → fc1 → GELU → fc2 →
// LayerScale → residual (K5, as two GEMMs; the tanh GELU or the exact erf
// one, as the block's MLP declares).
//
// Replaces:
//   * K4: adaptersis_tpu/ops/fused_qkv.py `_kernel` (via `_fwd_impl`);
//   * K5: adaptersis_tpu/ops/fused_mlp.py `_kernel` (via `_fwd_impl`).
//
// Every call computes out = epilogue(A·Wᵀ + bias) for A (M, K) and the torch
// Linear weight W (N, K), both contiguous along K. A is xn = (x − mean)·
// (rstd·ln_w) + ln_b in fp32, rounded to x's dtype, as the TPU kernels
// normalise it; the wrappers pass xn written by layernorm.cu's LayerNorm
// kernel in both dtypes (fc2 takes the hidden as A).
// The products accumulate in fp32, and each output is rounded once:
//   * QKV:   (acc + b) → x's dtype, scattered to q, k, v of (B, H, Ntok, Dh):
//            column j to (j / C, (j mod C) / Dh, j mod Dh), row r to
//            (r / Ntok, r mod Ntok) — K3's input layout, with no relayout;
//   * GELU:  tanh-GELU(acc + b1) in fp32 → x's dtype: K5's hidden (M, 4C);
//   * GELU_ERF: the exact GELU 0.5·h·(1 + erf(h·√½)) of h = acc + b1 in
//            fp32 → x's dtype: K5's hidden for an MLP with exact GELU (the
//            TPU kernel computes only the tanh form; this is its plain
//            `reference_ln_mlp(..., approximate=False)`);
//   * RESID: (x + γ·(acc + b2)) in fp32 → x's dtype: K5's output, from the
//            hidden as A.
// The TPU's K5 kept both weights (16 MB in bf16) resident in VMEM and never
// wrote the hidden; 227 KB of shared memory cannot hold them, and a 128-row
// block of the hidden (1 MB) cannot stay on the chip beside fc2's 128 × 1024
// fp32 accumulator (512 KB, twice the register file), so here the hidden
// makes one round trip through HBM (2 × 231 MB at batch 16).
//
// What bounds it on the H100: at the main path's shapes (M = 16·1765 rows,
// C = 1024) K4 does 177.7 GFLOP on 237.6 MB and K5 473.8 GFLOP on
// 132.4 MB: both are bound by the tensor cores' bf16 rate (0.180 and
// 0.479 ms at 989 TFLOP/s), which only wgmma reaches on this card. So the
// bf16 path is a warp-specialised, persistent wgmma GEMM fed by TMA
// (gemm_wgmma_kernel, below) with no LayerNorm prologue. TMA copies bytes
// as they are, so a prologue has to rewrite each landed A tile before the
// wgmmas read it; each such prologue measured (in shared memory by spare
// warps or by the consumers, or in registers for register-A wgmmas) cost
// the GEMM more than the separate LayerNorm pass it saves (≈ 2 × 57.8 MB
// through HBM at batch 16, ≈ 0.04 ms; PERF.md), so the GEMMs take xn.
//
// fp32 (the default precision of train_seg and segment_m2f): the same
// products held to fp32 accuracy. The CUDA cores' fp32 rate (67 TFLOP/s)
// bounds a CUDA-core GEMM at 2.65 ms for K4 at batch 16; one TF32 pass on
// the tensor cores (495 TFLOP/s) keeps 11 bits of each operand, an error of
// ≈ 2⁻¹², far outside fp32's. So gemm_tf32_kernel runs 3×TF32 (hopper.cuh):
// three tf32 products per k8 step, bound by 3 × the operations at 495
// TFLOP/s (1.08 ms at batch 16, 0.209 ms at the m2f walk's 5480 rows). Its
// design is the bf16 GEMM's, with W split per call into two tf32 copies, A
// split in registers, and the sums promoted out of the tensor cores once a
// k-step (below).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

enum Epilogue { kQKV = 0, kGelu = 1, kResid = 2, kGeluErf = 3 };

struct GemmArgs {
  const void* a;         // (M, K), row-major
  const void* w;         // (N, K), row-major
  const void* bias;      // (N,)
  int M, N, K;
  void* out0;            // QKV: q; GELU(_ERF): hidden (M, N); RESID: out (M, N)
  void* out1;            // QKV: k
  void* out2;            // QKV: v
  const void* resid;     // RESID: x (M, N)
  const void* gamma;     // RESID: (N,)
  int ntok, heads, dh;   // QKV: tokens per image, heads, head width
  bool pbf;              // bias and gamma are bf16 (else fp32)
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// jax.nn.gelu(approximate=True): h·(0.5·(1 + tanh(√(2/π)·(h + 0.044715·h³))))
__device__ __forceinline__ float gelu_tanh(float h) {
  const float k = 0.7978845608028654f;
  return h * (0.5f * (1.f + tanhf(k * (h + 0.044715f * (h * h * h)))));
}

// The exact GELU, torch's F.gelu(approximate="none"): 0.5·h·(1 + erf(h·√½))
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// K5's hidden: the GELU of the epilogue's flavour (kGelu or kGeluErf)
template <int kEpi>
__device__ __forceinline__ float gelu(float h) {
  return kEpi == kGeluErf ? gelu_erf(h) : gelu_tanh(h);
}

// fp32 output columns c and c + 1 (c even) of row r.
template <int kEpi>
__device__ __forceinline__ void epilogue_f32(const GemmArgs& p, int r, int c, float a0,
                                             float a1) {
  if (r >= p.M || c >= p.N) return;
  a0 += asis::param_at(p.bias, c, p.pbf);
  a1 += asis::param_at(p.bias, c + 1, p.pbf);
  if (kEpi == kQKV) {
    const int C = p.N / 3;
    const int which = c / C, cc = c - which * C;
    const int h = cc / p.dh, d = cc - h * p.dh;
    const int b = r / p.ntok, n = r - b * p.ntok;
    float* o = static_cast<float*>(which == 0 ? p.out0 : which == 1 ? p.out1 : p.out2);
    store_pair(o + ((static_cast<size_t>(b) * p.heads + h) * p.ntok + n) * p.dh + d, a0, a1);
  } else if (kEpi == kGelu || kEpi == kGeluErf) {
    store_pair(static_cast<float*>(p.out0) + static_cast<size_t>(r) * p.N + c, gelu<kEpi>(a0),
               gelu<kEpi>(a1));
  } else {
    const size_t off = static_cast<size_t>(r) * p.N + c;
    const float2 x = load_pair(static_cast<const float*>(p.resid) + off);
    store_pair(static_cast<float*>(p.out0) + off, x.x + asis::param_at(p.gamma, c, p.pbf) * a0,
               x.y + asis::param_at(p.gamma, c + 1, p.pbf) * a1);
  }
}

// ---- bf16: Hopper tensor cores (wgmma fed by TMA) --------------------------
//
// One persistent CTA of three warpgroups per SM walks the 128 × 256 output
// tiles, the 256-column tiles of one 128-row block in turn (so the A block
// is read from L2 while it is hot; every W of the main path, 6.3 to 8.4 MB,
// stays in L2 whole). Warpgroup 0 is the producer: its first thread issues
// the TMA loads of each k-step's A tile (128 × 64) and W tile (256 × 64),
// 128-byte swizzled, into a ring of kStages stages that runs on across
// tiles; TMA fills A rows past M with zeros. Warpgroups 1 and 2 are the
// consumers, 64 rows each: four wgmma m64n256k16 per k-step, 128 fp32
// accumulators a thread, both operands from shared memory. A consumer
// issues a k-step's products while the previous k-step's run, then
// releases that one's stage.
// setmaxnreg gives the producer warpgroup 40 registers and the consumers
// 232. Each warpgroup's epilogue rounds its outputs once, stages them in
// shared memory and stores them as 16-byte chunks (QKV: each chunk to its
// head's row of q, k or v, which splits a tile's rows at image boundaries
// and its columns at head and q/k/v boundaries by itself); RESID stages
// γ·(acc + b2) in fp32 and adds x read as 16-byte chunks. Meanwhile the
// producer fills the ring with the next tile's first stages.

namespace hw = asis::hopper;

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kATile = kBM * kBK * 2;         // 16 KB
constexpr int kStageBytes = kATile + kBN * kBK * 2;  // + the 32 KB W tile
constexpr int kStagingOffset = kStages * kStageBytes;  // a consumer warpgroup's outputs:
constexpr int kStagingBytes = 64 * 256;  // 64 rows × 128 bf16 (QKV, GELU) or 64 fp32 (RESID)
constexpr int kBarOffset = kStagingOffset + 2 * kStagingBytes;
constexpr int kSmemBytes = kBarOffset + 8 * 2 * kStages + 1024;  // + slack to align to 1 KB

__device__ __forceinline__ float2 param_pair(const void* p, int i, bool is_bf16) {
  return is_bf16 ? load_pair(static_cast<const __nv_bfloat16*>(p) + i)
                 : load_pair(static_cast<const float*>(p) + i);
}

// RESID's epilogue for one consumer warpgroup (thread ct of 128, rows
// m0 + 64·wg ..): y = γ·(acc + b2) in fp32 is staged in `stage`, 64 rows ×
// 64 columns at a time (rows of 16 chunks of 4 floats, chunk c of row r at
// c ^ 2·(r % 8): free of bank conflicts both ways), then each thread reads
// 8 columns of x as one 16-byte chunk, adds y and stores the rounded sum
// as one 16-byte chunk.
__device__ __forceinline__ void store_resid(const GemmArgs& p, const float (&acc)[128],
                                            uint8_t* stage, int wg, int ct, int m0, int n0) {
  using bf16 = __nv_bfloat16;
  const int warp = ct >> 5, lane = ct & 31, tig = lane & 3;
  const int group = ct & 7;  // the 8 columns this thread stores, of rows ct / 8 + 16i
#pragma unroll
  for (int quarter = 0; quarter < 4; ++quarter) {
    hw::named_sync(1 + wg, 128);  // the stage's previous values are read
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * quarter + jj, c = n0 + 8 * j + 2 * tig;
      const bool ok = c < p.N;
      const float2 bias = ok ? param_pair(p.bias, c, p.pbf) : make_float2(0.f, 0.f);
      const float2 gamma = ok ? param_pair(p.gamma, c, p.pbf) : make_float2(0.f, 0.f);
      const int chunk = 2 * jj + (tig >> 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + (lane >> 2) + 8 * i;
        *reinterpret_cast<float2*>(stage + row * 256 + ((chunk ^ ((row & 7) << 1)) << 4) +
                                   8 * (tig & 1)) =
            make_float2(gamma.x * (acc[4 * j + 2 * i] + bias.x),
                        gamma.y * (acc[4 * j + 2 * i + 1] + bias.y));
      }
    }
    hw::named_sync(1 + wg, 128);  // the stage is written
    const int c = n0 + 64 * quarter + 8 * group;
    if (c >= p.N) continue;
    uint4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + wg * 64 + (ct >> 3) + 16 * i;
      if (r < p.M)
        x[i] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.resid) +
                                               static_cast<size_t>(r) * p.N + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (ct >> 3) + 16 * i, r = m0 + wg * 64 + row;
      if (r >= p.M) continue;
      float v[8], y[8];
      asis::load_vec(reinterpret_cast<const bf16*>(&x[i]), v);
      const uint8_t* ys = stage + row * 256;
      const float4 y0 =
          *reinterpret_cast<const float4*>(ys + (((2 * group) ^ ((row & 7) << 1)) << 4));
      const float4 y1 =
          *reinterpret_cast<const float4*>(ys + (((2 * group + 1) ^ ((row & 7) << 1)) << 4));
      y[0] = y0.x, y[1] = y0.y, y[2] = y0.z, y[3] = y0.w;
      y[4] = y1.x, y[5] = y1.y, y[6] = y1.z, y[7] = y1.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += y[e];
      asis::store_vec(static_cast<bf16*>(p.out0) + static_cast<size_t>(r) * p.N + c, v);
    }
  }
}

// QKV's and the GELUs' epilogue for one consumer warpgroup (thread ct of 128,
// rows m0 + 64·wg ..): the rounded bf16 outputs are staged in `stage`, 64
// rows × 128 columns at a time (rows of 16 chunks of 16 bytes, chunk c of
// row r at c ^ (r % 8): the accumulator's writes and the chunk reads are
// free of bank conflicts), then stored as 16-byte chunks, a warp to two
// rows (QKV: each chunk to its head's row in q, k or v).
template <int kEpi>
__device__ __forceinline__ void store_staged(const GemmArgs& p, const float (&acc)[128],
                                             uint8_t* stage, int wg, int ct, int m0, int n0) {
  using bf16 = __nv_bfloat16;
  const int warp = ct >> 5, lane = ct & 31, tig = lane & 3;
  const int chunk = ct & 15;  // the chunk this thread stores, of rows ct / 16 + 8i
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    hw::named_sync(1 + wg, 128);  // the stage's previous chunks are read
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 16 * half + jj;
      const int c = n0 + 8 * j + 2 * tig;
      const float2 bias = c < p.N ? param_pair(p.bias, c, p.pbf) : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + (lane >> 2) + 8 * i;
        float a0 = acc[4 * j + 2 * i] + bias.x, a1 = acc[4 * j + 2 * i + 1] + bias.y;
        if (kEpi == kGelu || kEpi == kGeluErf) {
          a0 = gelu<kEpi>(a0);
          a1 = gelu<kEpi>(a1);
        }
        *reinterpret_cast<uint32_t*>(stage + row * 256 + ((jj ^ (row & 7)) << 4) + 4 * tig) =
            asis::pack_bf16(a0, a1);
      }
    }
    hw::named_sync(1 + wg, 128);  // the stage is written
    const int c = n0 + 128 * half + 8 * chunk;
    if (c >= p.N) continue;
    bf16* dst = static_cast<bf16*>(p.out0) + c;  // GELU: + r·N
    if (kEpi == kQKV) {
      const int C = p.N / 3;
      const int which = c / C, cc = c - which * C;
      const int h = cc / p.dh, d = cc - h * p.dh;
      dst = static_cast<bf16*>(which == 0 ? p.out0 : which == 1 ? p.out1 : p.out2) +
            static_cast<size_t>(h) * p.ntok * p.dh + d;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (ct >> 4) + 8 * i, r = m0 + wg * 64 + row;
      if (r >= p.M) continue;
      size_t at;
      if (kEpi == kQKV) {
        const int b = r / p.ntok, n = r - b * p.ntok;
        at = (static_cast<size_t>(b) * p.heads * p.ntok + n) * p.dh;
      } else {
        at = static_cast<size_t>(r) * p.N;
      }
      *reinterpret_cast<uint4*>(dst + at) =
          *reinterpret_cast<const uint4*>(stage + row * 256 + ((chunk ^ (row & 7)) << 4));
    }
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap wmap, const GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // stage s: A at + s·kStageBytes, W after it
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + kBarOffset;       // + 8·stage: TMA's bytes landed
  const uint32_t empty = full + 8 * kStages;     // + 8·stage: the consumers are done with it

  const int ntiles = (p.N + kBN - 1) / kBN;
  const int total = ((p.M + kBM - 1) / kBM) * ntiles;
  const int KT = p.K / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(full + 8 * s, 1);
      hw::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // Tiles are dealt to the CTAs in turn. Producer and consumers walk the
  // same sequence and count its k-steps in g: ring stage g % kStages, phase
  // (g / kStages) & 1.
  if (warp < 4) {
    hw::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int m0 = (tile / ntiles) * kBM, n0 = (tile % ntiles) * kBN;
        for (int kt = 0; kt < KT; ++kt, ++g) {
          const int s = g % kStages;
          hw::mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);  // passes at once in round 0
          const uint32_t stage = base + s * kStageBytes;
          hw::mbar_expect_tx(full + 8 * s, kStageBytes);
          hw::tma_load_2d(stage, &amap, full + 8 * s, kt * kBK, m0);
          hw::tma_load_2d(stage + kATile, &wmap, full + 8 * s, kt * kBK, n0);
        }
      }
    }
  } else {
    hw::regs_alloc<232>();
    const int wg = (warp >> 2) - 1, ct = threadIdx.x & 127;
    uint8_t* const staging = base_ptr + kStagingOffset + wg * kStagingBytes;
    float acc[128] = {};  // each tile's first wgmma overwrites it
    int g = 0;
    // k-step kt (stage g % kStages): wait for its tiles, issue its four
    // wgmmas, then wait for k-step kt − 1's and release that stage
    auto step = [&](int kt) {
      const int s = g % kStages;
      hw::mbar_wait(full + 8 * s, (g / kStages) & 1);
      const uint32_t stage = base + s * kStageBytes;
      const uint64_t da = hw::sw128_desc(stage + wg * 64 * 128);
      const uint64_t dw = hw::sw128_desc(stage + kATile);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hw::wgmma_m64n256k16_ss(acc, da + 2 * kk, dw + 2 * kk, kt > 0 || kk > 0);
      hw::wgmma_commit();
      hw::fence_regs(acc);
      if (kt > 0) {
        hw::wgmma_wait<1>();
        hw::fence_regs(acc);
        if (lane == 0) hw::mbar_arrive(empty + 8 * ((g - 1) % kStages));
      }
      ++g;
    };
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int m0 = (tile / ntiles) * kBM, n0 = (tile % ntiles) * kBN;
      for (int kt = 0; kt < KT; kt += 2) {  // two k-steps an iteration
        step(kt);
        if (kt + 1 < KT) step(kt + 1);
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      if (lane == 0) hw::mbar_arrive(empty + 8 * ((g - 1) % kStages));
      if (kEpi == kResid)
        store_resid(p, acc, staging, wg, ct, m0, n0);
      else
        store_staged<kEpi>(p, acc, staging, wg, ct, m0, n0);
    }
  }
}

// ---- fp32: 3×TF32 on the tensor cores (wgmma fed by TMA) -------------------
//
// The bf16 GEMM's shape: one persistent CTA of three warpgroups per SM
// walking the output tiles, 128 × 128 here; the producer's first thread
// loads each k-step's tiles by TMA into a ring; two consumer warpgroups of
// 64 rows issue wgmma. The operands are held to fp32 accuracy by 3×TF32
// (hopper.cuh): W is split once per call by `split_kernel` into W_hi and
// W_lo, two (N, K) tf32 copies in the caller's workspace, which TMA streams
// beside the raw A tile; each consumer thread loads its A fragments from
// the landed (swizzled) tile and splits them in registers. The tensor
// cores truncate at every accumulation, so a k-step's products go into a
// partial accumulator of their own, the small ones first (A_lo·W_hiᵀ,
// A_hi·W_loᵀ for each k8 step, then A_hi·W_hiᵀ), as register-A wgmma
// m64n128k8; the partial is added to the tile's fp32 accumulator in
// round-to-nearest once its products are done (a chain of 12 truncating
// steps instead of 3·K/8). Two accumulators of 64 registers are why the
// tile is 128 wide and not the bf16 GEMM's 256. Each consumer warpgroup
// waits for its own k-step before the next; the other one's products keep
// the tensor cores busy meanwhile. A k-step is 32 fp32 (one 128-byte
// swizzle atom): a stage holds A, W_hi and W_lo (128 × 32 each, 48 KB), and
// four stages fit. The epilogue stores fp32 pairs straight from the
// accumulator: a quad of lanes writes 32 contiguous bytes of a row, whole
// sectors.

constexpr int kTBN = 128;
constexpr int kTBK = 32;                            // k-step: 32 fp32, 128 bytes
constexpr int kTStages = 4;
constexpr int kTTile = kBM * kTBK * 4;              // 16 KB: A, W_hi or W_lo (kTBN = kBM)
constexpr int kTStageBytes = 3 * kTTile;
constexpr int kTBarOffset = kTStages * kTStageBytes;
constexpr int kTSmemBytes = kTBarOffset + 8 * 2 * kTStages + 1024;  // + slack to align to 1 KB

// w (n4 groups of 4 fp32) → hi, lo with w = hi + lo, each tf32.
__global__ void split_kernel(const float4* __restrict__ w, float4* __restrict__ hi,
                             float4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 x = w[i];
    uint32_t h[4], l[4];
    hw::tf32_split(x.x, h[0], l[0]);
    hw::tf32_split(x.y, h[1], l[1]);
    hw::tf32_split(x.z, h[2], l[2]);
    hw::tf32_split(x.w, h[3], l[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
}

// This thread's A fragments of one k-step (four k8 steps), split: rows r and
// r + 8 of the 128 × 32 tile (`r % 8` = its swizzle), columns 8kk + tig and
// 8kk + tig + 4, i.e. chunks 2kk and 2kk + 1 of the row, at chunk ^ (r % 8).
// Conflict-free: a warp's 8 rows read 8 distinct chunk positions.
__device__ __forceinline__ void load_a_split(const uint8_t* tile, int r, int tig,
                                             uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  const float* row0 = reinterpret_cast<const float*>(tile + r * 128);
  const float* row1 = reinterpret_cast<const float*>(tile + (r + 8) * 128);
  const int sw = r & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c0 = ((2 * kk) ^ sw) * 4 + tig, c1 = ((2 * kk + 1) ^ sw) * 4 + tig;
    hw::tf32_split(row0[c0], hi[kk][0], lo[kk][0]);
    hw::tf32_split(row1[c0], hi[kk][1], lo[kk][1]);
    hw::tf32_split(row0[c1], hi[kk][2], lo[kk][2]);
    hw::tf32_split(row1[c1], hi[kk][3], lo[kk][3]);
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hw::fence_regs(hi[kk]);
    hw::fence_regs(lo[kk]);
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap whimap,
                 const __grid_constant__ CUtensorMap wlomap, const GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // stage s: A, W_hi, W_lo at + s·kTStageBytes
  const uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + kTBarOffset;      // + 8·stage: TMA's bytes landed
  const uint32_t empty = full + 8 * kTStages;    // + 8·stage: the consumers are done with it

  const int ntiles = (p.N + kTBN - 1) / kTBN;
  const int total = ((p.M + kBM - 1) / kBM) * ntiles;
  const int KT = p.K / kTBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      hw::mbar_init(full + 8 * s, 1);
      hw::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // As the bf16 kernel: k-steps counted in g, stage g % kTStages, phase
  // (g / kTStages) & 1.
  if (warp < 4) {
    hw::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int m0 = (tile / ntiles) * kBM, n0 = (tile % ntiles) * kTBN;
        for (int kt = 0; kt < KT; ++kt, ++g) {
          const int s = g % kTStages;
          hw::mbar_wait(empty + 8 * s, ((g / kTStages) & 1) ^ 1);  // passes at once in round 0
          const uint32_t stage = base + s * kTStageBytes;
          hw::mbar_expect_tx(full + 8 * s, kTStageBytes);
          hw::tma_load_2d(stage, &amap, full + 8 * s, kt * kTBK, m0);
          hw::tma_load_2d(stage + kTTile, &whimap, full + 8 * s, kt * kTBK, n0);
          hw::tma_load_2d(stage + 2 * kTTile, &wlomap, full + 8 * s, kt * kTBK, n0);
        }
      }
    }
  } else {
    hw::regs_alloc<232>();
    const int wg = (warp >> 2) - 1, tig = lane & 3;
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows r, r + 8
    float acc[64], part[64];
    uint32_t hi[4][4], lo[4][4];
    int g = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int m0 = (tile / ntiles) * kBM, n0 = (tile % ntiles) * kTBN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < KT; ++kt, ++g) {
        const int s = g % kTStages;
        hw::mbar_wait(full + 8 * s, (g / kTStages) & 1);
        load_a_split(base_ptr + s * kTStageBytes, r, tig, hi, lo);
        const uint32_t stage = base + s * kTStageBytes;
        const uint64_t dhi = hw::sw128_desc(stage + kTTile);
        const uint64_t dlo = hw::sw128_desc(stage + 2 * kTTile);
        hw::fence_regs(part);
        fence_frags(hi, lo);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTBK / 8; ++kk) {
          hw::wgmma_m64n128k8_tf32_rs(part, lo[kk], dhi + 2 * kk, kk > 0);
          hw::wgmma_m64n128k8_tf32_rs(part, hi[kk], dlo + 2 * kk, 1);
        }
#pragma unroll
        for (int kk = 0; kk < kTBK / 8; ++kk)
          hw::wgmma_m64n128k8_tf32_rs(part, hi[kk], dhi + 2 * kk, 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(part);
        fence_frags(hi, lo);
        if (lane == 0) hw::mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      const int row = m0 + r;
#pragma unroll
      for (int j = 0; j < kTBN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * tig;
        epilogue_f32<kEpi>(p, row, c, acc[4 * j], acc[4 * j + 1]);
        epilogue_f32<kEpi>(p, row + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// The persistent kernels' grid: one CTA per SM, each walking its share of
// the output tiles of `bn` columns.
inline int gemm_grid(const GemmArgs& p, int bn, int sms) {
  return std::min(((p.M + kBM - 1) / kBM) * ((p.N + bn - 1) / bn), sms);
}

template <int kEpi>
int launch_wgmma(const GemmArgs& p, cudaStream_t s) {
  // more than 48 KB of dynamic shared memory: allowed once per card, when
  // its SM count is read
  static hw::LaunchCache cache;
  int sms = 0;
  const cudaError_t err = hw::prepare(cache, gemm_wgmma_kernel<kEpi>, kSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap am, wm;
  if (!hw::mat_map(&am, p.a, p.M, p.K, kBM) || !hw::mat_map(&wm, p.w, p.N, p.K, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  gemm_wgmma_kernel<kEpi><<<gemm_grid(p, kBN, sms), kThreads, kSmemBytes, s>>>(am, wm, p);
  return static_cast<int>(cudaGetLastError());
}

// fp32: W split into wsplit (W_hi, then W_lo, N·K fp32 each), then the GEMM.
template <int kEpi>
int launch_tf32(const GemmArgs& p, float* wsplit, cudaStream_t s) {
  static hw::LaunchCache cache;
  int sms = 0;
  cudaError_t err = hw::prepare(cache, gemm_tf32_kernel<kEpi>, kTSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(p.N) * p.K;
  float* const whi = wsplit;
  float* const wlo = wsplit + n;
  const size_t n4 = n / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 8 * sms));
  split_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(p.w),
                                      reinterpret_cast<float4*>(whi),
                                      reinterpret_cast<float4*>(wlo), n4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap am, hm, lm;
  if (!hw::mat_map_f32(&am, p.a, p.M, p.K, kBM) || !hw::mat_map_f32(&hm, whi, p.N, p.K, kTBN) ||
      !hw::mat_map_f32(&lm, wlo, p.N, p.K, kTBN))
    return static_cast<int>(cudaErrorInvalidValue);
  gemm_tf32_kernel<kEpi><<<gemm_grid(p, kTBN, sms), kThreads, kTSmemBytes, s>>>(am, hm, lm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kEpi>
int launch(const GemmArgs& p, bool bf16, float* wsplit, cudaStream_t s) {
  return bf16 ? launch_wgmma<kEpi>(p, s) : launch_tf32<kEpi>(p, wsplit, s);
}

}  // namespace

extern "C" {

// out = epilogue(a·wᵀ + bias), see above. a (M, K) and w (N, K)
// contiguous in one dtype (is_bf16: bfloat16, else float32), 16-byte
// aligned; bias, gamma bfloat16 (params_bf16) or float32, 16-byte aligned.
// K and N multiples of 64, any M; QKV: N = 3·heads·dh, M = images·ntok, dh
// a multiple of 8 (bf16) or 2 (fp32). float32 also takes wsplit, a
// workspace of 2·N·K float32 (16-byte aligned) for w's tf32 halves; null in
// bfloat16. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int asis_ln_gemm(int epi, const void* a, const void* w, const void* bias, int M, int N, int K,
                 void* out0, void* out1, void* out2, const void* resid, const void* gamma,
                 int ntok, int heads, int dh, int is_bf16, int params_bf16, void* wsplit,
                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK != 0 || N % 64 != 0 ||
      (is_bf16 == 0) != (wsplit != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (epi == kQKV && (ntok <= 0 || dh <= 0 || dh % (is_bf16 ? 8 : 2) != 0 ||
                      M % ntok != 0 || N != 3 * heads * dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs p{a, w, bias, M, N, K, out0, out1, out2, resid, gamma, ntok, heads, dh,
                   params_bf16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const ws = static_cast<float*>(wsplit);
  switch (epi) {
    case kQKV: return launch<kQKV>(p, is_bf16 != 0, ws, s);
    case kGelu: return launch<kGelu>(p, is_bf16 != 0, ws, s);
    case kResid: return launch<kResid>(p, is_bf16 != 0, ws, s);
    case kGeluErf: return launch<kGeluErf>(p, is_bf16 != 0, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
