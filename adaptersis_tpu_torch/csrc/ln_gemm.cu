// GEMMs with a LayerNorm prologue and fused epilogues: the frozen ViT
// block's LN → qkv → head split (K4) and LN → fc1 → tanh-GELU → fc2 →
// LayerScale → residual (K5, as two GEMMs).
//
// Replaces:
//   * K4: adaptersis_tpu/ops/fused_qkv.py `_kernel` (via `_fwd_impl`);
//   * K5: adaptersis_tpu/ops/fused_mlp.py `_kernel` (via `_fwd_impl`).
//
// Every call computes out = epilogue(A·Wᵀ + bias) for A (M, K) and the torch
// Linear weight W (N, K), both contiguous along K. A is xn = (x − mean)·
// (rstd·ln_w) + ln_b in fp32, rounded to x's dtype, as the TPU kernels
// normalise it: in bf16 the wrappers pass xn written by layernorm.cu's
// LayerNorm kernel (below); in fp32 they pass x and its row statistics
// (layernorm.cu's row-stats kernel), and the kernel normalises each A
// element before its product. Without statistics A is taken as it is.
// The products accumulate in fp32, and each output is rounded once:
//   * QKV:   (acc + b) → x's dtype, scattered to q, k, v of (B, H, Ntok, Dh):
//            column j to (j / C, (j mod C) / Dh, j mod Dh), row r to
//            (r / Ntok, r mod Ntok) — K3's input layout, with no relayout;
//   * GELU:  tanh-GELU(acc + b1) in fp32 → x's dtype: K5's hidden (M, 4C);
//   * RESID: (x + γ·(acc + b2)) in fp32 → x's dtype: K5's output, from the
//            hidden as A (no prologue).
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
// through HBM at batch 16, ≈ 0.04 ms; PERF.md), so the bf16 path takes xn
// and refuses row statistics.
//
// fp32 (the narrow parity models): the LayerNorm prologue and the same
// epilogues on the CUDA cores, 64×64 tiles, 4×4 outputs per thread, exact
// fp32 products.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

enum Epilogue { kQKV = 0, kGelu = 1, kResid = 2 };

struct GemmArgs {
  const void* a;         // (M, K), row-major
  const float2* stats;   // (M,) (mean, rstd) for the LayerNorm prologue, or null
  const void* ln_w;      // (K,) with stats
  const void* ln_b;      // (K,) with stats
  const void* w;         // (N, K), row-major
  const void* bias;      // (N,)
  int M, N, K;
  void* out0;            // QKV: q; GELU: hidden (M, N); RESID: out (M, N)
  void* out1;            // QKV: k
  void* out2;            // QKV: v
  const void* resid;     // RESID: x (M, N)
  const void* gamma;     // RESID: (N,)
  int ntok, heads, dh;   // QKV: tokens per image, heads, head width
  bool pbf;              // ln_w, ln_b, bias and gamma are bf16 (else fp32)
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = asis::pack_bf16(a, b);
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

// Output columns c and c + 1 (c even) of row r.
template <typename T, int kEpi>
__device__ __forceinline__ void epilogue(const GemmArgs& p, int r, int c, float a0, float a1) {
  if (r >= p.M || c >= p.N) return;
  a0 += asis::param_at(p.bias, c, p.pbf);
  a1 += asis::param_at(p.bias, c + 1, p.pbf);
  if (kEpi == kQKV) {
    const int C = p.N / 3;
    const int which = c / C, cc = c - which * C;
    const int h = cc / p.dh, d = cc - h * p.dh;
    const int b = r / p.ntok, n = r - b * p.ntok;
    T* o = static_cast<T*>(which == 0 ? p.out0 : which == 1 ? p.out1 : p.out2);
    store_pair(o + ((static_cast<size_t>(b) * p.heads + h) * p.ntok + n) * p.dh + d, a0, a1);
  } else if (kEpi == kGelu) {
    store_pair(static_cast<T*>(p.out0) + static_cast<size_t>(r) * p.N + c, gelu_tanh(a0),
               gelu_tanh(a1));
  } else {
    const size_t off = static_cast<size_t>(r) * p.N + c;
    const float2 x = load_pair(static_cast<const T*>(p.resid) + off);
    store_pair(static_cast<T*>(p.out0) + off, x.x + asis::param_at(p.gamma, c, p.pbf) * a0,
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

// QKV's and GELU's epilogue for one consumer warpgroup (thread ct of 128,
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
        if (kEpi == kGelu) {
          a0 = gelu_tanh(a0);
          a1 = gelu_tanh(a1);
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

// ---- fp32: CUDA cores ------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

constexpr int kFThreads = 256;  // 16 × 16, 4 × 4 outputs each

template <int kEpi>
__global__ void __launch_bounds__(kFThreads) gemm_f32_kernel(const GemmArgs p) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];  // k-major: rows read as broadcasts
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // outputs: rows ty·4.., columns tx·4..
  const int bm = blockIdx.y * kFBM, bn = blockIdx.x * kFBN;
  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);
  const bool ln = p.stats != nullptr;
  // loaders: 64 rows × 4 chunks of 4 values each for A and for W
  const int lrow = tid >> 2, lk = (tid & 3) * 4;
  const int ar = bm + lrow, wr = bn + lrow;
  const float2 st = (ln && ar < p.M) ? p.stats[ar] : make_float2(0.f, 1.f);

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kFBK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f}, wv[4] = {0.f, 0.f, 0.f, 0.f};
    if (ar < p.M) {
      asis::load_vec(A + static_cast<size_t>(ar) * p.K + k0 + lk, av);
      if (ln) {
        float g[4], b[4];
        asis::load_param(p.ln_w, k0 + lk, p.pbf, g);
        asis::load_param(p.ln_b, k0 + lk, p.pbf, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) av[e] = (av[e] - st.x) * (st.y * g[e]) + b[e];
      }
    }
    if (wr < p.N) asis::load_vec(W + static_cast<size_t>(wr) * p.K + k0 + lk, wv);
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[lk + e][lrow] = av[e];
      Bs[lk + e][lrow] = wv[e];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[4], b[4];
      asis::load_vec(&As[k][ty * 4], a);
      asis::load_vec(&Bs[k][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = bm + ty * 4 + i;
    epilogue<float, kEpi>(p, r, bn + tx * 4, acc[i][0], acc[i][1]);
    epilogue<float, kEpi>(p, r, bn + tx * 4 + 2, acc[i][2], acc[i][3]);
  }
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
  // one CTA per SM, each walking its share of the output tiles
  const int total = ((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  gemm_wgmma_kernel<kEpi><<<std::min(total, sms), kThreads, kSmemBytes, s>>>(am, wm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kEpi>
int launch(const GemmArgs& p, bool bf16, cudaStream_t s) {
  if (!bf16) {
    const dim3 grid((p.N + kFBN - 1) / kFBN, (p.M + kFBM - 1) / kFBM);
    gemm_f32_kernel<kEpi><<<grid, kFThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_wgmma<kEpi>(p, s);
}

}  // namespace

extern "C" {

// out = epilogue(LN(a)·wᵀ + bias), see above. a (M, K) and w (N, K)
// contiguous in one dtype (is_bf16: bfloat16, else float32), 16-byte
// aligned; stats (M, 2) float32 or null (no prologue; always null in
// bfloat16, whose A is xn); ln_w, ln_b, bias,
// gamma bfloat16 (params_bf16) or float32, 16-byte aligned. K and N
// multiples of 64; QKV: N = 3·heads·dh,
// M = images·ntok, dh a multiple of 8 (bf16) or 2 (fp32). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int asis_ln_gemm(int epi, const void* a, const void* stats, const void* ln_w, const void* ln_b,
                 const void* w, const void* bias, int M, int N, int K, void* out0, void* out1,
                 void* out2, const void* resid, const void* gamma, int ntok, int heads, int dh,
                 int is_bf16, int params_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK != 0 || N % 64 != 0 ||
      (M + kFBM - 1) / kFBM > 65535 || (is_bf16 && stats != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (epi == kQKV && (ntok <= 0 || dh <= 0 || dh % (is_bf16 ? 8 : 2) != 0 ||
                      M % ntok != 0 || N != 3 * heads * dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs p{a, static_cast<const float2*>(stats), ln_w, ln_b, w, bias, M, N, K,
                   out0, out1, out2, resid, gamma, ntok, heads, dh, params_bf16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kQKV: return launch<kQKV>(p, is_bf16 != 0, s);
    case kGelu: return launch<kGelu>(p, is_bf16 != 0, s);
    case kResid: return launch<kResid>(p, is_bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
