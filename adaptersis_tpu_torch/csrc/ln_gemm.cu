// GEMMs with a LayerNorm prologue and fused epilogues: the frozen ViT
// block's fused LN → qkv → head split (K4) and fused LN → fc1 → tanh-GELU →
// fc2 → LayerScale → residual (K5, as two GEMMs).
//
// Replaces:
//   * K4: adaptersis_tpu/ops/fused_qkv.py `_kernel` (via `_fwd_impl`);
//   * K5: adaptersis_tpu/ops/fused_mlp.py `_kernel` (via `_fwd_impl`).
//
// Every call computes out = epilogue(A·Wᵀ + bias) for A (M, K) and the torch
// Linear weight W (N, K), both contiguous along K. Where the call gives row
// statistics (from layernorm.cu's row-stats kernel), A is x and each A
// element is normalised while its tile is loaded, as the TPU kernels do:
// xn = (x − mean)·(rstd·ln_w) + ln_b in fp32, rounded to x's dtype. The
// products accumulate in fp32, and each output is rounded once:
//   * QKV:   (acc + b) → x's dtype, scattered to q, k, v of (B, H, Ntok, Dh):
//            column j to (j / C, (j mod C) / Dh, j mod Dh), row r to
//            (r / Ntok, r mod Ntok) — K3's input layout, with no relayout;
//   * GELU:  tanh-GELU(acc + b1) in fp32 → x's dtype: K5's hidden (M, 4C);
//   * RESID: (x + γ·(acc + b2)) in fp32 → x's dtype: K5's output, from the
//            hidden as A (no prologue).
// The TPU's K5 kept both weights (16 MB in bf16) resident in VMEM and never
// wrote the hidden; 227 KB of shared memory cannot hold them, so here the
// hidden makes one round trip through HBM (2 × 231 MB at batch 16).
//
// What bounds it on the H100: at the main path's shapes (M = 16·1765 rows,
// C = 1024) K4 does 177.7 GFLOP on 237.6 MB and K5 473.8 GFLOP on
// 132.4 MB: both are bound by the tensor cores' bf16 rate (0.180 and
// 0.479 ms at 989 TFLOP/s). So the bf16 path runs mma.sync m16n8k16 bf16
// products with fp32 accumulators: 128×256 block tiles (85 FLOP per byte
// read from L2), 8 warps of 64×64, K in steps of 64, the fragments of the
// next 16 loaded while the current ones multiply. A and B tiles arrive by
// cp.async in a 3-stage ring of padded shared memory (rows of 72 elements:
// ldmatrix reads hit 8 distinct bank groups). With a LayerNorm prologue
// each thread normalises the A chunks it copied, in place, one tile ahead,
// while other warps multiply. QKV and GELU outputs are staged through
// shared memory and written as 16-byte chunks. wgmma, TMA and warp
// specialisation are later work.
//
// fp32 (the narrow parity models): the same prologue and epilogues on the
// CUDA cores, 64×64 tiles, 4×4 outputs per thread, exact fp32 products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
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

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;     // tiles in flight: this one and 2 ahead
constexpr int kLds = kBK + 8;  // padded shared-memory row (elements)
constexpr int kThreads = 256;  // 8 warps: 2 along M × 4 along N, 64×64 each
constexpr int kRowStep = kThreads / (kBK / 8);  // rows one pass of the loaders covers
constexpr int kAChunks = kBM / kRowStep, kBChunks = kBN / kRowStep;  // per thread
constexpr int kStageElems = (kBM + kBN) * kLds;  // one A and one B tile
constexpr int kCLds = kBN + 8;                   // a staged output row (elements)
constexpr int kSmemBytes = kStages * kStageElems * 2;
static_assert(kBM * kCLds <= kStages * kStageElems, "the output tile reuses the ring");

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_bf16_kernel(const GemmArgs p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: A [kBM][kLds], then B [kBN][kLds]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* W = static_cast<const bf16*>(p.w);
  const bool ln = p.stats != nullptr;

  // loaders: a tile row is kBK / 8 chunks of 8 elements; this thread copies
  // chunk lcol of A rows lrow + kRowStep·j (j < kAChunks) and of B rows
  // lrow + kRowStep·j (j < kBChunks), and normalises its own A chunks once
  // they have landed
  const int lrow = tid / (kBK / 8), lcol = (tid % (kBK / 8)) * 8;
  bool a_ok[kAChunks], b_ok[kBChunks];
  float mean[kAChunks], rstd[kAChunks];
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) {
    const int r = bm + lrow + kRowStep * j;
    a_ok[j] = r < p.M;
    const float2 st = (ln && a_ok[j]) ? p.stats[r] : make_float2(0.f, 1.f);
    mean[j] = st.x;
    rstd[j] = st.y;
  }
#pragma unroll
  for (int j = 0; j < kBChunks; ++j) b_ok[j] = bn + lrow + kRowStep * j < p.N;

  auto load_tile = [&](int s, int kt) {  // rows past M or N are zero-filled
    const int k0 = kt * kBK + lcol;
    bf16* as = ring + s * kStageElems;
    bf16* bs = as + kBM * kLds;
#pragma unroll
    for (int j = 0; j < kAChunks; ++j)
      asis::cp_async16(as + (lrow + kRowStep * j) * kLds + lcol,
                       A + static_cast<size_t>(a_ok[j] ? bm + lrow + kRowStep * j : 0) * p.K +
                           k0,
                       a_ok[j] ? 16 : 0);
#pragma unroll
    for (int j = 0; j < kBChunks; ++j)
      asis::cp_async16(bs + (lrow + kRowStep * j) * kLds + lcol,
                       W + static_cast<size_t>(b_ok[j] ? bn + lrow + kRowStep * j : 0) * p.K +
                           k0,
                       b_ok[j] ? 16 : 0);
  };
  // xn = (x − mean)·(rstd·ln_w) + ln_b in fp32, rounded to bf16, in place
  auto normalize = [&](int s, int kt) {
    float wv[8], bv[8];
    asis::load_param(p.ln_w, kt * kBK + lcol, p.pbf, wv);
    asis::load_param(p.ln_b, kt * kBK + lcol, p.pbf, bv);
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      bf16* chunk = ring + s * kStageElems + (lrow + kRowStep * j) * kLds + lcol;
      float v[8];
      asis::load_vec(chunk, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean[j]) * (rstd[j] * wv[e]) + bv[e];
      asis::store_vec(chunk, v);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  const int KT = p.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    asis::cp_async_commit();  // one group per tile, empty past the end
  }
  asis::cp_async_wait<kStages - 2>();  // this thread's copies of tile 0 landed
  if (ln) normalize(0, 0);

  for (int kt = 0; kt < KT; ++kt) {
    // tile kt is complete and normalised in every thread's part, and every
    // warp is done with tile kt − 1, whose stage is refilled next
    __syncthreads();
    if (kt + kStages - 1 < KT) load_tile((kt + kStages - 1) % kStages, kt + kStages - 1);
    asis::cp_async_commit();
    const bf16* as = ring + (kt % kStages) * kStageElems + (wm * 64 + (lane & 15)) * kLds +
                     (lane >> 4) * 8;
    // B matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    const bf16* bs = ring + (kt % kStages) * kStageElems + kBM * kLds +
                     (wn * 64 + (lane & 7) + ((lane >> 4) << 3)) * kLds + ((lane >> 3) & 1) * 8;
    // fragments of step kk + 16 load while step kk multiplies
    uint32_t af[2][4][4], bfr[2][4][4];
    auto load_frags = [&](int buf, int kk) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) asis::ldmatrix_x4(af[buf][mt], as + mt * 16 * kLds + kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) asis::ldmatrix_x4(bfr[buf][np], bs + np * 16 * kLds + kk);
    };
    load_frags(0, 0);
#pragma unroll
    for (int step = 0; step < kBK / 16; ++step) {
      const int buf = step & 1;
      if (step + 1 < kBK / 16) load_frags(buf ^ 1, (step + 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          asis::mma_bf16(acc[mt][nt], af[buf][mt], bfr[buf][nt >> 1][(nt & 1) * 2],
                         bfr[buf][nt >> 1][(nt & 1) * 2 + 1]);
    }
    // the next tile's copies and normalisation overlap other warps' products
    if (kt + 1 < KT) {
      asis::cp_async_wait<kStages - 2>();
      if (ln) normalize((kt + 1) % kStages, kt + 1);
    }
  }

  if (kEpi == kResid) {  // reads x at every output: stores straight from registers
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = bm + wm * 64 + mt * 16 + gid;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = bn + wn * 64 + nt * 8 + tig * 2;
        epilogue<bf16, kEpi>(p, r, c, acc[mt][nt][0], acc[mt][nt][1]);
        epilogue<bf16, kEpi>(p, r + 8, c, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    return;
  }
  // QKV and GELU: the rounded tile is staged in shared memory, then written
  // as 16-byte chunks, a warp to a row (QKV: 4 runs of Dh = 64 elements)
  asis::cp_async_wait<0>();
  __syncthreads();  // the ring is no longer read
  bf16* cs = ring;  // [kBM][kCLds]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = wn * 64 + nt * 8 + tig * 2;
    const bool ok = bn + c < p.N;
    const float b0 = ok ? asis::param_at(p.bias, bn + c, p.pbf) : 0.f;
    const float b1 = ok ? asis::param_at(p.bias, bn + c + 1, p.pbf) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = wm * 64 + mt * 16 + gid;
      float v[4] = {acc[mt][nt][0] + b0, acc[mt][nt][1] + b1, acc[mt][nt][2] + b0,
                    acc[mt][nt][3] + b1};
      if (kEpi == kGelu)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu_tanh(v[e]);
      *reinterpret_cast<uint32_t*>(cs + r * kCLds + c) = asis::pack_bf16(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(cs + (r + 8) * kCLds + c) = asis::pack_bf16(v[2], v[3]);
    }
  }
  __syncthreads();
  constexpr int kChunks = kBN / 8;  // per row
#pragma unroll 4
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int row = i / kChunks, col = (i % kChunks) * 8;
    const int r = bm + row, c = bn + col;
    if (r >= p.M || c >= p.N) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(cs + row * kCLds + col);
    bf16* dst;
    if (kEpi == kQKV) {
      const int C = p.N / 3;
      const int which = c / C, cc = c - which * C;
      const int h = cc / p.dh, d = cc - h * p.dh;
      const int b = r / p.ntok, n = r - b * p.ntok;
      dst = static_cast<bf16*>(which == 0 ? p.out0 : which == 1 ? p.out1 : p.out2) +
            ((static_cast<size_t>(b) * p.heads + h) * p.ntok + n) * p.dh + d;
    } else {
      dst = static_cast<bf16*>(p.out0) + static_cast<size_t>(r) * p.N + c;
    }
    *reinterpret_cast<uint4*>(dst) = val;
  }
}

// ---- fp32: CUDA cores ------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <int kEpi>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(const GemmArgs p) {
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

constexpr int kMaxDevices = 64;

template <int kEpi>
int launch(const GemmArgs& p, bool bf16, cudaStream_t s) {
  if (bf16) {
    // above 48 KB of shared memory only on request, once per device
    static std::atomic<bool> ready[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_relaxed)) {
      e = cudaFuncSetAttribute(gemm_bf16_kernel<kEpi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
    }
    const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
    gemm_bf16_kernel<kEpi><<<grid, kThreads, kSmemBytes, s>>>(p);
  } else {
    const dim3 grid((p.N + kFBN - 1) / kFBN, (p.M + kFBM - 1) / kFBM);
    gemm_f32_kernel<kEpi><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = epilogue(LN(a)·wᵀ + bias), see above. a (M, K) and w (N, K)
// contiguous in one dtype (is_bf16: bfloat16, else float32), 16-byte
// aligned; stats (M, 2) float32 or null (no prologue); ln_w, ln_b, bias,
// gamma bfloat16 (params_bf16) or float32, 16-byte aligned. K and N
// multiples of 64; QKV: N = 3·heads·dh,
// M = images·ntok, dh a multiple of 8 (bf16) or 2 (fp32). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int asis_ln_gemm(int epi, const void* a, const void* stats, const void* ln_w, const void* ln_b,
                 const void* w, const void* bias, int M, int N, int K, void* out0, void* out1,
                 void* out2, const void* resid, const void* gamma, int ntok, int heads, int dh,
                 int is_bf16, int params_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK != 0 || N % 64 != 0 ||
      (M + kFBM - 1) / kFBM > 65535)
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
