// Forward-only attention for the frozen ViT walks: o = softmax(q·kᵀ·scale)·v.
//
// Replaces: adaptersis_tpu/ops/flash_fwd.py `_kernel` (via `_fwd_impl`), the
// Pallas kernel behind attn_impl="flash_fwd".
//
// What bounds it on the H100: at the main-path shapes (B·H = 32 heads of
// N = 1765 or 1764 tokens, Dh = 64) one call does 4·B·H·N²·Dh ≈ 25.5 GFLOP
// and reads only 3·B·H·N·Dh·2 B ≈ 22 MB, so it is bound by arithmetic: the
// two products must run on the tensor cores, and the softmax's exp and max
// must stay out of their way.
//
// Two paths, chosen by what the call can take:
//   * bf16 with Dh = 64 (every main-path call): mma.sync m16n8k16 bf16
//     tensor-core products with fp32 accumulation (flash_fwd_mma_kernel);
//   * fp32, or Dh of 16 or 32: fp32 FMAs on the CUDA cores
//     (flash_fwd_kernel), exact fp32 for the parity checks.
// Both keep the TRUE running row max of an online softmax, in fp32. The TPU
// kernel replaced the row max by a constant clamp of 60, which is exact only
// while max|S| < 60 (6.37 was measured on the main path); with the running
// max this kernel is exact softmax for any scores, so the two agree wherever
// the TPU kernel is exact. The ragged tail (N not a multiple of the tile) is
// masked inside the kernel: keys past N get score −inf, queries past N are
// not stored. No padding to 128 and no ones column in v are needed. The
// loads are synchronous (no cp.async/TMA pipeline yet) and the products use
// mma.sync rather than wgmma: later work.
//
// CUDA-core path: one block of 64 threads per (b·h, 64-query tile); each
// thread owns one query row, holding q (pre-scaled) and the fp32 output
// accumulator in registers; K and V tiles of 64 keys are staged in shared
// memory as fp32 and read as broadcasts; the accumulator is rescaled once
// per chunk of 16 keys.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBQ = 64;     // queries per block (one per thread)
constexpr int kBK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax rescale

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int kDh>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int N, float scale) {
  __shared__ __align__(16) float ks[kBK][kDh];
  __shared__ __align__(16) float vs[kBK][kDh];

  const size_t head = (size_t)blockIdx.y * N * kDh;
  const int qi = blockIdx.x * kBQ + threadIdx.x;
  const bool active = qi < N;

  float qr[kDh];
  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = active ? to_f32(q[head + (size_t)qi * kDh + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F;  // running row max
  float l = 0.f;            // running softmax denominator

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kBK * kDh; i += kBQ) {
      const int r = i / kDh, c = i % kDh;
      const bool in = k0 + r < N;
      const size_t off = head + (size_t)(k0 + r) * kDh + c;
      ks[r][c] = in ? to_f32(k[off]) : 0.f;
      vs[r][c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int kn = min(kBK, N - k0);
    for (int c0 = 0; c0 < kn; c0 += kChunk) {
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) dot = fmaf(qr[d], ks[c0 + j][d], dot);
        s[j] = (c0 + j < kn) ? dot : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[j]);
      }
      // c0 < kn, so the chunk holds at least one real key and cmax is finite
      const float mnew = fmaxf(m, cmax);
      const float corr = __expf(m - mnew);  // exp(−inf) = 0 on the first chunk
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(s[j] - mnew);  // 0 for masked keys
        l += p;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc[d] = fmaf(p, vs[c0 + j][d], acc[d]);
      }
      m = mnew;
    }
  }

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kDh; ++d) store(&o[head + (size_t)qi * kDh + d], acc[d] * inv);
  }
}

// ---- tensor-core path: bf16, Dh = 64 (every main-path call) ----------------
//
// One block of 4 warps per (b·h, 64-query tile); warp w owns query rows
// 16w..16w+15. Q stays in registers as mma A fragments. Per 64-key tile, K
// and V are staged in shared memory (rows padded to 72 elements so fragment
// reads hit 32 distinct banks), S = Q·Kᵀ and O += P·V run as
// mma.sync.m16n8k16 bf16 with fp32 accumulators, and the online softmax
// keeps the true running row max per row (rows are shared by the 4 lanes of
// a quad, reduced with shuffles). P is rounded to bf16 for the P·V product,
// as the plain version and the TPU kernel do.

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // queries per block
constexpr int kMmaBK = 64;              // keys per tile
constexpr int kMmaD = 64;               // head width
constexpr int kPad = kMmaD + 8;         // padded shared-memory row (elements)

using asis::ld_pair;
using asis::mma_bf16;
using asis::pack_bf16;

__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int N, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBK][kPad];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const size_t head = (size_t)blockIdx.y * N * kMmaD;
  const int r0 = blockIdx.x * kMmaBQ + warp * 16 + gid;  // this thread's two rows
  const int r1 = r0 + 8;

  // Q as A fragments: qa[kk] covers head dims 16kk..16kk+15
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    qa[kk][0] = r0 < N ? ld_pair(q + head + (size_t)r0 * kMmaD + c) : 0u;
    qa[kk][1] = r1 < N ? ld_pair(q + head + (size_t)r1 * kMmaD + c) : 0u;
    qa[kk][2] = r0 < N ? ld_pair(q + head + (size_t)r0 * kMmaD + c + 8) : 0u;
    qa[kk][3] = r1 < N ? ld_pair(q + head + (size_t)r1 * kMmaD + c + 8) : 0u;
  }

  float acc[8][4];  // O: 16 rows × 64 dims per warp, as 8 C fragments
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 domain), rows r0, r1
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kMmaBK * kMmaD / 8; i += kMmaWarps * 32) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;  // keys past N: zeros
      if (k0 + r < N) {
        const size_t off = head + (size_t)(k0 + r) * kMmaD + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    __syncthreads();

    // S = Q·Kᵀ: 8 fragments of 16 rows × 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(s[nt], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale into the log2 domain, mask keys past N, row max over the quad
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = key < N ? s[nt][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key k0 < N is real, so the tile max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= a0;
      acc[nt][1] *= a0;
      acc[nt][2] *= a1;
      acc[nt][3] *= a1;
    }

    // P = exp2(S − m), packed straight into A fragments: keys 16kk..16kk+15
    // are C fragments 2kk (A regs 0, 1) and 2kk+1 (A regs 2, 3)
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m0), p1 = exp2f(s[nt][1] - m0);
      const float p2 = exp2f(s[nt][2] - m1), p3 = exp2f(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P·V; V's B fragments come transposed out of row-major shared memory
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t addr = static_cast<uint32_t>(
            __cvta_generic_to_shared(&vs[kk * 16 + (lane & 15)][nt * 8]));
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(acc[nt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(o + head + (size_t)r0 * kMmaD + c) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(o + head + (size_t)r1 * kMmaD + c) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

int launch_mma(const void* q, const void* k, const void* v, void* o, int BH, int N,
               float scale, cudaStream_t stream) {
  const dim3 grid((N + kMmaBQ - 1) / kMmaBQ, BH);
  flash_fwd_mma_kernel<<<grid, kMmaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N,
      scale * 1.4426950408889634f);  // log2(e): the kernel exponentiates with exp2
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int N,
           float scale, cudaStream_t stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, kDh><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int N,
             int Dh, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, BH, N, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, N, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (BH, N, Dh) in one dtype (is_bf16: bfloat16, else
// float32), Dh one of 16, 32, 64 (64 on the main path). Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int asis_flash_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                   int N, int Dh, float scale, int is_bf16, void* stream) {
  if (BH <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Dh == kMmaD) return launch_mma(q, k, v, o, BH, N, scale, s);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, N, Dh, scale, s)
                 : dispatch<float>(q, k, v, o, BH, N, Dh, scale, s);
}

const char* asis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
