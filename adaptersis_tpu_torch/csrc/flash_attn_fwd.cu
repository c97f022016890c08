// K7 forward: flash attention with segment ids,
//   o = softmax(q·kᵀ·scale + mask)·v,  lse = logsumexp of the same row,
// where a query attends only to keys of its own segment; lse is what the
// backward (flash_attn_bwd.cu) recomputes the probabilities from.
//
// Replaces: the forward of the library Pallas TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: its pallas_call at
// :758, kernel `_flash_attention_kernel` :342), which the JAX package reaches
// from adaptersis_tpu/models/layers.py `_sdpa_flash` (:334) and
// `_flash_bhnd` (:292) with attn_impl="flash": the DINOv2 SSL step's packed
// student crops and its teacher's global crops.
//
// What bounds it on the H100: at the SSL step's shapes (ViT-S/14, batch 32:
// the student's 64·6 heads of N = 457 packed tokens, 257 of a global crop
// and 4 × 50 of local crops; the teacher's 64·6 heads of 257) the counting
// rule bounds it by bytes (q, k, v, o read or written once: ≈ 90 MB for the
// student, ≈ 27 µs at 3.35 TB/s) over operations (7.5 GFLOP at own-segment
// length, ≈ 8 µs at 989 TFLOP/s). The kernel does not skip masked tiles, so
// it computes the full 457² square of scores: the packed layout leaves ≈ 64 %
// of it masked (257² + 4·50² = 76 049 of 208 849 pairs per row), and at
// mma.sync rates those operations, plus the latency of 8 key tiles a block
// walks in order and the launch, bound it. Skipping tiles whose segments
// cannot meet is the first redesign for a later PR; wgmma/TMA the second.
//
// Numerics follow the library kernel: s = (q·kᵀ in fp32) × scale, the scale
// applied after the product; pairs of different segments get the additive
// mask value −0.7·f32max (keys past N, which the TPU padded, do not exist
// here: their score is −inf); the probabilities are rounded to the input
// dtype before p·v; the output is in the input dtype. Unlike the library's
// single-tile path, p is rounded before, not after, its division by the row
// sum (an online softmax cannot know the sum in advance): the output moves
// by at most a bf16 rounding of each p, which chip_smoke.py's bound allows.
// No padding to 128: the ragged tail (N = 457, 257) is masked in the kernel.
//
// Two paths:
//   * bf16 with Dh = 64 (every SSL call): one block of 4 warps per (b·h,
//     64-query tile), mma.sync m16n8k16 bf16 products with fp32
//     accumulators, an online softmax in the log2 domain over 64-key tiles
//     staged in shared memory (fa_fwd_mma_kernel);
//   * fp32, or Dh of 16 or 32 (the parity checks and the narrow models):
//     one thread per query row, fp32 FMAs on the CUDA cores
//     (fa_fwd_kernel), p rounded to bf16 for bf16 inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attn.cuh"
#include "mma.cuh"

namespace {

using asis::kLn2;
using asis::kLog2e;
using asis::kMaskValue;
using asis::ld_pair;
using asis::ldmatrix_x2_trans;
using asis::mma_bf16;
using asis::pack_bf16;
using asis::round_as;
using asis::segment_of;
using asis::store_as;
using asis::to_f32;

// ---- CUDA-core path ---------------------------------------------------------

constexpr int kBQ = 64;     // queries per block (one per thread)
constexpr int kBK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax rescale

template <typename T, int kDh>
__global__ void __launch_bounds__(kBQ)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse, int N,
              int H, float scale) {
  __shared__ __align__(16) float ks[kBK][kDh];
  __shared__ __align__(16) float vs[kBK][kDh];
  __shared__ int kid[kBK];

  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * N * kDh;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int qi = blockIdx.x * kBQ + threadIdx.x;
  const bool active = qi < N;
  const int qid = active ? segment_of(sg, qi) : 0;

  float qr[kDh];
  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = active ? to_f32(q[head + (size_t)qi * kDh + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F;  // running row max (a masked pair counts as kMaskValue)
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
    if (threadIdx.x < kBK && k0 + threadIdx.x < N) kid[threadIdx.x] = segment_of(sg, k0 + threadIdx.x);
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
        const bool real = c0 + j < kn;  // keys past N do not exist
        s[j] = !real ? -CUDART_INF_F : (kid[c0 + j] == qid ? dot * scale : kMaskValue);
        cmax = fmaxf(cmax, s[j]);
      }
      // c0 < kn: the chunk holds a real key, so cmax ≥ kMaskValue is finite
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);  // 0 on the first chunk (m = −inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mnew);  // 0 past N and, once m is real, for masked keys
        l += p;
        const float pr = round_as<T>(p);
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc[d] = fmaf(pr, vs[c0 + j][d], acc[d]);
      }
      m = mnew;
    }
  }

  if (active) {
    // the row's own key is in its segment: m is a real score and l ≥ 1
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kDh; ++d) store_as(&o[head + (size_t)qi * kDh + d], acc[d] * inv);
    lse[(size_t)bh * N + qi] = m + logf(l);
  }
}

// ---- tensor-core path: bf16, Dh = 64 ---------------------------------------
//
// One block of 4 warps per (b·h, 64-query tile); warp w owns query rows
// 16w..16w+15, each held by the 4 lanes of a quad. Q stays in registers as
// mma A fragments; per 64-key tile, K and V are staged in shared memory
// (rows padded to 72 elements so fragment reads hit 32 distinct banks) with
// the keys' segment ids, S = Q·Kᵀ and O += P·V run as mma.sync m16n8k16 with
// fp32 accumulators, and the online softmax keeps the running row max in the
// log2 domain.

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // queries per block
constexpr int kMmaBK = 64;              // keys per tile
constexpr int kMmaD = 64;               // head width
constexpr int kPad = kMmaD + 8;         // padded shared-memory row (elements)

__global__ void __launch_bounds__(kMmaWarps * 32)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int N, int H,
                  float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBK][kPad];
  __shared__ int kid[kMmaBK];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * N * kMmaD;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int r0 = blockIdx.x * kMmaBQ + warp * 16 + gid;  // this thread's two rows
  const int r1 = r0 + 8;
  const int id0 = r0 < N ? segment_of(sg, r0) : 0;
  const int id1 = r1 < N ? segment_of(sg, r1) : 0;

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
    if (threadIdx.x < kMmaBK && k0 + threadIdx.x < N) kid[threadIdx.x] = segment_of(sg, k0 + threadIdx.x);
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

    // scale into the log2 domain, mask, row max over the quad
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + tig * 2 + (e & 1);
        const int id = e < 2 ? id0 : id1;
        s[nt][e] = k0 + key >= N ? -CUDART_INF_F
                                 : (kid[key] == id ? s[nt][e] * scale_log2 : kMaskValue);
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key k0 < N exists, so the tile max is finite (≥ kMaskValue)
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
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[kk * 16 + (lane & 15)][nt * 8]);
        mma_bf16(acc[nt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // each row's own key is in its segment: m is a real score and l ≥ 1
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
  if (tig == 0) {
    if (r0 < N) lse[(size_t)bh * N + r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < N) lse[(size_t)bh * N + r1] = (m1 + log2f(l1)) * kLn2;
  }
}

template <typename T, int kDh>
int launch(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse,
           int BH, int H, int N, float scale, cudaStream_t stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, BH);
  fa_fwd_kernel<T, kDh><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(o), lse, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse,
             int BH, int H, int N, int Dh, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, seg, o, lse, BH, H, N, scale, s);
    case 32: return launch<T, 32>(q, k, v, seg, o, lse, BH, H, N, scale, s);
    case 64: return launch<T, 64>(q, k, v, seg, o, lse, BH, H, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B·H, N, Dh) in one dtype (is_bf16: bfloat16, else
// float32), Dh one of 16, 32, 64; seg: contiguous (B, N) int32 segment ids,
// or null for one segment; lse: (B·H, N) float32, natural log. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int asis_flash_attn_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                        float* lse, int B, int H, int N, int Dh, float scale, int is_bf16,
                        void* stream) {
  const int BH = B * H;
  if (B <= 0 || H <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Dh == kMmaD) {
    const dim3 grid((N + kMmaBQ - 1) / kMmaBQ, BH);
    fa_fwd_mma_kernel<<<grid, kMmaWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(o), lse, N, H,
        scale * kLog2e);  // the kernel exponentiates with exp2
    return static_cast<int>(cudaGetLastError());
  }
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, seg, o, lse, BH, H, N, Dh, scale, s)
                 : dispatch<float>(q, k, v, seg, o, lse, BH, H, N, Dh, scale, s);
}

}  // extern "C"
