// K7 backward: the gradients of flash attention with segment ids,
//   p  = exp(q·kᵀ·scale + mask − lse)      (recomputed from the forward's lse)
//   dv = pᵀ·do,  dp = do·vᵀ,  ds = p·(dp − di)·scale,  dk = dsᵀ·q,  dq = ds·k,
// with di = Σ o·do per row, which the wrapper computes in fp32 beforehand.
//
// Replaces: the backward of the library Pallas TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the dK/dV pallas_call
// at :1121 with kernel `_flash_attention_dkv_kernel` :796, and the dQ
// pallas_call at :1456 with kernel `_flash_attention_dq_kernel` :1146),
// reached from adaptersis_tpu/models/layers.py `_sdpa_flash` (:334) when the
// DINOv2 SSL step trains its student through the packed crops.
//
// The library's split is kept: one kernel walks the queries for a tile of
// keys and accumulates dK and dV in registers; the other walks the keys for
// a tile of queries and accumulates dQ. Each output element is summed by one
// thread in a fixed order: no atomics, and the result is reproducible.
//
// What bounds it on the H100: at the SSL step's student shape (64·6 heads of
// N = 457 packed tokens, Dh = 64, bf16) the counting rule bounds it by bytes
// (q, k, v, do, the row statistics read once, dq, dk, dv written once:
// ≈ 158 MB, ≈ 47 µs at 3.35 TB/s) over operations (5 products of the
// own-segment pairs, 18.7 GFLOP, ≈ 19 µs at 989 TFLOP/s). The kernels
// recompute the scores and skip no masked tile: they do the full 457²
// square, ≈ 64 % of it masked by the packed layout (257² + 4·50² = 76 049 of
// 208 849 pairs per row), the dQ kernel recomputing q·kᵀ and do·vᵀ that the
// dK/dV kernel also computes; at mma.sync rates those operations, and at
// these short sequences the latency of the 8 tiles each block walks in
// order, bound them. Skipping tiles whose segments cannot meet is the first
// redesign for a later PR.
//
// Rounding points follow the library kernels: p and ds are computed in fp32
// and rounded to the input dtype before the products dv = pᵀ·do, dk = dsᵀ·q
// and dq = ds·k (p.astype(do.dtype), ds.astype(k.dtype)); dp − di uses the
// unrounded p; the outputs are rounded once to the input dtype.
//
// Two paths, as in the forward:
//   * bf16 with Dh = 64: blocks of 4 warps, mma.sync m16n8k16 bf16 products
//     with fp32 accumulators (fa_bwd_dkv_mma_kernel, fa_bwd_dq_mma_kernel);
//   * fp32, or Dh of 16 or 32: one thread per key (dK/dV) or query (dQ)
//     row, fp32 FMAs on the CUDA cores (fa_bwd_dkv_kernel, fa_bwd_dq_kernel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attn.cuh"
#include "mma.cuh"

namespace {

using asis::kLog2e;
using asis::ld_pair;
using asis::ldmatrix_x2_trans;
using asis::mma_bf16;
using asis::pack_bf16;
using asis::round_as;
using asis::segment_of;
using asis::store_as;
using asis::to_f32;

// ---- CUDA-core path ---------------------------------------------------------
//
// One thread per row of the block's own tile (64 rows); its two input rows
// live in shared memory (padded to an odd stride, so the 64 threads reading
// their own rows hit distinct banks) and its two accumulators in registers.
// The other side is staged 16 rows at a time and read as broadcasts.

constexpr int kRows = 64;  // own rows per block, one per thread
constexpr int kStep = 16;  // rows of the other side per staged tile

// Own tile = keys; walks the queries.
template <typename T, int kDh>
__global__ void __launch_bounds__(kRows)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, const int* __restrict__ seg, T* __restrict__ dk,
                  T* __restrict__ dv, int N, int H, float scale) {
  __shared__ float own_k[kRows][kDh + 1];
  __shared__ float own_v[kRows][kDh + 1];
  __shared__ float qs[kStep][kDh];
  __shared__ float dos[kStep][kDh];
  __shared__ float lse_s[kStep], di_s[kStep];
  __shared__ int qid[kStep];

  const int bh = blockIdx.y, t = threadIdx.x;
  const size_t head = (size_t)bh * N * kDh;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int kb = blockIdx.x * kRows;
  for (int i = t; i < kRows * kDh; i += kRows) {
    const int r = i / kDh, c = i % kDh;
    const bool in = kb + r < N;
    own_k[r][c] = in ? to_f32(k[head + (size_t)(kb + r) * kDh + c]) : 0.f;
    own_v[r][c] = in ? to_f32(v[head + (size_t)(kb + r) * kDh + c]) : 0.f;
  }
  const int key = kb + t;
  const bool kreal = key < N;
  const int kid = kreal ? segment_of(sg, key) : 0;

  float dka[kDh], dva[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kStep) {
    __syncthreads();  // own rows written / the previous tile no longer read
    for (int i = t; i < kStep * kDh; i += kRows) {
      const int r = i / kDh, c = i % kDh;
      const bool in = q0 + r < N;
      const size_t off = head + (size_t)(q0 + r) * kDh + c;
      qs[r][c] = in ? to_f32(q[off]) : 0.f;
      dos[r][c] = in ? to_f32(dout[off]) : 0.f;
    }
    if (t < kStep) {
      const bool in = q0 + t < N;
      lse_s[t] = in ? lse[(size_t)bh * N + q0 + t] : 0.f;
      di_s[t] = in ? di[(size_t)bh * N + q0 + t] : 0.f;
      qid[t] = in ? segment_of(sg, q0 + t) : 0;
    }
    __syncthreads();

    const int qn = min(kStep, N - q0);
    for (int j = 0; j < qn; ++j) {
      if (!kreal || qid[j] != kid) continue;  // p = 0: no contribution
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        s = fmaf(own_k[t][d], qs[j][d], s);
        dp = fmaf(own_v[t][d], dos[j][d], dp);
      }
      const float p = expf(s * scale - lse_s[j]);
      const float ds = (dp - di_s[j]) * p * scale;
      const float pr = round_as<T>(p), dsr = round_as<T>(ds);
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        dva[d] = fmaf(pr, dos[j][d], dva[d]);
        dka[d] = fmaf(dsr, qs[j][d], dka[d]);
      }
    }
  }
  if (kreal) {
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      store_as(&dk[head + (size_t)key * kDh + d], dka[d]);
      store_as(&dv[head + (size_t)key * kDh + d], dva[d]);
    }
  }
}

// Own tile = queries; walks the keys.
template <typename T, int kDh>
__global__ void __launch_bounds__(kRows)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, const int* __restrict__ seg, T* __restrict__ dq,
                 int N, int H, float scale) {
  __shared__ float own_q[kRows][kDh + 1];
  __shared__ float own_do[kRows][kDh + 1];
  __shared__ float ks[kStep][kDh];
  __shared__ float vs[kStep][kDh];
  __shared__ int kid[kStep];

  const int bh = blockIdx.y, t = threadIdx.x;
  const size_t head = (size_t)bh * N * kDh;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int qb = blockIdx.x * kRows;
  for (int i = t; i < kRows * kDh; i += kRows) {
    const int r = i / kDh, c = i % kDh;
    const bool in = qb + r < N;
    own_q[r][c] = in ? to_f32(q[head + (size_t)(qb + r) * kDh + c]) : 0.f;
    own_do[r][c] = in ? to_f32(dout[head + (size_t)(qb + r) * kDh + c]) : 0.f;
  }
  const int row = qb + t;
  const bool qreal = row < N;
  const int qid = qreal ? segment_of(sg, row) : 0;
  const float lse_r = qreal ? lse[(size_t)bh * N + row] : 0.f;
  const float di_r = qreal ? di[(size_t)bh * N + row] : 0.f;

  float dqa[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) dqa[d] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kStep) {
    __syncthreads();
    for (int i = t; i < kStep * kDh; i += kRows) {
      const int r = i / kDh, c = i % kDh;
      const bool in = k0 + r < N;
      const size_t off = head + (size_t)(k0 + r) * kDh + c;
      ks[r][c] = in ? to_f32(k[off]) : 0.f;
      vs[r][c] = in ? to_f32(v[off]) : 0.f;
    }
    if (t < kStep) kid[t] = k0 + t < N ? segment_of(sg, k0 + t) : 0;
    __syncthreads();

    const int kn = min(kStep, N - k0);
    for (int j = 0; j < kn; ++j) {
      if (!qreal || kid[j] != qid) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        s = fmaf(own_q[t][d], ks[j][d], s);
        dp = fmaf(own_do[t][d], vs[j][d], dp);
      }
      const float p = expf(s * scale - lse_r);
      const float dsr = round_as<T>((dp - di_r) * p * scale);
#pragma unroll
      for (int d = 0; d < kDh; ++d) dqa[d] = fmaf(dsr, ks[j][d], dqa[d]);
    }
  }
  if (qreal) {
#pragma unroll
    for (int d = 0; d < kDh; ++d) store_as(&dq[head + (size_t)row * kDh + d], dqa[d]);
  }
}

// ---- tensor-core path: bf16, Dh = 64 ---------------------------------------
//
// Blocks of 4 warps; warp w owns rows 16w..16w+15 of the block's 64-row
// tile, each row held by the 4 lanes of a quad. Tiles of 64 rows of the
// other side are staged in shared memory (rows padded to 72 elements), with
// their segment ids and row statistics. Scores and probabilities stay in C
// fragments; p and ds are rounded to bf16 and repacked as A fragments for
// the second products, whose B fragments come transposed out of row-major
// shared memory (ldmatrix .trans).

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // rows per block and per staged tile
constexpr int kD = 64;              // head width
constexpr int kPad = kD + 8;        // padded shared-memory row (elements)

using Tile = __nv_bfloat16[kTile][kPad];

// 64 rows × 64 dims of a (N, 64) bf16 head into shared memory, zeros past N.
__device__ __forceinline__ void stage(Tile& dst, const __nv_bfloat16* __restrict__ src, int r0,
                                      int N) {
  for (int i = threadIdx.x; i < kTile * kD / 8; i += kWarps * 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kD + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = x;
  }
}

// The A fragment of rows row..row+15 (this warp's), dims 16kk..16kk+15 of a
// staged tile.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const Tile& t, int row, int kk,
                                       int gid, int tig) {
  const int c = kk * 16 + tig * 2;
  a[0] = ld_pair(&t[row + gid][c]);
  a[1] = ld_pair(&t[row + gid + 8][c]);
  a[2] = ld_pair(&t[row + gid][c + 8]);
  a[3] = ld_pair(&t[row + gid + 8][c + 8]);
}

// c[nt] += A(16 × 64) · B(64 × 64)ᵀ where B's rows are the staged tile's
// rows: 8 fragments of 16 rows × 8 of the tile's rows.
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const Tile& b, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* br = &b[nt * 8 + gid][kk * 16 + tig * 2];
      mma_bf16(c[nt], a[kk], ld_pair(br), ld_pair(br + 8));
    }
  }
}

// acc[nt] += A(16 × 64 tile rows) · B(64 tile rows × 64 dims), B staged.
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const Tile& b, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &b[kk * 16 + (lane & 15)][nt * 8]);
      mma_bf16(acc[nt], a[kk], b0, b1);
    }
  }
}

// C fragments (16 rows × 64 columns) as bf16 A fragments over those columns.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// Store C fragments of rows r0 (regs 0, 1) and r0 + 8 (regs 2, 3) as bf16.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&c)[8][4],
                                           int r0, int N, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * kD + col) = pack_bf16(c[nt][0], c[nt][1]);
    if (r0 + 8 < N)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * kD + col) =
          pack_bf16(c[nt][2], c[nt][3]);
  }
}

// Own tile = 64 keys; walks the queries. Per query tile, for this warp's 16
// keys: Sᵀ = K·Qᵀ → Pᵀ; dV += Pᵀ·dO; dPᵀ = V·dOᵀ → dSᵀ; dK += dSᵀ·Q.
__global__ void __launch_bounds__(kWarps * 32)
fa_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int N, int H, float scale) {
  __shared__ __align__(16) Tile ks, vs, qs, dos;
  __shared__ float lse_s[kTile], di_s[kTile];
  __shared__ int qid[kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * N * kD;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int kb = blockIdx.x * kTile;
  const int kr0 = kb + warp * 16 + gid, kr1 = kr0 + 8;  // this thread's two keys
  const int kid0 = kr0 < N ? segment_of(sg, kr0) : 0;
  const int kid1 = kr1 < N ? segment_of(sg, kr1) : 0;
  const float scale_log2 = scale * kLog2e;
  stage(ks, k + head, kb, N);
  stage(vs, v + head, kb, N);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage(qs, q + head, q0, N);
    stage(dos, dout + head, q0, N);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const bool in = r < N;
      lse_s[threadIdx.x] = in ? lse[(size_t)bh * N + r] * kLog2e : 0.f;
      di_s[threadIdx.x] = in ? di[(size_t)bh * N + r] : 0.f;
      qid[threadIdx.x] = in ? segment_of(sg, r) : 0;
    }
    __syncthreads();

    uint32_t a[4][4];
    float p[8][4];  // Sᵀ, then Pᵀ in fp32: rows = keys, columns = queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], ks, warp * 16, kk, gid, tig);
    mma_abt(p, a, qs, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);
        const bool ok = q0 + j < N && (e < 2 ? kr0 < N && qid[j] == kid0
                                             : kr1 < N && qid[j] == kid1);
        p[nt][e] = ok ? exp2f(p[nt][e] * scale_log2 - lse_s[j]) : 0.f;
      }
    }
    uint32_t pa[4][4];
    to_a(pa, p);
    mma_ab(dva, pa, dos, lane);

    float ds[8][4];  // dPᵀ, then dSᵀ
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], vs, warp * 16, kk, gid, tig);
    mma_abt(ds, a, dos, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);
        ds[nt][e] = (ds[nt][e] - di_s[j]) * p[nt][e] * scale;
      }
    }
    to_a(pa, ds);
    mma_ab(dka, pa, qs, lane);
  }
  store_rows(dk + head, dka, kr0, N, tig);
  store_rows(dv + head, dva, kr0, N, tig);
}

// Own tile = 64 queries; walks the keys. Per key tile, for this warp's 16
// queries: S = Q·Kᵀ → P; dP = dO·Vᵀ → dS; dQ += dS·K.
__global__ void __launch_bounds__(kWarps * 32)
fa_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int N, int H,
                     float scale) {
  __shared__ __align__(16) Tile qs, dos, ks, vs;
  __shared__ int kid[kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * N * kD;
  const int* sg = seg ? seg + (size_t)(bh / H) * N : nullptr;
  const int qb = blockIdx.x * kTile;
  const int r0 = qb + warp * 16 + gid, r1 = r0 + 8;  // this thread's two queries
  const int id0 = r0 < N ? segment_of(sg, r0) : 0;
  const int id1 = r1 < N ? segment_of(sg, r1) : 0;
  const float scale_log2 = scale * kLog2e;
  const float lse0 = r0 < N ? lse[(size_t)bh * N + r0] * kLog2e : 0.f;
  const float lse1 = r1 < N ? lse[(size_t)bh * N + r1] * kLog2e : 0.f;
  const float di0 = r0 < N ? di[(size_t)bh * N + r0] : 0.f;
  const float di1 = r1 < N ? di[(size_t)bh * N + r1] : 0.f;
  stage(qs, q + head, qb, N);
  stage(dos, dout + head, qb, N);
  __syncthreads();
  uint32_t qa[4][4], doa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a_frag(qa[kk], qs, warp * 16, kk, gid, tig);
    a_frag(doa[kk], dos, warp * 16, kk, gid, tig);
  }

  float dqa[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage(ks, k + head, k0, N);
    stage(vs, v + head, k0, N);
    if (threadIdx.x < kTile) {
      const int r = k0 + threadIdx.x;
      kid[threadIdx.x] = r < N ? segment_of(sg, r) : 0;
    }
    __syncthreads();

    float p[8][4], ds[8][4];  // S → P, and dP → dS: rows = queries, columns = keys
    mma_abt(p, qa, ks, gid, tig);
    mma_abt(ds, doa, vs, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);
        const bool lo = e < 2;
        const bool ok = k0 + j < N && (lo ? r0 < N && kid[j] == id0 : r1 < N && kid[j] == id1);
        const float pe = ok ? exp2f(p[nt][e] * scale_log2 - (lo ? lse0 : lse1)) : 0.f;
        ds[nt][e] = (ds[nt][e] - (lo ? di0 : di1)) * pe * scale;
      }
    }
    uint32_t dsa[4][4];
    to_a(dsa, ds);
    mma_ab(dqa, dsa, ks, lane);
  }
  store_rows(dq + head, dqa, r0, N, tig);
}

template <typename T, int kDh>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* di, const int* seg, void* dq, void* dk, void* dv, int BH, int H, int N,
           float scale, cudaStream_t s) {
  const dim3 grid((N + kRows - 1) / kRows, BH);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  fa_bwd_dkv_kernel<T, kDh><<<grid, kRows, 0, s>>>(tq, tk, tv, tdo, lse, di, seg,
                                                   static_cast<T*>(dk), static_cast<T*>(dv), N,
                                                   H, scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dq_kernel<T, kDh><<<grid, kRows, 0, s>>>(tq, tk, tv, tdo, lse, di, seg,
                                                  static_cast<T*>(dq), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* di, const int* seg, void* dq, void* dk, void* dv, int BH, int H,
             int N, int Dh, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, scale, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, scale, s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, do and dq, dk, dv: contiguous (B·H, N, Dh) in one dtype (is_bf16:
// bfloat16, else float32), Dh one of 16, 32, 64; lse (the forward's, natural
// log) and di = Σ o·do: (B·H, N) float32; seg: contiguous (B, N) int32
// segment ids, or null for one segment. Launches the dK/dV kernel, then the
// dQ kernel, on `stream`; returns the first cudaGetLastError() that is not 0.
int asis_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* di, const int* seg, void* dq, void* dk,
                        void* dv, int B, int H, int N, int Dh, float scale, int is_bf16,
                        void* stream) {
  const int BH = B * H;
  if (B <= 0 || H <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Dh == kD) {
    using bf = __nv_bfloat16;
    const dim3 grid((N + kTile - 1) / kTile, BH);
    const bf *tq = static_cast<const bf*>(q), *tk = static_cast<const bf*>(k);
    const bf *tv = static_cast<const bf*>(v), *tdo = static_cast<const bf*>(dout);
    fa_bwd_dkv_mma_kernel<<<grid, kWarps * 32, 0, s>>>(tq, tk, tv, tdo, lse, di, seg,
                                                       static_cast<bf*>(dk), static_cast<bf*>(dv),
                                                       N, H, scale);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    fa_bwd_dq_mma_kernel<<<grid, kWarps * 32, 0, s>>>(tq, tk, tv, tdo, lse, di, seg,
                                                      static_cast<bf*>(dq), N, H, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, Dh,
                                           scale, s)
                 : dispatch<float>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, Dh, scale,
                                   s);
}

}  // extern "C"
