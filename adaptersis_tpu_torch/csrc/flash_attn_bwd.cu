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
// own-segment pairs, 18.7 GFLOP, ≈ 19 µs at 989 TFLOP/s). The packed layout
// leaves ≈ 64 % of the 457² square masked (257² + 4·50² = 76 049 of 208 849
// pairs per row); the kernels walk only the 64 × 64 tile pairs whose
// segments can meet (34 of 64), and do 7 products on each (the dQ kernel
// recomputes S and dP rather than exchange them through memory), with the
// softmax's exp2 between the products; at 1 to 6 walked tiles per unit the
// latency of each tile's dependent chain S → P → dV, dP → dS → dK bounds a
// warpgroup, so two consumer warpgroups per SM interleave theirs.
//
// Rounding points follow the library kernels: p and ds are computed in fp32
// and rounded to the input dtype before the products dv = pᵀ·do, dk = dsᵀ·q
// and dq = ds·k (p.astype(do.dtype), ds.astype(k.dtype)); dp − di uses the
// unrounded p; the outputs are rounded once to the input dtype.
//
// Three paths, as in the forward, each reported to the caller:
//   * bf16 with Dh = 64: wgmma products fed by TMA, tiles whose segments
//     cannot meet skipped (fa_bwd_wgmma_kernel<true> for dK/dV, <false> for
//     dQ, below);
//   * fp32 with Dh = 64: 3×TF32 wgmma products, the same tiles skipped
//     (fa_bwd_tf32_kernel<true>, <false>, below; what bounds them is there);
//   * Dh of 16 or 32: one thread per key (dK/dV) or query (dQ) row, fp32
//     FMAs on the CUDA cores over every pair (fa_bwd_dkv_kernel,
//     fa_bwd_dq_kernel).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "flash_attn.cuh"
#include "hopper.cuh"
#include "bf16.cuh"

namespace {

using asis::kLog2e;
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

// ---- Hopper path: bf16, Dh = 64 (every SSL call) ---------------------------
//
// The split of the library kernels, on K3's machinery (flash_fwd.cu): a
// dK/dV kernel whose units are 64 keys of one head, walking the query
// tiles, and a dQ kernel whose units are 64 queries, walking the key tiles;
// every tile is 64 rows, and only the tiles whose segment range meets the
// unit's are walked (`next_live`). Each output element is summed by one
// thread in a fixed order: no atomics, and the bits are the same from call
// to call. Both are one kernel template (kDkv): one persistent CTA of three
// warpgroups per SM; each of the two consumer warpgroups walks its own
// units (`unit_at`) with its own pipeline, fed by one warp of the producer
// warpgroup. Lane 0 of that warp loads the unit's own two tiles by TMA into
// one of two buffers (K and V, or Q and dO), then streams the walked tiles
// into a 3-stage ring (Q, dO and the lse and di slices; or K and V), each
// stage with a header naming its tile, whether it needs the per-element
// segment mask and whether it is the unit's last.
//
// dK/dV, per walked query tile, for the warpgroup's 64 keys (rows) and the
// tile's 64 queries (columns), all as wgmma with fp32 accumulators:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ   (m64n64k16, both operands K-major in shared
//                                memory, issued together),
//   Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e)   (once Sᵀ is in, while dPᵀ runs),
//   dV += Pᵀ·dO                 (m64n64k16, Pᵀ rounded to bf16 in registers
//                                as the A operand, dO MN-major),
//   dSᵀ = Pᵀ ⊙ (dPᵀ − di)·scale,
//   dK += dSᵀ·Q                 (dSᵀ rounded to bf16 in registers, Q MN-major).
// dQ, per walked key tile, for the warpgroup's 64 queries and the tile's 64
// keys: S = Q·Kᵀ and dP = dO·Vᵀ, P, dS, then dQ += dS·K (K MN-major: the
// same shared tile serves both products). A 64-wide bf16 row is one
// 128-byte swizzle atom, so every tile is written by TMA in the layout the
// wgmma descriptors name (hopper.cuh `sw128_desc`). Pairs of different
// segments (on a straddling tile) and columns ≥ N (in the last tile) get
// p = 0 and ds = 0; rows ≥ N are not stored. The 3-D tensor maps (B·H, N,
// 64) zero the rows past a head's N; the lse and di slices come through a
// 1-D map over the B·H·N values, whose columns past N are masked.

namespace hw = asis::hopper;
using asis::kLast;
using asis::kUniform;
using asis::next_live;
using asis::unit_at;

constexpr int kTileRows = 64;                 // rows per unit and per walked tile
constexpr int kBufs = 2;                  // own-tile buffers per consumer warpgroup
constexpr int kStages = 3;                // ring depth per consumer warpgroup
constexpr int kTileBytes = kTileRows * 64 * 2;
constexpr int kRegion = (2 * kBufs + 2 * kStages) * kTileBytes;  // per consumer warpgroup
constexpr int kThreads = 3 * 128;

struct BwdCtl {
  uint64_t own_full[kBufs], own_empty[kBufs], full[kStages], empty[kStages];
  int tile[kStages], flags[kStages];
};
// The dK/dV kernel's lse and di slices of each stage. TMA takes a 1-D box
// only from a 16-byte aligned start, so a slice is loaded from the start
// rounded down to 4 values, 4 more than the tile's 64, and read at the
// offset the rounding took off; each lands 128-byte aligned, as TMA
// requires of its destination.
constexpr int kVecBox = kTileRows + 4;
struct alignas(128) BwdVec {
  float lse[kStages][96], di[kStages][96];
};
constexpr int kSmemBytes = 2 * kRegion + 2 * static_cast<int>(sizeof(BwdVec)) +
                           2 * static_cast<int>(sizeof(BwdCtl)) + 1024;

// The products of one walked tile, as groups of four k-steps over the head
// width (ss: both from shared memory) or over the tile's 64 rows (rs: A from
// registers, B MN-major). Each group's register operands are pinned before
// wgmma.fence and after the commit, as CUTLASS fences them.
__device__ __forceinline__ void issue_ss2(float (&c0)[32], uint64_t a0, uint64_t b0,
                                          float (&c1)[32], uint64_t a1, uint64_t b1) {
  hw::fence_regs(c0);
  hw::fence_regs(c1);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hw::wgmma_m64n64k16_ss(c0, a0 + 2 * kk, b0 + 2 * kk, kk);
  hw::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hw::wgmma_m64n64k16_ss(c1, a1 + 2 * kk, b1 + 2 * kk, kk);
  hw::wgmma_commit();
  hw::fence_regs(c0);
  hw::fence_regs(c1);
}

__device__ __forceinline__ void issue_rs(float (&acc)[32], uint32_t (&a)[16], uint64_t b) {
  hw::fence_regs(acc);
  hw::fence_regs(a);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hw::wgmma_m64n64k16_rs(acc, a + 4 * kk, b + 128 * kk);
  hw::wgmma_commit();
  hw::fence_regs(acc);
  hw::fence_regs(a);
}

// fp32 accumulator (64 × 64) as bf16 A fragments over its columns.
__device__ __forceinline__ void pack(const float (&c)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// Store an accumulator's rows r0 (registers 4i, 4i + 1) and r0 + 8 (4i + 2,
// 4i + 3) at columns 8i + 2·tig (+1) as bf16, rows < N only.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ head,
                                           const float (&c)[32], int r0, int N, int tig) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = i * 8 + tig * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0) * 64 + col) =
          pack_bf16(c[4 * i], c[4 * i + 1]);
    if (r0 + 8 < N)
      *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0 + 8) * 64 + col) =
          pack_bf16(c[4 * i + 2], c[4 * i + 3]);
  }
}

// dK/dV: Pᵀ in place of Sᵀ and dSᵀ in place of dPᵀ, once each is in (a tile
// of 64 keys × 4n queries: the bf16 kernel's n = 32, the fp32 one's 16). Rows
// are this thread's keys kr0, kr0 + 8, columns the tile's queries q0 + col;
// lse2 = lse·log2e and di per column from the stage's slices. kMasked: a
// straddling tile, or one past N on either side.
template <bool kMasked, int n>
__device__ __forceinline__ void p_transposed(float (&st)[n], const float* __restrict__ lse_s,
                                             const int* __restrict__ sg, int q0, int kr0,
                                             int kid0, int kid1, int N, int tig, float sl2) {
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tig + e;
      const float l2 = lse_s[col] * kLog2e;
      float p0 = hw::ex2(fmaf(st[4 * j + e], sl2, -l2));
      float p1 = hw::ex2(fmaf(st[4 * j + 2 + e], sl2, -l2));
      if (kMasked) {
        const int q = q0 + col;
        const int qid = q < N ? (sg ? __ldg(sg + q) : 0) : 0;
        p0 = q < N && kr0 < N && qid == kid0 ? p0 : 0.f;
        p1 = q < N && kr0 + 8 < N && qid == kid1 ? p1 : 0.f;
      }
      st[4 * j + e] = p0;
      st[4 * j + 2 + e] = p1;
    }
  }
}

template <int n>
__device__ __forceinline__ void ds_transposed(float (&dp)[n], const float (&p)[n],
                                              const float* __restrict__ di_s, int tig,
                                              float scale) {
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = di_s[8 * j + 2 * tig + e];
      dp[4 * j + e] = (dp[4 * j + e] - d) * p[4 * j + e] * scale;
      dp[4 * j + 2 + e] = (dp[4 * j + 2 + e] - d) * p[4 * j + 2 + e] * scale;
    }
  }
}

// dQ: P in place of S. Rows are this thread's queries r0, r0 + 8 (lse2 per
// row), columns the tile's keys k0 + col.
template <bool kMasked, int n>
__device__ __forceinline__ void p_rows(float (&s)[n], const int* __restrict__ sg, int k0,
                                       int r0, int id0, int id1, float l20, float l21, int N,
                                       int tig, float sl2) {
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = hw::ex2(fmaf(s[4 * j + e], sl2, -l20));
      float p1 = hw::ex2(fmaf(s[4 * j + 2 + e], sl2, -l21));
      if (kMasked) {
        const int key = k0 + 8 * j + 2 * tig + e;
        const int kid = key < N ? (sg ? __ldg(sg + key) : 0) : 0;
        p0 = key < N && r0 < N && kid == id0 ? p0 : 0.f;
        p1 = key < N && r0 + 8 < N && kid == id1 ? p1 : 0.f;
      }
      s[4 * j + e] = p0;
      s[4 * j + 2 + e] = p1;
    }
  }
}

// kDkv: the dK/dV kernel (own = K, V; walked = Q, dO with the lse and di
// slices; outputs dK, dV). Else the dQ kernel (own = Q, dO; walked = K, V;
// output dQ; lse and di read per row).
template <bool kDkv>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap own0, const __grid_constant__ CUtensorMap own1,
                    const __grid_constant__ CUtensorMap walk0,
                    const __grid_constant__ CUtensorMap walk1,
                    const __grid_constant__ CUtensorMap lse_map,
                    const __grid_constant__ CUtensorMap di_map, const float* __restrict__ lse,
                    const float* __restrict__ di, const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1,
                    int* __restrict__ walked, int BH, int H, int N, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hw::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = hw::smem_u32(smem);
  BwdVec* vec = reinterpret_cast<BwdVec*>(smem + 2 * kRegion);
  BwdCtl* ctl = reinterpret_cast<BwdCtl*>(smem + 2 * kRegion + 2 * sizeof(BwdVec));

  const int units = (N + kTileRows - 1) / kTileRows;  // per head; also walked tiles per unit
  const int total = BH * units;
  const int G = 2 * gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kStageBytes = 2 * kTileBytes + (kDkv ? 2 * kVecBox * 4 : 0);

  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g) {
      BwdCtl& c = ctl[g];
      for (int b = 0; b < kBufs; ++b) {
        hw::mbar_init(hw::smem_u32(&c.own_full[b]), 1);
        hw::mbar_init(hw::smem_u32(&c.own_empty[b]), 4);
      }
      for (int s = 0; s < kStages; ++s) {
        hw::mbar_init(hw::smem_u32(&c.full[s]), 1);
        hw::mbar_init(hw::smem_u32(&c.empty[s]), 4);
      }
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // region of warpgroup g: own0[kBufs], own1[kBufs], walk0[kStages],
  // walk1[kStages], one tile each. Unit k of a warpgroup uses own buffer
  // k % kBufs (phase (k / kBufs) & 1); its kv-th walked tile ring stage
  // kv % kStages (phase (kv / kStages) & 1).
  if (warp < 4) {
    // ---- producer: warp g feeds consumer warpgroup g
    hw::regs_dealloc<40>();
    if (warp < 2) {
      BwdCtl& c = ctl[warp];
      BwdVec& v = vec[warp];
      const uint32_t region = base + warp * kRegion;
      const uint32_t sO0 = region, sO1 = sO0 + kBufs * kTileBytes;
      const uint32_t sW0 = sO1 + kBufs * kTileBytes, sW1 = sW0 + kStages * kTileBytes;
      const int w = 2 * blockIdx.x + warp;
      int kv = 0;
      for (int k = 0;; ++k) {
        const int u = unit_at(w, k, G);
        if (u >= total) break;
        const int bh = u / units, r0 = (u % units) * kTileRows, b = k % kBufs;
        const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
        const int2 own = sg ? asis::id_range(sg, r0, kTileRows, N, lane) : make_int2(0, 0);
        if (lane == 0) {
          const uint32_t full = hw::smem_u32(&c.own_full[b]);
          // the buffer's previous unit has had its last products
          hw::mbar_wait(hw::smem_u32(&c.own_empty[b]), ((k / kBufs) & 1) ^ 1);
          hw::mbar_expect_tx(full, 2 * kTileBytes);
          hw::tma_load_3d(sO0 + b * kTileBytes, &own0, full, 0, r0, bh);
          hw::tma_load_3d(sO1 + b * kTileBytes, &own1, full, 0, r0, bh);
        }
        bool uni, uni_next;
        int j = next_live(sg, own, 0, units, kTileRows, N, lane, uni);
        while (j < units) {
          const int nxt = next_live(sg, own, j + 1, units, kTileRows, N, lane, uni_next);
          if (lane == 0) {
            const int s = kv % kStages;
            const uint32_t full = hw::smem_u32(&c.full[s]);
            // the stage's previous tile has been read (passes at once in round 0)
            hw::mbar_wait(hw::smem_u32(&c.empty[s]), ((kv / kStages) & 1) ^ 1);
            c.tile[s] = j;
            c.flags[s] = (uni ? kUniform : 0) | (nxt >= units ? kLast : 0);
            hw::mbar_expect_tx(full, kStageBytes);
            hw::tma_load_3d(sW0 + s * kTileBytes, &walk0, full, 0, j * kTileRows, bh);
            hw::tma_load_3d(sW1 + s * kTileBytes, &walk1, full, 0, j * kTileRows, bh);
            if (kDkv) {
              const int at = (bh * N + j * kTileRows) & ~3;
              hw::tma_load_1d(hw::smem_u32(v.lse[s]), &lse_map, full, at);
              hw::tma_load_1d(hw::smem_u32(v.di[s]), &di_map, full, at);
            }
          }
          __syncwarp();
          ++kv;
          j = nxt;
          uni = uni_next;
        }
      }
      if (walked != nullptr && lane == 0) atomicAdd(walked, kv);
    }
    return;
  }

  // ---- consumer warpgroup g
  hw::regs_alloc<232>();
  const int g = (warp >> 2) - 1;
  BwdCtl& c = ctl[g];
  const BwdVec& v = vec[g];
  const uint32_t region = base + g * kRegion;
  const uint32_t sO0 = region, sO1 = sO0 + kBufs * kTileBytes;
  const uint32_t sW0 = sO1 + kBufs * kTileBytes, sW1 = sW0 + kStages * kTileBytes;
  const int w = 2 * blockIdx.x + g;
  const int tig = lane & 3, row = (warp & 3) * 16 + (lane >> 2);  // and row + 8
  const float sl2 = scale * kLog2e;
  float acc0[32], acc1[32], s[32], dp[32];
  uint32_t pa[16], dsa[16];

  int kv = 0;
  for (int k = 0;; ++k) {
    const int u = unit_at(w, k, G);
    if (u >= total) break;
    const int bh = u / units, u0 = (u % units) * kTileRows, b = k % kBufs;
    const int r0 = u0 + row;  // this thread's own rows r0, r0 + 8
    const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
    const int id0 = sg && r0 < N ? __ldg(sg + r0) : 0;
    const int id1 = sg && r0 + 8 < N ? __ldg(sg + r0 + 8) : 0;
    // dQ: the own rows' lse (log2 domain) and di; rows ≥ N are not stored
    const size_t at = static_cast<size_t>(bh) * N;
    const float l20 = !kDkv && r0 < N ? lse[at + r0] * kLog2e : 0.f;
    const float l21 = !kDkv && r0 + 8 < N ? lse[at + r0 + 8] * kLog2e : 0.f;
    const float di0 = !kDkv && r0 < N ? di[at + r0] : 0.f;
    const float di1 = !kDkv && r0 + 8 < N ? di[at + r0 + 8] : 0.f;
    const uint64_t d_own0 = hw::sw128_desc(sO0 + b * kTileBytes);
    const uint64_t d_own1 = hw::sw128_desc(sO1 + b * kTileBytes);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    hw::mbar_wait(hw::smem_u32(&c.own_full[b]), (k / kBufs) & 1);

    for (bool last = false; !last; ++kv) {
      const int st = kv % kStages;
      hw::mbar_wait(hw::smem_u32(&c.full[st]), (kv / kStages) & 1);
      const int flags = c.flags[st], t0 = c.tile[st] * kTileRows;
      last = flags & kLast;
      const bool masked = !(flags & kUniform) || t0 + kTileRows > N || u0 + kTileRows > N;
      const int off = static_cast<int>((at + t0) & 3);  // dK/dV: where the slices start
      const uint64_t d_w0 = hw::sw128_desc(sW0 + st * kTileBytes);
      const uint64_t d_w1 = hw::sw128_desc(sW1 + st * kTileBytes);
      // dK/dV: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; dQ: S = Q·Kᵀ, dP = dO·Vᵀ
      issue_ss2(s, d_own0, d_w0, dp, d_own1, d_w1);
      hw::wgmma_wait<1>();
      hw::fence_regs(s);
      if (kDkv) {
        if (masked) {
          p_transposed<true>(s, v.lse[st] + off, sg, t0, r0, id0, id1, N, tig, sl2);
        } else {
          p_transposed<false>(s, v.lse[st] + off, sg, t0, r0, id0, id1, N, tig, sl2);
        }
        pack(s, pa);
        issue_rs(acc1, pa, d_w1);  // dV += Pᵀ·dO
        hw::wgmma_wait<1>();       // dPᵀ is in; dV may still run
        hw::fence_regs(dp);
        ds_transposed(dp, s, v.di[st] + off, tig, scale);
        pack(dp, dsa);
        issue_rs(acc0, dsa, d_w0);  // dK += dSᵀ·Q
      } else {
        if (masked) {
          p_rows<true>(s, sg, t0, r0, id0, id1, l20, l21, N, tig, sl2);
        } else {
          p_rows<false>(s, sg, t0, r0, id0, id1, l20, l21, N, tig, sl2);
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = (dp[i] - ((i & 2) ? di1 : di0)) * s[i] * scale;
        pack(dp, dsa);
        issue_rs(acc0, dsa, d_w0);  // dQ += dS·K
      }
      // the own tiles' last products are in: the buffer may take the next unit
      if (last && lane == 0) hw::mbar_arrive(hw::smem_u32(&c.own_empty[b]));
      hw::wgmma_wait<0>();
      hw::fence_regs(acc0);
      hw::fence_regs(acc1);
      hw::fence_regs(pa);
      hw::fence_regs(dsa);
      if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.empty[st]));
    }
    store_rows(out0 + at * 64, acc0, r0, N, tig);
    if (kDkv) store_rows(out1 + at * 64, acc1, r0, N, tig);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* di, const int* seg, void* dq, void* dk, void* dv, int* walked,
                 int BH, int H, int N, float scale, cudaStream_t stream) {
  static hw::LaunchCache dkv_cache, dq_cache;
  int sms = 0;
  cudaError_t err = hw::prepare(dkv_cache, fa_bwd_wgmma_kernel<true>, kSmemBytes, &sms);
  if (err == cudaSuccess) err = hw::prepare(dq_cache, fa_bwd_wgmma_kernel<false>, kSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(BH) * N;
  if (n >= (1u << 31)) return static_cast<int>(cudaErrorInvalidValue);  // TMA's int coordinates
  CUtensorMap qm, km, vm, dom, lm, dm;
  if (!hw::head_map(&qm, q, BH, N, kTileRows) || !hw::head_map(&km, k, BH, N, kTileRows) ||
      !hw::head_map(&vm, v, BH, N, kTileRows) || !hw::head_map(&dom, dout, BH, N, kTileRows) ||
      !hw::vec_map(&lm, lse, n, kVecBox) || !hw::vec_map(&dm, di, n, kVecBox))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const int total = BH * ((N + kTileRows - 1) / kTileRows);
  const int grid = std::min((total + 1) / 2, sms);
  fa_bwd_wgmma_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(
      km, vm, qm, dom, lm, dm, lse, di, seg, static_cast<bf*>(dk), static_cast<bf*>(dv), walked,
      BH, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_wgmma_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(
      qm, dom, km, vm, lm, dm, lse, di, seg, static_cast<bf*>(dq), nullptr,
      walked ? walked + 1 : nullptr, BH, H, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- Hopper path: fp32, Dh = 64 (3×TF32) ------------------------------------
//
// The same split, at fp32 accuracy: every product 3×TF32 (hopper.cuh: each
// operand x = hi + lo, three wgmmas per k8 step, lo·hi and hi·lo before
// hi·hi). What bounds it on the H100: at tap_setr_ete's (16, 16, 1765, 64)
// the five products are 510.4 GFLOP, 3.09 ms at 3×TF32's 495 / 3 TFLOP/s
// (7.62 ms for exact fp32 FMAs on the CUDA cores); the two kernels do seven
// (the dQ kernel recomputes S and dP), 4.33 ms.
//
// What shapes the design is that a 32-bit wgmma operand cannot be
// transposed by the hardware: B (and A from shared memory) must be
// K-major. Of each kernel's products, the first two take the unit's own
// tile as A and the walked tile as B in their natural layouts (Sᵀ = K·Qᵀ,
// dPᵀ = V·dOᵀ; or S = Q·Kᵀ, dP = dO·Vᵀ: Dh is K, contiguous in both); the
// others take P or dS from registers as A and need the walked tile with
// its rows along K: dV += Pᵀ·dO needs dOᵀ, dK += dSᵀ·Q needs Qᵀ, dQ += dS·K
// needs Kᵀ. So the walked tiles come in two layouts each, split once per
// tile, and shared memory bounds the tiles: the own tiles (hi and lo of two
// 64 × 64 fp32 tensors) take 64 KB, a dK/dV stage (Q and dO, natural and
// transposed, hi and lo) 64 KB at 32 rows. One CTA of two warpgroups per SM
// walks units of 64 own rows (`unit_at`):
//   * the producer warpgroup (128 threads) reads the unit's own rows from
//     global memory and splits them into the own buffer (both tensors
//     K-major, hi and lo) with the count of the unit's walked tiles, then
//     for every walked tile whose segment range meets the unit's
//     (`next_live`, each warp reducing the ids' ranges) splits its rows into
//     the next of two ring stages: natural (rows × Dh, 128-byte swizzled
//     halves, the wgmma layout) and transposed (Dh rows × the tile's rows in
//     `kperm` order, the order in which an accumulator's columns become A
//     fragments), with the tile's lse and di slices (dK/dV) and a header
//     (the tile, whether it needs the per-element mask). A tile's rows are
//     loaded a tile ahead, every load of a tile in flight at once (one at a
//     time, an L2 round trip each, the producer took twice as long). It
//     counts the walked tiles (`walked`);
//   * the consumer warpgroup runs, per walked tile, the two first products
//     (24 wgmma m64n32k8 each, both operands from shared memory, issued
//     together), P in place of Sᵀ once it is in, dS in place of dP, both
//     split in registers (P and dS stay fp32, unrounded), and the second
//     products (12 register-A wgmma m64n64k8 each) into fresh accumulators,
//     added to dK, dV (or dQ) in fp32 round-to-nearest: the tensor cores
//     truncate at every accumulation, and a sum over the up to 1765 rows of
//     a head in one accumulator would drift by about the whole fp32 bound.
// What holds it back: the producer's split of the walked tiles (taking it
// out saves about a quarter of the time at tap_setr_ete's shape), and the
// first products, bound by shared memory (each m64n32k8 reads 3 KB of
// operands for 16 K multiply-adds). Two consumer warpgroups taking the
// walked tiles in turn were slower: at 192 registers apiece each has to
// run its second products one after the other, and the shared memory they
// need for combining their sums leaves no room for a deeper ring. Each
// output element is summed by one thread in a fixed order: no atomics, the
// bits the same from call to call.

constexpr int kFOwn = 64;                        // rows per unit
constexpr int kFWalk = 32;                       // rows per walked tile
constexpr int kFStages = 2;                      // walked-tile ring depth
constexpr int kFOwnHalf = kFOwn * 128;           // 8 KB: 64 rows of 32 fp32
constexpr int kFOwnTile = 4 * kFOwnHalf;         // one own tensor, hi and lo
constexpr int kFWalkHalf = kFWalk * 128;         // 4 KB: 32 rows of 32 fp32
constexpr int kFNat = 4 * kFWalkHalf;            // one walked tensor, hi and lo
constexpr int kFTHalf = 64 * 128;                // its transpose: 64 rows of 32 fp32
constexpr int kFTrans = 2 * kFTHalf;             // hi and lo
constexpr int kFThreads = 2 * 128;               // producer and consumer warpgroups

template <bool kDkv>
__host__ __device__ constexpr int fstage_bytes() {
  return 2 * kFNat + (kDkv ? 2 : 1) * kFTrans;
}

struct FCtl {
  uint64_t own_full, own_empty, full[kFStages], empty[kFStages];
  int unit_tiles, tile[kFStages], flags[kFStages];
  float lse[kFStages][kFWalk], di[kFStages][kFWalk];  // dK/dV: the walked queries'
};

template <bool kDkv>
__host__ __device__ constexpr int fsmem_bytes() {
  return 2 * kFOwnTile + kFStages * fstage_bytes<kDkv>() + static_cast<int>(sizeof(FCtl)) + 1024;
}

// Rows r0 .. r0 + rows − 1 of one head (rows ≥ N as zeros), as the 128
// producer threads x hold them: 16-byte chunk i / rows of row i % rows for
// i = x, x + 128, ...; every load in flight at once.
template <int rows>
__device__ __forceinline__ void load_rows(const float* __restrict__ head, int r0, int N, int x,
                                          float4 (&a)[rows / 8]) {
#pragma unroll
  for (int it = 0; it < rows / 8; ++it) {
    const int i = x + 128 * it, r = i % rows, c = i / rows;
    a[it] = r0 + r < N ? __ldg(reinterpret_cast<const float4*>(head + (size_t)(r0 + r) * 64) + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Those rows split x = hi + lo into `nat` (two 32-column halves of rows ×
// 128 bytes, 128-byte swizzled: hi, then lo at + 2·half) and, with kTrans,
// into `trans` (64 rows of Dh × the rows in `kperm` order, one 128-byte
// swizzled atom wide: hi, then lo at + kFTHalf). A warp holds 32
// consecutive rows of one 16-byte chunk: its natural writes hit 8 distinct
// chunks per 8 lanes, its transposed ones 32 distinct banks of one row.
template <int rows, bool kTrans>
__device__ __forceinline__ void store_split(const float4 (&a)[rows / 8], uint8_t* nat,
                                            uint8_t* trans, int x) {
  constexpr int kHalf = rows * 128;
#pragma unroll
  for (int it = 0; it < rows / 8; ++it) {
    const int i = x + 128 * it, r = i % rows, c = i / rows;
    const float v[4] = {a[it].x, a[it].y, a[it].z, a[it].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hw::tf32_split(v[e], h[e], l[e]);
    const int at = (c >> 3) * kHalf + hw::sw128_at(r, 4 * (c & 7));
    *reinterpret_cast<uint4*>(nat + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(nat + 2 * kHalf + at) = make_uint4(l[0], l[1], l[2], l[3]);
    if (kTrans) {
      const int col = hw::kperm(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tat = hw::sw128_at(4 * c + e, col);
        *reinterpret_cast<uint32_t*>(trans + tat) = h[e];
        *reinterpret_cast<uint32_t*>(trans + kFTHalf + tat) = l[e];
      }
    }
  }
}

// d = own · walkedᵀ over Dh (64 × 32): `own` the unit's tile (hi halves at
// own, own + kFOwnHalf; lo at + 2·kFOwnHalf), `walk` the stage's natural
// tile (the same at kFWalkHalf). 24 wgmma, the small products first.
__device__ __forceinline__ void first_product(float (&d)[16], uint32_t own, uint32_t walk) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t ah = hw::sw128_desc(own + (kk >> 2) * kFOwnHalf) + 2 * (kk & 3);
    const uint64_t bh = hw::sw128_desc(walk + (kk >> 2) * kFWalkHalf) + 2 * (kk & 3);
    hw::wgmma_m64n32k8_tf32_ss(d, ah + ((2 * kFOwnHalf) >> 4), bh, kk > 0);
    hw::wgmma_m64n32k8_tf32_ss(d, ah, bh + ((2 * kFWalkHalf) >> 4), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hw::wgmma_m64n32k8_tf32_ss(d, hw::sw128_desc(own + (kk >> 2) * kFOwnHalf) + 2 * (kk & 3),
                               hw::sw128_desc(walk + (kk >> 2) * kFWalkHalf) + 2 * (kk & 3), 1);
}

// part = a · walked over the walked tile's 32 rows (64 × 64), a fresh
// accumulator: a split in registers (`split_frags`: hi in a's registers,
// lo), `trans` the stage's transposed tile. 12 wgmma, the small products
// first, committed as one group; `add_part` waits for it and adds it to
// the running sum. The register operands are pinned as `issue_rs` pins
// them.
__device__ __forceinline__ void second_product(float (&part)[32], float (&a)[16],
                                               uint32_t (&lo)[4][4], uint32_t trans) {
  hw::fence_regs(part);
  hw::fence_regs(a);
#pragma unroll
  for (int j = 0; j < 4; ++j) hw::fence_regs(lo[j]);
  hw::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t hi[4];
    hw::hi_frag(a, j, hi);
    const uint64_t th = hw::sw128_desc(trans) + 2 * j;
    hw::wgmma_m64n64k8_tf32_rs(part, lo[j], th, j > 0);
    hw::wgmma_m64n64k8_tf32_rs(part, hi, th + (kFTHalf >> 4), 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t hi[4];
    hw::hi_frag(a, j, hi);
    hw::wgmma_m64n64k8_tf32_rs(part, hi, hw::sw128_desc(trans) + 2 * j, 1);
  }
  hw::wgmma_commit();
  hw::fence_regs(part);
  hw::fence_regs(a);
#pragma unroll
  for (int j = 0; j < 4; ++j) hw::fence_regs(lo[j]);
}

__device__ __forceinline__ void add_part(float (&acc)[32], float (&part)[32], float (&a)[16],
                                         uint32_t (&lo)[4][4]) {
  hw::wgmma_wait<0>();
  hw::fence_regs(part);
  hw::fence_regs(a);
#pragma unroll
  for (int j = 0; j < 4; ++j) hw::fence_regs(lo[j]);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

// Store an accumulator's rows r0, r0 + 8 (as `store_rows`) in fp32.
__device__ __forceinline__ void store_rows_f32(float* __restrict__ head, const float (&c)[32],
                                               int r0, int N, int tig) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = i * 8 + tig * 2;
    if (r0 < N)
      *reinterpret_cast<float2*>(head + static_cast<size_t>(r0) * 64 + col) =
          make_float2(c[4 * i], c[4 * i + 1]);
    if (r0 + 8 < N)
      *reinterpret_cast<float2*>(head + static_cast<size_t>(r0 + 8) * 64 + col) =
          make_float2(c[4 * i + 2], c[4 * i + 3]);
  }
}

// kDkv: the dK/dV kernel (own = K, V; walked = Q, dO with their lse and di;
// outputs dK, dV). Else the dQ kernel (own = Q, dO; walked = K, V; output
// dQ; lse and di read per row).
template <bool kDkv>
__global__ void __launch_bounds__(kFThreads, 1)
fa_bwd_tf32_kernel(const float* __restrict__ own0, const float* __restrict__ own1,
                   const float* __restrict__ walk0, const float* __restrict__ walk1,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const int* __restrict__ seg, float* __restrict__ out0,
                   float* __restrict__ out1, int* __restrict__ walked, int BH, int H, int N,
                   float scale) {
  constexpr int kStage = fstage_bytes<kDkv>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = hw::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw_addr);
  const uint32_t stages = base + 2 * kFOwnTile;  // + s·kStage
  FCtl& c = *reinterpret_cast<FCtl*>(base_ptr + 2 * kFOwnTile + kFStages * kStage);

  const int units = (N + kFOwn - 1) / kFOwn;    // per head
  const int wtiles = (N + kFWalk - 1) / kFWalk;  // walked tiles per head
  const int total = BH * units;
  const int G = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hw::mbar_init(hw::smem_u32(&c.own_full), 4);
    hw::mbar_init(hw::smem_u32(&c.own_empty), 4);
    for (int s = 0; s < kFStages; ++s) {
      hw::mbar_init(hw::smem_u32(&c.full[s]), 4);
      hw::mbar_init(hw::smem_u32(&c.empty[s]), 4);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // unit k of this CTA: unit_at(blockIdx.x, k, G), the own buffer's phase
  // k & 1; the kv-th walked tile (over all units): stage and consumer kv %
  // 2, phase (kv / 2) & 1. All three warpgroups walk the same sequence.
  if (warp < 4) {
    // ---- producer warpgroup: every thread loads and splits
    // The unit's own rows, loaded before the wait for the own buffer; a
    // walked tile's rows, lse and di slices (dK/dV): the tile being stored
    // (0) and the next (1), loaded a tile ahead, so that each tile's loads
    // have a tile's time to arrive.
    const int x = threadIdx.x;
    float4 oa[kFOwn / 8], ob[kFOwn / 8], wa[2][kFWalk / 8], wb[2][kFWalk / 8];
    float wl[2] = {0.f, 0.f}, wd[2] = {0.f, 0.f};
    int kv = 0;
    for (int k = 0;; ++k) {
      const int u = unit_at(blockIdx.x, k, G);
      if (u >= total) break;
      const int bh = u / units, u0 = (u % units) * kFOwn;
      const size_t head = static_cast<size_t>(bh) * N * 64;
      const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
      const int2 own = sg ? asis::id_range(sg, u0, kFOwn, N, lane) : make_int2(0, 0);
      const auto load_walked = [&](int j, float4 (&a)[kFWalk / 8], float4 (&b)[kFWalk / 8],
                                   float& l, float& d) {
        const int t0 = j * kFWalk;
        load_rows<kFWalk>(walk0 + head, t0, N, x, a);
        load_rows<kFWalk>(walk1 + head, t0, N, x, b);
        const bool in = kDkv && x < kFWalk && t0 + x < N;
        l = in ? lse[static_cast<size_t>(bh) * N + t0 + x] : 0.f;
        d = in ? di[static_cast<size_t>(bh) * N + t0 + x] : 0.f;
      };
      bool uni, uni1, uni2;
      int n = 0;  // the unit's walked tiles
      for (int j = next_live(sg, own, 0, wtiles, kFWalk, N, lane, uni); j < wtiles;
           j = next_live(sg, own, j + 1, wtiles, kFWalk, N, lane, uni))
        ++n;
      // every unit walks at least its own rows' tile
      int j = next_live(sg, own, 0, wtiles, kFWalk, N, lane, uni);
      int j1 = next_live(sg, own, j + 1, wtiles, kFWalk, N, lane, uni1);
      load_rows<kFOwn>(own0 + head, u0, N, x, oa);
      load_rows<kFOwn>(own1 + head, u0, N, x, ob);
      load_walked(j, wa[0], wb[0], wl[0], wd[0]);
      if (j1 < wtiles) load_walked(j1, wa[1], wb[1], wl[1], wd[1]);
      // the previous unit's last products are in (passes at once for k = 0)
      hw::mbar_wait(hw::smem_u32(&c.own_empty), (k & 1) ^ 1);
      store_split<kFOwn, false>(oa, base_ptr, nullptr, x);
      store_split<kFOwn, false>(ob, base_ptr + kFOwnTile, nullptr, x);
      if (x == 0) c.unit_tiles = n;
      hw::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.own_full));
      while (j < wtiles) {
        const int j2 = j1 < wtiles ? next_live(sg, own, j1 + 1, wtiles, kFWalk, N, lane, uni2)
                                   : wtiles;
        const int s = kv % kFStages;
        // the stage's previous tile has been read (passes at once in round 0)
        hw::mbar_wait(hw::smem_u32(&c.empty[s]), ((kv / kFStages) & 1) ^ 1);
        uint8_t* st = base_ptr + 2 * kFOwnTile + s * kStage;
        store_split<kFWalk, true>(wa[0], st, st + 2 * kFNat, x);
        store_split<kFWalk, kDkv>(wb[0], st + kFNat, st + 2 * kFNat + kFTrans, x);
        if (kDkv && x < kFWalk) {
          c.lse[s][x] = wl[0];
          c.di[s][x] = wd[0];
        }
        if (x == 0) {
          c.tile[s] = j;
          c.flags[s] = uni ? kUniform : 0;
        }
        hw::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.full[s]));
#pragma unroll
        for (int i = 0; i < kFWalk / 8; ++i) {
          wa[0][i] = wa[1][i];
          wb[0][i] = wb[1][i];
        }
        wl[0] = wl[1];
        wd[0] = wd[1];
        if (j2 < wtiles) load_walked(j2, wa[1], wb[1], wl[1], wd[1]);
        ++kv;
        j = j1;
        j1 = j2;
        uni = uni1;
        uni1 = uni2;
      }
    }
    if (walked != nullptr && x == 0) atomicAdd(walked, kv);
    return;
  }

  // ---- consumer warpgroup
  const int tig = lane & 3, row = (warp & 3) * 16 + (lane >> 2);  // and row + 8
  const float sl2 = scale * kLog2e;
  float acc0[32], acc1[32], part0[32], part1[32], sc[16], dp[16];
  uint32_t lo0[4][4], lo1[4][4];

  int kv = 0;
  for (int k = 0;; ++k) {
    const int u = unit_at(blockIdx.x, k, G);
    if (u >= total) break;
    const int bh = u / units, u0 = (u % units) * kFOwn;
    const int r0 = u0 + row;  // this thread's own rows r0, r0 + 8
    const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
    const int id0 = sg && r0 < N ? __ldg(sg + r0) : 0;
    const int id1 = sg && r0 + 8 < N ? __ldg(sg + r0 + 8) : 0;
    // dQ: the own rows' lse (log2 domain) and di; rows ≥ N are not stored
    const size_t at = static_cast<size_t>(bh) * N;
    const float l20 = !kDkv && r0 < N ? lse[at + r0] * kLog2e : 0.f;
    const float l21 = !kDkv && r0 + 8 < N ? lse[at + r0 + 8] * kLog2e : 0.f;
    const float di0 = !kDkv && r0 < N ? di[at + r0] : 0.f;
    const float di1 = !kDkv && r0 + 8 < N ? di[at + r0 + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    hw::mbar_wait(hw::smem_u32(&c.own_full), k & 1);
    const int n = c.unit_tiles;

    for (const int end = kv + n; kv < end; ++kv) {
      const int s = kv % kFStages;
      hw::mbar_wait(hw::smem_u32(&c.full[s]), (kv / kFStages) & 1);
      const int t0 = c.tile[s] * kFWalk;
      const bool masked = !(c.flags[s] & kUniform) || t0 + kFWalk > N || u0 + kFOwn > N;
      const uint32_t st = stages + s * kStage;
      // dK/dV: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; dQ: S = Q·Kᵀ, dP = dO·Vᵀ
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      hw::wgmma_fence();
      first_product(sc, base, st);
      hw::wgmma_commit();
      first_product(dp, base + kFOwnTile, st + kFNat);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();
      hw::fence_regs(sc);
      if (kDkv) {
        if (masked) {
          p_transposed<true>(sc, c.lse[s], sg, t0, r0, id0, id1, N, tig, sl2);
        } else {
          p_transposed<false>(sc, c.lse[s], sg, t0, r0, id0, id1, N, tig, sl2);
        }
      } else if (masked) {
        p_rows<true>(sc, sg, t0, r0, id0, id1, l20, l21, N, tig, sl2);
      } else {
        p_rows<false>(sc, sg, t0, r0, id0, id1, l20, l21, N, tig, sl2);
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(dp);
      if (kDkv) {
        ds_transposed(dp, sc, c.di[s], tig, scale);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) dp[i] = (dp[i] - ((i & 2) ? di1 : di0)) * sc[i] * scale;
      }
      // dK/dV: dV += Pᵀ·dO (dOᵀ after Qᵀ), issued before dS is split, and
      // dK += dSᵀ·Q (Qᵀ at st + 2·kFNat); dQ: dQ += dS·K (Kᵀ at st + 2·kFNat)
      if (kDkv) {
        hw::split_frags(sc, lo0);  // P_hi in S's registers
        second_product(part1, sc, lo0, st + 2 * kFNat + kFTrans);
      }
      hw::split_frags(dp, lo1);  // dS_hi in dP's registers
      second_product(part0, dp, lo1, st + 2 * kFNat);
      if (kDkv) add_part(acc1, part1, sc, lo0);
      add_part(acc0, part0, dp, lo1);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.empty[s]));
    }
    // the unit's last products are in: the producer may refill the own tiles
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.own_empty));
    store_rows_f32(out0 + at * 64, acc0, r0, N, tig);
    if (kDkv) store_rows_f32(out1 + at * 64, acc1, r0, N, tig);
  }
}

int launch_tf32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* di, const int* seg, void* dq, void* dk, void* dv, int* walked,
                int BH, int H, int N, float scale, cudaStream_t stream) {
  static hw::LaunchCache dkv_cache, dq_cache;
  int sms = 0;
  cudaError_t err =
      hw::prepare(dkv_cache, fa_bwd_tf32_kernel<true>, fsmem_bytes<true>(), &sms);
  if (err == cudaSuccess)
    err = hw::prepare(dq_cache, fa_bwd_tf32_kernel<false>, fsmem_bytes<false>(), &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k);
  const float *fv = static_cast<const float*>(v), *fdo = static_cast<const float*>(dout);
  const int grid = std::min(BH * ((N + kFOwn - 1) / kFOwn), sms);
  fa_bwd_tf32_kernel<true><<<grid, kFThreads, fsmem_bytes<true>(), stream>>>(
      fk, fv, fq, fdo, lse, di, seg, static_cast<float*>(dk), static_cast<float*>(dv), walked,
      BH, H, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_tf32_kernel<false><<<grid, kFThreads, fsmem_bytes<false>(), stream>>>(
      fq, fdo, fk, fv, lse, di, seg, static_cast<float*>(dq), nullptr,
      walked ? walked + 1 : nullptr, BH, H, N, scale);
  return static_cast<int>(cudaGetLastError());
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, do and dq, dk, dv: contiguous (B·H, N, Dh) in one dtype (is_bf16:
// bfloat16, else float32), Dh one of 16, 32, 64; lse (the forward's, natural
// log) and di = Σ o·do: (B·H, N) float32; seg: contiguous (B, N) int32
// segment ids, or null for one segment; walked: null, or two int32 to which
// the Dh-64 kernels add the tile pairs they walked, (64, 64) in bf16 and
// (64 own rows, 32 walked) in fp32, the dK/dV kernel's first, counted by
// the warps that stream them as the forward's (the CUDA-core paths, Dh 16
// and 32, walk every pair and leave them as they are). Launches the dK/dV
// kernel, then the dQ kernel, on `stream`, writes the AttnKernel they ran
// to *kernel (flash_attn.cuh); returns the first cudaGetLastError() that is
// not 0.
int asis_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* di, const int* seg, void* dq, void* dk,
                        void* dv, int* walked, int B, int H, int N, int Dh, float scale,
                        int is_bf16, int* kernel, void* stream) {
  const int BH = B * H;
  if (B <= 0 || H <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) {
    *kernel = is_bf16 ? asis::kAttnWgmma : asis::kAttnTf32x3;
    return is_bf16 ? launch_wgmma(q, k, v, dout, lse, di, seg, dq, dk, dv, walked, BH, H, N,
                                  scale, s)
                   : launch_tf32(q, k, v, dout, lse, di, seg, dq, dk, dv, walked, BH, H, N,
                                 scale, s);
  }
  *kernel = asis::kAttnCudaCores;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, Dh,
                                           scale, s)
                 : dispatch<float>(q, k, v, dout, lse, di, seg, dq, dk, dv, BH, H, N, Dh, scale,
                                   s);
}

}  // extern "C"
