// Forward-only attention for the frozen ViT walks (K3): o = softmax(q·kᵀ·scale)·v.
//
// Replaces: adaptersis_tpu/ops/flash_fwd.py:73 `_kernel` (via :124
// `_fwd_impl`), the Pallas kernel behind attn_impl="flash_fwd".
//
// What bounds it on the H100: at the training path's shapes (B·H = 256
// heads of N = 1765 or 1764 tokens, Dh = 64) one call does 4·B·H·N²·Dh
// ≈ 204 GFLOP and moves 4·B·H·N·Dh·2 B ≈ 116 MB: operations, 0.2064 ms at
// the dense bf16 peak against 0.035 ms for the bytes. So the two products
// must keep the tensor cores busy, and only wgmma reaches their full rate
// on this card. With Dh = 64 the softmax costs as much as the products: a
// 64 × 128 tile of scores takes 8192 exp2 on the SM's 16 MUFU lanes per
// clock, ≈ 512 clocks, as long as its two products on the tensor cores. So
// the design overlaps the two: each consumer warpgroup issues the next
// tile's S = Q·Kᵀ and the previous tile's O += P·V together and computes the
// softmax while P·V runs, and the two consumer warpgroups take turns to
// issue, so one's softmax runs while the other's products hold the tensor
// cores. The loads are kept off the consumers entirely: a producer
// warpgroup streams K and V by TMA into a ring of shared-memory stages,
// and the consumers only wait on barriers. One CTA per SM: a consumer
// thread holds S (64 fp32), P (32 bf16 pairs) and O (32 fp32) live at once,
// ≈ 160 registers with its addresses and row statistics; a second CTA
// would leave 85. So the CTA is persistent: it walks query tile after query
// tile, and the producer loads the next tile's Q and K/V while the
// consumers finish the current one, which hides each tile's first loads
// and its epilogue.
//
// Three paths, chosen by what the call can take:
//   * bf16 with Dh = 64 (the bf16 walks): wgmma products fed by TMA
//     (flash_fwd_wgmma_kernel, below);
//   * fp32 with Dh = 64 (the fp32 walks, train_seg's and segment_m2f's
//     default precision): the same products at fp32 accuracy by 3×TF32 on
//     wgmma. That kernel is K7's fp32 forward (flash_attn_fwd.cu
//     fa_fwd_tf32_kernel, where its design and what bounds it are), launched
//     with one segment and no lse: without ids it walks every tile and
//     computes what this kernel's contract asks;
//   * Dh of 16 or 32, which no walk of the port runs: fp32 FMAs on the
//     CUDA cores (flash_fwd_kernel).
// Both keep the TRUE running row max of an online softmax, in fp32. The TPU
// kernel replaced the row max by a constant clamp of 60, which is exact only
// while max|S| < 60 (6.37 was measured on the main path); with the running
// max this kernel is exact softmax for any scores, so the two agree wherever
// the TPU kernel is exact. The ragged tail (N not a multiple of the tile) is
// handled inside the kernel: keys past N get score −inf, queries past N are
// not stored. No padding to 128 and no ones column in v are needed.
//
// CUDA-core path (Dh 16 and 32): one block of 64 threads per (b·h,
// 64-query tile); each thread owns one query row, holding q (pre-scaled)
// and the fp32 output accumulator in registers; K and V tiles of 64 keys
// are staged in shared memory as fp32 and read as broadcasts; the
// accumulator is rescaled once per chunk of 16 keys.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "flash_attn.cuh"
#include "hopper.cuh"
#include "bf16.cuh"

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

// ---- Hopper path: bf16, Dh = 64 (every main-path call) -------------------
//
// One persistent CTA of three warpgroups per SM, walking the (b·h,
// 128-query) tiles: a producer warpgroup whose first thread issues every
// TMA load (each tile's Q into one of two Q buffers, then its K and V
// tiles of 128 keys × 64 into a ring of kStages stages that runs on across
// query tiles; every buffer and stage is guarded by full barriers,
// completed by TMA's transaction bytes, and an empty barrier, one arrival
// per consumer warp), and two consumer warpgroups of 64 query rows each,
// the height of a wgmma. setmaxnreg moves the producer's registers to the consumers (24 and
// 240 of the 168 each thread starts with). Every tile is 128 rows of 128
// bytes, swizzled by TMA in 128-byte atoms, the layout the wgmma
// descriptors name (hopper.cuh `sw128_desc`).
//
// A consumer warpgroup computes S = Q·Kᵀ for a key tile with four wgmma
// m64n128k16 (both operands from shared memory), scales S into the log2
// domain, masks keys ≥ N (in the last tile only), keeps the true running
// row max and row sum in fp32 and rounds P = exp2(S − m) to bf16 in
// registers: the accumulator's layout is the A-fragment layout of the
// next wgmma. O += P·V runs as eight wgmma m64n64k16 with A from registers
// and V from shared memory as an MN-major operand. The two products
// overlap the softmax: for tile j the warpgroup issues S_j = Q·K_jᵀ and
// O += P_{j−1}·V_{j−1} back to back, waits for S_j only, computes the
// softmax of tile j while the tensor cores run P·V, then waits for P·V
// and rescales O by the new row max. The two warpgroups issue in turns
// (named barriers). The output is O / l, rounded once to bf16, stored from
// registers for rows < N. Three-dimensional tensor maps (B·H, N, 64) make
// TMA fill rows past a head's N with zeros instead of the next head's rows.

namespace hw = asis::hopper;

constexpr int kRows = 128;                      // queries per CTA (2 warpgroups)
constexpr int kKeys = 128;                      // keys per tile
constexpr int kHead = 64;                       // head width
constexpr int kStages = 3;                      // K/V ring depth
constexpr int kQBufs = 2;                       // Q tiles: one in use, one loading
constexpr int kTileBytes = 128 * kHead * 2;     // one 128 × 64 bf16 tile, 16 KB
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 3 * 128;
// kQBufs Q tiles, kStages K and V tiles, the barriers, and slack to align
// to 1024 bytes
constexpr int kBarOffset = (kQBufs + 2 * kStages) * kTileBytes;
constexpr int kSmemBytes = kBarOffset + 8 * (2 * kQBufs + 3 * kStages) + 1024;

// The softmax works on S in place while the P·V of the previous tile is in
// flight: S belongs to the Q·Kᵀ group, which has completed. The max is
// taken over the raw scores (scale > 0 keeps the order), so
// p = exp2(s·scale·log2e − m·scale·log2e) is one FFMA and one exp2. In the
// last tile (kMasked), keys ≥ N are skipped by the max and get p = 0.

// This thread's share of S (rows r0, r0 + 8): running maxima of the raw
// scores, reduced over the 4 lanes that share a row.
template <bool kMasked, int n>
__device__ __forceinline__ void row_max(const float (&sc)[n], int k0, int N, int tig, float& m0,
                                        float& m1) {
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    float a = sc[i], b = sc[i + 1];
    if (kMasked) {
      const int key = k0 + (i >> 2) * 8 + tig * 2;
      a = key < N ? a : -CUDART_INF_F;
      b = key + 1 < N ? b : -CUDART_INF_F;
    }
    if (i & 2) {
      m1 = fmaxf(m1, fmaxf(a, b));
    } else {
      m0 = fmaxf(m0, fmaxf(a, b));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
}

// S → P = exp2((S − m)·scale_log2) in place, fp32; adds P to this thread's
// row sums.
template <bool kMasked, int n>
__device__ __forceinline__ void exp_in_place(float (&sc)[n], int k0, int N, int tig, float m0,
                                             float m1, float scale_log2, float& l0, float& l1) {
  const float b0 = -m0 * scale_log2, b1 = -m1 * scale_log2;
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    const float b = (i & 2) ? b1 : b0;
    float p0 = hw::ex2(fmaf(sc[i], scale_log2, b));
    float p1 = hw::ex2(fmaf(sc[i + 1], scale_log2, b));
    if (kMasked) {
      const int key = k0 + (i >> 2) * 8 + tig * 2;
      p0 = key < N ? p0 : 0.f;
      p1 = key + 1 < N ? p1 : 0.f;
    }
    if (i & 2) {
      l1 += p0 + p1;
    } else {
      l0 += p0 + p1;
    }
    sc[i] = p0;
    sc[i + 1] = p1;
  }
}

// One tile's softmax: the new running maxima, O's correction factors
// a = exp2((m_old − m_new)·scale_log2) and the row sums; S becomes P. A
// thread's sc[n] covers a tile of 2n keys.
template <int n>
__device__ __forceinline__ void softmax(float (&sc)[n], int k0, int N, int tig, float scale_log2,
                                        float& m0, float& m1, float& a0, float& a1, float& l0,
                                        float& l1) {
  float mx0 = m0, mx1 = m1, ln0 = 0.f, ln1 = 0.f;
  if (k0 + 2 * n <= N) {
    row_max<false>(sc, k0, N, tig, mx0, mx1);
    exp_in_place<false>(sc, k0, N, tig, mx0, mx1, scale_log2, ln0, ln1);
  } else {  // key k0 < N is real, so the max is finite
    row_max<true>(sc, k0, N, tig, mx0, mx1);
    exp_in_place<true>(sc, k0, N, tig, mx0, mx1, scale_log2, ln0, ln1);
  }
  a0 = hw::ex2((m0 - mx0) * scale_log2);  // 0 on the first tile: exp2(−inf)
  a1 = hw::ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  l0 = l0 * a0 + ln0;
  l1 = l1 * a1 + ln1;
}

// P as bf16 A fragments: keys 16kk..16kk+15 of rows r0 and r0 + 8 are
// pa[4kk..4kk+3], the accumulator's layout.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = asis::pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&acc)[32], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[4 * i] *= a0;
    acc[4 * i + 1] *= a0;
    acc[4 * i + 2] *= a1;
    acc[4 * i + 3] *= a1;
  }
}

// Each group of wgmmas is fenced as CUTLASS fences it: its register
// operands are pinned before wgmma.fence and after the commit, so the
// compiler moves no other read or write of them into the group's flight.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq, uint64_t dk) {
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHead / 16; ++kk)
    hw::wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
  hw::wgmma_commit();
  hw::fence_regs(sc);
}

__device__ __forceinline__ void issue_pv(float (&acc)[32], uint32_t (&pa)[32], uint64_t dv) {
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) hw::wgmma_m64n64k16_rs(acc, pa + 4 * kk, dv + 128 * kk);
  hw::wgmma_commit();
  hw::fence_regs(acc);
  hw::fence_regs(pa);
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, one per warpgroup, 256 threads each: the waiting
// warpgroup syncs, the other arrives), so one warpgroup's softmax runs on
// the MUFU and FMA pipes while the other's wgmmas hold the tensor cores.
// Warpgroup 1 lets warpgroup 0 start and skips its own last pass, so every
// barrier phase completes.
__device__ __forceinline__ void turn_wait(int wg) {
  hw::named_sync(1 + wg, 256);
}

__device__ __forceinline__ void turn_pass(int wg, bool last) {
  if (!(wg == 1 && last)) hw::named_arrive(2 - wg, 256);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       int BH, int N, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                           // + buffer·kTileBytes
  const uint32_t sK = sQ + kQBufs * kTileBytes;       // + stage·kTileBytes
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t q_full = base + kBarOffset;          // + 8·buffer
  const uint32_t q_empty = q_full + 8 * kQBufs;       // + 8·buffer
  const uint32_t k_full = q_empty + 8 * kQBufs;       // + 8·stage
  const uint32_t v_full = k_full + 8 * kStages;       // + 8·stage
  const uint32_t empty = v_full + 8 * kStages;        // + 8·stage

  const int qblocks = (N + kRows - 1) / kRows;
  const int total = BH * qblocks;
  const int tiles = (N + kKeys - 1) / kKeys;  // key tiles per query tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kQBufs; ++b) {
      hw::mbar_init(q_full + 8 * b, 1);
      hw::mbar_init(q_empty + 8 * b, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(k_full + 8 * s, 1);
      hw::mbar_init(v_full + 8 * s, 1);
      hw::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // Query tiles are dealt to the CTAs in turn; t counts this CTA's tiles and
  // kv the K/V tiles it has streamed (ring stage kv % kStages, phase
  // (kv / kStages) & 1). Producer and consumers walk the same sequence.
  if (warp < 4) {
    // ---- producer warpgroup: its first thread issues every TMA load
    hw::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int kv = 0;
      for (int tile = blockIdx.x, t = 0; tile < total; tile += gridDim.x, ++t) {
        const int bh = tile / qblocks, q0 = (tile % qblocks) * kRows, b = t % kQBufs;
        // the buffer's previous query tile has had its last Q·Kᵀ
        hw::mbar_wait(q_empty + 8 * b, ((t / kQBufs) & 1) ^ 1);
        hw::mbar_expect_tx(q_full + 8 * b, kTileBytes);
        hw::tma_load_3d(sQ + b * kTileBytes, &qmap, q_full + 8 * b, 0, q0, bh);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int s = kv % kStages;
          // the stage's previous tile has been read (passes at once in round 0)
          hw::mbar_wait(empty + 8 * s, ((kv / kStages) & 1) ^ 1);
          hw::mbar_expect_tx(k_full + 8 * s, kTileBytes);
          hw::tma_load_3d(sK + s * kTileBytes, &kmap, k_full + 8 * s, 0, j * kKeys, bh);
          hw::mbar_expect_tx(v_full + 8 * s, kTileBytes);
          hw::tma_load_3d(sV + s * kTileBytes, &vmap, v_full + 8 * s, 0, j * kKeys, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg owns query rows 64·wg .. of each tile
    hw::regs_alloc<240>();
    const int wg = (warp >> 2) - 1;
    if (wg == 1) hw::named_arrive(1, 256);  // warpgroup 0 issues first
    const int tig = lane & 3;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and row + 8
    float acc[32], sc[64];
    uint32_t pa[32];

    int kv = 0;
    for (int tile = blockIdx.x, t = 0; tile < total; tile += gridDim.x, ++t) {
      const int bh = tile / qblocks, r0 = (tile % qblocks) * kRows + row, b = t % kQBufs;
      const bool last_tile = tile + static_cast<int>(gridDim.x) >= total;
      const uint64_t dq = hw::sw128_desc(sQ + b * kTileBytes + wg * 64 * 128);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, rows r0, r0 + 8
      float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums
      float a0, a1;                                  // O's correction to the new max

      // key tile 0: S and its softmax (O is still zero: no correction)
      hw::mbar_wait(q_full + 8 * b, (t / kQBufs) & 1);
      hw::mbar_wait(k_full + 8 * (kv % kStages), (kv / kStages) & 1);
      turn_wait(wg);
      issue_qk(sc, dq, hw::sw128_desc(sK + (kv % kStages) * kTileBytes));
      turn_pass(wg, last_tile && tiles == 1);
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);
      if (tiles == 1 && lane == 0) hw::mbar_arrive(q_empty + 8 * b);  // Q is read
      softmax(sc, 0, N, tig, scale_log2, m0, m1, a0, a1, l0, l1);
      pack_p(sc, pa);

      // key tile j: S_j = Q·K_jᵀ and O += P_{j−1}·V_{j−1} both in flight; the
      // softmax of S_j runs while P·V does; once P·V is in O (stage j − 1 is
      // read), O takes the correction to S_j's row max and P_j is packed. No
      // instruction writes O or P while a product that reads them is in
      // flight.
      for (int j = 1; j < tiles; ++j) {
        const int cur = kv + j, prev = cur - 1;
        const int s = cur % kStages, sp = prev % kStages;
        hw::mbar_wait(k_full + 8 * s, (cur / kStages) & 1);
        hw::mbar_wait(v_full + 8 * sp, (prev / kStages) & 1);
        turn_wait(wg);
        issue_qk(sc, dq, hw::sw128_desc(sK + s * kTileBytes));
        issue_pv(acc, pa, hw::sw128_desc(sV + sp * kTileBytes));
        turn_pass(wg, last_tile && j == tiles - 1);
        hw::wgmma_wait<1>();  // S_j is ready; P·V may still run
        hw::fence_regs(sc);
        if (j == tiles - 1 && lane == 0) hw::mbar_arrive(q_empty + 8 * b);  // Q is read
        softmax(sc, j * kKeys, N, tig, scale_log2, m0, m1, a0, a1, l0, l1);
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::fence_regs(pa);
        if (lane == 0) hw::mbar_arrive(empty + 8 * sp);
        rescale(acc, a0, a1);
        pack_p(sc, pa);
      }

      // the last key tile's P·V
      kv += tiles;
      const int sl = (kv - 1) % kStages;
      hw::mbar_wait(v_full + 8 * sl, ((kv - 1) / kStages) & 1);
      issue_pv(acc, pa, hw::sw128_desc(sV + sl * kTileBytes));
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::fence_regs(pa);
      if (lane == 0) hw::mbar_arrive(empty + 8 * sl);

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      __nv_bfloat16* head = o + static_cast<size_t>(bh) * N * kHead;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = i * 8 + tig * 2;
        if (r0 < N)
          *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0) * kHead + c) =
              asis::pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (r0 + 8 < N)
          *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0 + 8) * kHead + c) =
              asis::pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale,
                 cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory: allowed once per card, when
  // its SM count is read
  static hw::LaunchCache cache;
  int sms = 0;
  const cudaError_t err = hw::prepare(cache, flash_fwd_wgmma_kernel, kSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);  // the max is of raw scores
  CUtensorMap qm, km, vm;
  if (!hw::head_map(&qm, q, BH, N, kRows) || !hw::head_map(&km, k, BH, N, kKeys) ||
      !hw::head_map(&vm, v, BH, N, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  // one CTA per SM, each walking its share of the query tiles
  const int total = BH * ((N + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<<<std::min(total, sms), kThreads, kSmemBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), BH, N,
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The kernel a launch ran, as asis_flash_fwd writes it to *kernel:
// ops/flash_fwd.py:KERNELS names them in this order.
enum FlashKernel { kWgmmaKernel = 0, kTf32x3Kernel = 1, kCudaCoresKernel = 2 };

// q, k, v, o: contiguous (BH, N, Dh) in one dtype (is_bf16: bfloat16, else
// float32), 16-byte aligned, Dh one of 16, 32, 64 (64 on the main path:
// the tensor-core kernels, which take scale > 0). Launches on `stream`,
// writes the FlashKernel it launched to *kernel and returns
// cudaGetLastError() (0 = launched).
int asis_flash_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                   int N, int Dh, float scale, int is_bf16, int* kernel, void* stream) {
  if (BH <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == kHead) {
    *kernel = is_bf16 ? kWgmmaKernel : kTf32x3Kernel;
    // fp32: K7's 3×TF32 forward with one segment, no lse and no walk count
    return is_bf16 ? launch_wgmma(q, k, v, o, BH, N, scale, s)
                   : asis::flash_fwd_tf32(q, k, v, nullptr, o, nullptr, nullptr, BH, 1, N, scale,
                                          s);
  }
  *kernel = kCudaCoresKernel;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, BH, N, Dh, scale, s)
                 : dispatch<float>(q, k, v, o, BH, N, Dh, scale, s);
}

const char* asis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
