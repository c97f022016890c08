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
// length, ≈ 8 µs at 989 TFLOP/s). The packed layout leaves ≈ 64 % of the
// student's 457² square masked (257² + 4·50² = 76 049 of 208 849 pairs per
// row); the kernel walks only the tile pairs whose segments can meet (20 of
// 32 at 64 queries × 128 keys), and on those the softmax's exp2 on the
// MUFU pipes costs as much as the two products on the tensor cores, so the
// design overlaps them (below). At these short rows (1 to 4 key tiles per
// unit) the ramp of each unit, its first loads and its epilogue, is hidden
// by the persistent CTA's pipeline running on across units.
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
// Three paths, each reported to the caller (flash_attn.cuh AttnKernel):
//   * bf16 with Dh = 64 (the bf16 SSL step): wgmma products fed by TMA,
//     tiles whose segments cannot meet skipped (fa_fwd_wgmma_kernel, below);
//   * fp32 with Dh = 64 (tap_setr_ete's fp32 train step, the ViT-S
//     setr_cross_ete eval script, pretrain without --bf16): the same design
//     at fp32 accuracy by 3×TF32 on wgmma, the same tiles skipped
//     (fa_fwd_tf32_kernel, below; what bounds it is there), which K3's
//     fp32 path (flash_fwd.cu) launches too, with one segment and no lse;
//   * Dh of 16 or 32 (the narrow models of the tests): one thread per query
//     row, fp32 FMAs on the CUDA cores over every tile (fa_fwd_kernel), p
//     rounded to bf16 for bf16 inputs.

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

using asis::kLn2;
using asis::kLog2e;
using asis::kMaskValue;
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

// ---- Hopper path: bf16, Dh = 64 (every SSL call) ---------------------------
//
// K3's design (flash_fwd.cu) with segment ids, the row logsumexp and a finer
// schedule. One persistent CTA of three warpgroups per SM. Each of the two
// consumer warpgroups walks its own units, 64 query rows of one head (the
// height of a wgmma; `unit_at` deals them), so the teacher's ragged tail
// (N = 257 = 4·64 + 1) costs one 64-row unit, not a 128-row tile. Each has
// its own pipeline, fed by one warp of the producer warpgroup: lane 0 loads
// the unit's Q by TMA into one of two buffers, then streams the key tiles
// (128 keys × 64) whose segment range meets the unit's (`next_live`: the
// whole warp reduces the ids' ranges) into a 2-stage K/V ring, each stage
// with a header naming its tile, whether it needs the per-element mask and
// whether it is the unit's last. The consumers follow the headers: they
// never walk a skipped tile.
//
// Per key tile a consumer warpgroup issues S = Q·Kᵀ as four wgmma
// m64n128k16 (both operands in shared memory) together with the previous
// tile's O += P·V (eight wgmma m64n64k16, P from registers, V MN-major), runs
// the softmax of S while P·V is in flight, then rescales O. The softmax is
// in the log2 domain with the running max m of the scaled scores. On a
// uniform tile it takes the max of the raw scores (scale > 0 keeps the
// order) and p = exp2(s·scale·log2e − m) is one FFMA and one exp2; on a tile
// straddling a segment boundary each pair compares its ids, and a pair of
// different segments scores kMaskValue (finite in the log2 domain, so a row
// whose tile holds no key of its own keeps finite m and l, rescaled away by
// exp2(kMaskValue − m) = 0 at its first own key). Keys ≥ N (zeros from the
// tensor map) score −inf, in the last tile only. P is rounded to bf16 in
// registers before P·V; l sums the unrounded p. The epilogue stores O / l
// rounded once to bf16, and lse = (m + log2 l)·ln 2, for rows < N.

namespace hw = asis::hopper;
using asis::kLast;
using asis::kUniform;
using asis::next_live;
using asis::unit_at;

constexpr int kUnit = 64;                          // query rows per unit
constexpr int kKeys = 128;                         // keys per tile
constexpr int kStages = 2;                         // K/V ring depth per consumer warpgroup
constexpr int kQBytes = kUnit * 64 * 2;            // one 64 × 64 bf16 tile
constexpr int kKVBytes = kKeys * 64 * 2;           // one 128 × 64 bf16 tile
constexpr int kRegion = 2 * kQBytes + 2 * kStages * kKVBytes;  // per consumer warpgroup
constexpr int kThreads = 3 * 128;

struct FwdCtl {
  uint64_t q_full[2], q_empty[2], k_full[kStages], v_full[kStages], empty[kStages];
  int tile[kStages], flags[kStages];
};
constexpr int kSmemBytes = 2 * kRegion + 2 * static_cast<int>(sizeof(FwdCtl)) + 1024;

// This thread's share of a 64 × 2n score tile (n = 64: the bf16 kernel's
// 128 keys; n = 32: the fp32 kernel's 64): rows r0 (registers 4j, 4j + 1)
// and r0 + 8 (4j + 2, 4j + 3) at keys k0 + 8j + 2·tig (+1).

// A uniform tile (no segment mask; keys ≥ N masked when kTail): the new
// running maxima n0, n1 (log2 domain), S → P in place, P's row sums.
template <bool kTail, int n>
__device__ __forceinline__ void softmax_uniform(float (&sc)[n], int k0, int N, int tig,
                                                float sl2, float m0, float m1, float& n0,
                                                float& n1, float& ln0, float& ln1) {
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
    float* s = sc + 4 * j;
    if (kTail) {
      const int key = k0 + 8 * j + 2 * tig;
      if (key >= N) s[0] = s[2] = -CUDART_INF_F;
      if (key + 1 >= N) s[1] = s[3] = -CUDART_INF_F;
    }
    mx0 = fmaxf(mx0, fmaxf(s[0], s[1]));
    mx1 = fmaxf(mx1, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // key k0 < N is real, so the raw maxima are finite
  n0 = fmaxf(m0, mx0 * sl2);
  n1 = fmaxf(m1, mx1 * sl2);
  ln0 = ln1 = 0.f;
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
    float* s = sc + 4 * j;
    // exp2(−inf) = 0 for the masked tail
    s[0] = hw::ex2(fmaf(s[0], sl2, -n0));
    s[1] = hw::ex2(fmaf(s[1], sl2, -n0));
    s[2] = hw::ex2(fmaf(s[2], sl2, -n1));
    s[3] = hw::ex2(fmaf(s[3], sl2, -n1));
    ln0 += s[0] + s[1];
    ln1 += s[2] + s[3];
  }
}

// A tile straddling a segment boundary: each pair compares its ids.
template <int n>
__device__ __forceinline__ void softmax_ids(float (&sc)[n], const int* __restrict__ sg, int k0,
                                            int N, int tig, float sl2, int id0, int id1,
                                            float m0, float m1, float& n0, float& n1, float& ln0,
                                            float& ln1) {
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
    float* s = sc + 4 * j;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * tig + e;
      const int kid = key < N ? __ldg(sg + key) : 0;
      s[e] = key >= N ? -CUDART_INF_F : (kid == id0 ? s[e] * sl2 : kMaskValue);
      s[e + 2] = key >= N ? -CUDART_INF_F : (kid == id1 ? s[e + 2] * sl2 : kMaskValue);
    }
    mx0 = fmaxf(mx0, fmaxf(s[0], s[1]));
    mx1 = fmaxf(mx1, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  n0 = fmaxf(m0, mx0);  // ≥ kMaskValue: finite
  n1 = fmaxf(m1, mx1);
  ln0 = ln1 = 0.f;
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
    float* s = sc + 4 * j;
    s[0] = hw::ex2(s[0] - n0);
    s[1] = hw::ex2(s[1] - n0);
    s[2] = hw::ex2(s[2] - n1);
    s[3] = hw::ex2(s[3] - n1);
    ln0 += s[0] + s[1];
    ln1 += s[2] + s[3];
  }
}

// One tile's softmax: S becomes P, m the new running maxima, O's correction
// factors a = exp2(m_old − m_new) (0 on the first tile), l the row sums.
template <int n>
__device__ __forceinline__ void softmax(float (&sc)[n], int flags, const int* sg, int k0, int N,
                                        int tig, float sl2, int id0, int id1, float& m0,
                                        float& m1, float& a0, float& a1, float& l0, float& l1) {
  float n0, n1, ln0, ln1;
  if (!(flags & kUniform)) {
    softmax_ids(sc, sg, k0, N, tig, sl2, id0, id1, m0, m1, n0, n1, ln0, ln1);
  } else if (k0 + 2 * n > N) {
    softmax_uniform<true>(sc, k0, N, tig, sl2, m0, m1, n0, n1, ln0, ln1);
  } else {
    softmax_uniform<false>(sc, k0, N, tig, sl2, m0, m1, n0, n1, ln0, ln1);
  }
  a0 = hw::ex2(m0 - n0);
  a1 = hw::ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  l0 = l0 * a0 + ln0;
  l1 = l1 * a1 + ln1;
}

// P as bf16 A fragments: keys 16kk..16kk+15 of rows r0 and r0 + 8 are
// pa[4kk..4kk+3], the accumulator's layout.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
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
// operands are pinned before wgmma.fence and after the commit.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq, uint64_t dk) {
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hw::wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
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

__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int* __restrict__ walked, int BH, int H, int N, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hw::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = hw::smem_u32(smem);
  FwdCtl* ctl = reinterpret_cast<FwdCtl*>(smem + 2 * kRegion);

  const int units = (N + kUnit - 1) / kUnit;  // per head
  const int total = BH * units;
  const int tiles = (N + kKeys - 1) / kKeys;  // key tiles per head
  const int G = 2 * gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g) {
      FwdCtl& c = ctl[g];
      for (int b = 0; b < 2; ++b) {
        hw::mbar_init(hw::smem_u32(&c.q_full[b]), 1);
        hw::mbar_init(hw::smem_u32(&c.q_empty[b]), 4);
      }
      for (int s = 0; s < kStages; ++s) {
        hw::mbar_init(hw::smem_u32(&c.k_full[s]), 1);
        hw::mbar_init(hw::smem_u32(&c.v_full[s]), 1);
        hw::mbar_init(hw::smem_u32(&c.empty[s]), 4);
      }
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // unit k of warpgroup w uses Q buffer k % 2 (phase (k / 2) & 1); the kv-th
  // walked tile uses ring stage kv % kStages (phase (kv / kStages) & 1)
  if (warp < 4) {
    // ---- producer: warp g feeds consumer warpgroup g
    hw::regs_dealloc<40>();
    if (warp < 2) {
      FwdCtl& c = ctl[warp];
      const uint32_t region = base + warp * kRegion;
      const uint32_t sK = region + 2 * kQBytes, sV = sK + kStages * kKVBytes;
      const int w = 2 * blockIdx.x + warp;
      int kv = 0;
      for (int k = 0;; ++k) {
        const int u = unit_at(w, k, G);
        if (u >= total) break;
        const int bh = u / units, q0 = (u % units) * kUnit, b = k & 1;
        const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
        const int2 own = sg ? asis::id_range(sg, q0, kUnit, N, lane) : make_int2(0, 0);
        if (lane == 0) {
          // the buffer's previous unit has had its last Q·Kᵀ
          hw::mbar_wait(hw::smem_u32(&c.q_empty[b]), ((k >> 1) & 1) ^ 1);
          hw::mbar_expect_tx(hw::smem_u32(&c.q_full[b]), kQBytes);
          hw::tma_load_3d(region + b * kQBytes, &qmap, hw::smem_u32(&c.q_full[b]), 0, q0, bh);
        }
        bool uni, uni_next;
        int j = next_live(sg, own, 0, tiles, kKeys, N, lane, uni);
        while (j < tiles) {
          const int nxt = next_live(sg, own, j + 1, tiles, kKeys, N, lane, uni_next);
          if (lane == 0) {
            const int s = kv % kStages;
            // the stage's previous tile has been read (passes at once in round 0)
            hw::mbar_wait(hw::smem_u32(&c.empty[s]), ((kv / kStages) & 1) ^ 1);
            c.tile[s] = j;
            c.flags[s] = (uni ? kUniform : 0) | (nxt >= tiles ? kLast : 0);
            hw::mbar_expect_tx(hw::smem_u32(&c.k_full[s]), kKVBytes);
            hw::tma_load_3d(sK + s * kKVBytes, &kmap, hw::smem_u32(&c.k_full[s]), 0, j * kKeys,
                            bh);
            hw::mbar_expect_tx(hw::smem_u32(&c.v_full[s]), kKVBytes);
            hw::tma_load_3d(sV + s * kKVBytes, &vmap, hw::smem_u32(&c.v_full[s]), 0, j * kKeys,
                            bh);
          }
          __syncwarp();
          ++kv;
          j = nxt;
          uni = uni_next;
        }
      }
      if (walked != nullptr && lane == 0) atomicAdd(walked, kv);
    }
  } else {
    // ---- consumer warpgroup g
    hw::regs_alloc<232>();
    const int g = (warp >> 2) - 1;
    FwdCtl& c = ctl[g];
    const uint32_t region = base + g * kRegion;
    const uint32_t sK = region + 2 * kQBytes, sV = sK + kStages * kKVBytes;
    const int w = 2 * blockIdx.x + g;
    const int tig = lane & 3, row = (warp & 3) * 16 + (lane >> 2);  // and row + 8
    float acc[32], sc[64];
    uint32_t pa[32];

    int kv = 0;
    for (int k = 0;; ++k) {
      const int u = unit_at(w, k, G);
      if (u >= total) break;
      const int bh = u / units, r0 = (u % units) * kUnit + row, b = k & 1;
      const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
      // rows ≥ N are not stored: any id will do
      const int id0 = sg && r0 < N ? __ldg(sg + r0) : 0;
      const int id1 = sg && r0 + 8 < N ? __ldg(sg + r0 + 8) : 0;
      const uint64_t dq = hw::sw128_desc(region + b * kQBytes);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 domain)
      float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums
      float a0, a1;

      // the first walked tile: S and its softmax (O is still zero)
      hw::mbar_wait(hw::smem_u32(&c.q_full[b]), (k >> 1) & 1);
      int s = kv % kStages;
      hw::mbar_wait(hw::smem_u32(&c.k_full[s]), (kv / kStages) & 1);
      int flags = c.flags[s], k0 = c.tile[s] * kKeys;
      issue_qk(sc, dq, hw::sw128_desc(sK + s * kKVBytes));
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);
      if ((flags & kLast) && lane == 0) hw::mbar_arrive(hw::smem_u32(&c.q_empty[b]));
      softmax(sc, flags, sg, k0, N, tig, sl2, id0, id1, m0, m1, a0, a1, l0, l1);
      pack_p(sc, pa);
      int prev = kv++;

      // the next walked tile: S_j = Q·K_jᵀ and O += P_{j−1}·V_{j−1} both in
      // flight; the softmax of S_j runs while P·V does; once P·V is in O
      // (the previous stage is read), O takes S_j's correction and P_j is
      // packed
      while (!(flags & kLast)) {
        s = kv % kStages;
        const int sp = prev % kStages;
        hw::mbar_wait(hw::smem_u32(&c.k_full[s]), (kv / kStages) & 1);
        flags = c.flags[s];
        k0 = c.tile[s] * kKeys;
        hw::mbar_wait(hw::smem_u32(&c.v_full[sp]), (prev / kStages) & 1);
        issue_qk(sc, dq, hw::sw128_desc(sK + s * kKVBytes));
        issue_pv(acc, pa, hw::sw128_desc(sV + sp * kKVBytes));
        hw::wgmma_wait<1>();  // S_j is ready; P·V may still run
        hw::fence_regs(sc);
        if ((flags & kLast) && lane == 0) hw::mbar_arrive(hw::smem_u32(&c.q_empty[b]));
        softmax(sc, flags, sg, k0, N, tig, sl2, id0, id1, m0, m1, a0, a1, l0, l1);
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::fence_regs(pa);
        if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.empty[sp]));
        rescale(acc, a0, a1);
        pack_p(sc, pa);
        prev = kv++;
      }

      // the last walked tile's P·V
      const int sl = prev % kStages;
      hw::mbar_wait(hw::smem_u32(&c.v_full[sl]), (prev / kStages) & 1);
      issue_pv(acc, pa, hw::sw128_desc(sV + sl * kKVBytes));
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::fence_regs(pa);
      if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.empty[sl]));

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // each row's own key is in its segment: m is a real score and l ≥ 1
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      __nv_bfloat16* head = o + static_cast<size_t>(bh) * N * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = i * 8 + tig * 2;
        if (r0 < N)
          *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0) * 64 + col) =
              pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (r0 + 8 < N)
          *reinterpret_cast<uint32_t*>(head + static_cast<size_t>(r0 + 8) * 64 + col) =
              pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
      if (tig == 0) {
        if (r0 < N) lse[static_cast<size_t>(bh) * N + r0] = (m0 + log2f(l0)) * kLn2;
        if (r0 + 8 < N) lse[static_cast<size_t>(bh) * N + r0 + 8] = (m1 + log2f(l1)) * kLn2;
      }
    }
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const int* seg, void* o,
                 float* lse, int* walked, int BH, int H, int N, float scale,
                 cudaStream_t stream) {
  static hw::LaunchCache cache;
  int sms = 0;
  const cudaError_t err = hw::prepare(cache, fa_fwd_wgmma_kernel, kSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);  // the max of raw scores
  CUtensorMap qm, km, vm;
  if (!hw::head_map(&qm, q, BH, N, kUnit) || !hw::head_map(&km, k, BH, N, kKeys) ||
      !hw::head_map(&vm, v, BH, N, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  // one CTA per SM (at most one per two units), each walking its units
  const int total = BH * ((N + kUnit - 1) / kUnit);
  fa_fwd_wgmma_kernel<<<std::min((total + 1) / 2, sms), kThreads, kSmemBytes, stream>>>(
      qm, km, vm, seg, static_cast<__nv_bfloat16*>(o), lse, walked, BH, H, N,
      scale * kLog2e);  // the kernel exponentiates with exp2
  return static_cast<int>(cudaGetLastError());
}

// ---- Hopper path: fp32, Dh = 64 (3×TF32) ------------------------------------
//
// The one fp32 Dh-64 forward of the port: K7's, and K3's fp32 path
// (flash_fwd.cu) launches it with one segment and no lse (`flash_fwd_tf32`,
// flash_attn.cuh). fp32 attention needs fp32 accuracy: one TF32 pass keeps
// 11 bits of q and k, a score error of ≈ 3e-4 relative, ten times what
// fp32 attention allows. So both products run 3×TF32 (hopper.cuh): each
// operand split x = hi + lo, three wgmmas per k8 step (lo·hi, hi·lo,
// hi·hi), at 3 × the operations on the TF32 rate: at tap_setr_ete's
// (16, 16, 1765, 64) 1.237 ms against 3.05 ms for exact fp32 FMAs on the
// CUDA cores. One persistent CTA of three warpgroups per SM walks units of
// 128 query rows of one head (`unit_at`), and per unit only the 64-key
// tiles whose segment range meets the unit's (`next_live`, the whole of
// warp 0 reducing the ids' ranges; without ids every tile):
//   * warp 0 (lane 0) issues the TMA loads: the unit's Q (128 rows, as two
//     halves of 32 fp32, each 128-byte swizzled) into the Q buffer, and each
//     walked key tile's raw K and V into a ring of kTStages raw stages, with
//     a header naming the tile, whether it needs the per-element mask and
//     whether it is the unit's last; it counts the walked tiles (`walked`);
//   * warps 1-3 split each raw stage into a split stage: K_hi and K_lo in
//     K's own layout (K-major for S = Q·Kᵀ), and Vᵀ_hi, Vᵀ_lo (keys
//     contiguous: K-major for O += P·V; 32-bit wgmma operands cannot be
//     transposed by the hardware) (hopper.cuh `split_kv_stage`), and copy
//     its header over;
//   * two consumer warpgroups of 64 query rows take their Q fragments from
//     the buffer once per unit, split in registers (64 registers, held for
//     the whole unit), and release it; per walked tile they run S (24
//     register-A wgmma m64n64k8), the bf16 path's softmax in the log2 domain
//     (ids compared per pair on a straddling tile, kMaskValue for a pair of
//     different segments, keys ≥ N at −inf), split P in registers
//     (unrounded: p stays fp32 to 2⁻²²) and run the tile's P·V (24 more).
// The tensor cores truncate (round toward zero) at every accumulation into
// an fp32 accumulator, so a long chain of wgmmas drifts one way: O summed
// over a 1765-token walk in one accumulator is ≈ 670 such steps, with 4–6 ×
// the error of the same products summed in round-to-nearest. So each
// tile's P·V starts a fresh accumulator and is added as O = O·a + P·V by
// one rounded FMA (which also applies the max correction a), and in each
// product the small terms (lo·hi, hi·lo) go first, while the accumulator is
// small, and hi·hi last. P's accumulator layout gives a thread keys 2t and
// 2t + 1 of each 8-key step, where the tf32 A fragment wants keys t and
// t + 4: the fragment takes them as logical keys t and t + 4 (hopper.cuh
// `split_frags`), and the split writes Vᵀ's keys in the same order. The
// consumer warpgroups are not paired by barriers: each waits for its own
// products, and the other's fill the tensor cores meanwhile. The epilogue
// stores O / l and, where asked, lse = (m + log2 l)·ln 2 for rows < N.
// Shared memory: Q 32 KB, two raw stages of 32 KB, two split stages of
// 64 KB. Numerics as the bf16 path: the scale after q·kᵀ, p unrounded.

constexpr int kTRows = 128;                        // query rows per unit
constexpr int kTKeys = 64;                         // keys per tile
constexpr int kTStages = 2;                        // raw and split ring depth
constexpr int kTQBytes = kTRows * 64 * 4;          // 32 KB: two 16 KB halves
constexpr int kTHalf = kTKeys * 128;               // 8 KB: 64 rows of 32 fp32
constexpr int kTRawBytes = 4 * kTHalf;             // K, V raw: two halves each
constexpr int kTSplitBytes = 8 * kTHalf;           // K_hi, K_lo, Vᵀ_hi, Vᵀ_lo
constexpr int kTRawOffset = kTQBytes;
constexpr int kTSplitOffset = kTRawOffset + kTStages * kTRawBytes;
constexpr int kTCtlOffset = kTSplitOffset + kTStages * kTSplitBytes;
constexpr int kSplitWarps = 3;
constexpr int kConsumerWarps = 8;

struct TfCtl {
  uint64_t q_full, q_empty, raw_full[kTStages], raw_empty[kTStages], split_full[kTStages],
      split_empty[kTStages];
  int raw_tile[kTStages], raw_flags[kTStages], tile[kTStages], flags[kTStages];
};
constexpr int kTSmemBytes = kTCtlOffset + static_cast<int>(sizeof(TfCtl)) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                   float* __restrict__ o, float* __restrict__ lse, int* __restrict__ walked,
                   int BH, int H, int N, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = hw::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw_addr);
  TfCtl& c = *reinterpret_cast<TfCtl*>(base_ptr + kTCtlOffset);

  const int units = (N + kTRows - 1) / kTRows;  // per head
  const int total = BH * units;
  const int tiles = (N + kTKeys - 1) / kTKeys;  // key tiles per head
  const int G = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hw::mbar_init(hw::smem_u32(&c.q_full), 1);
    hw::mbar_init(hw::smem_u32(&c.q_empty), kConsumerWarps);
    for (int s = 0; s < kTStages; ++s) {
      hw::mbar_init(hw::smem_u32(&c.raw_full[s]), 1);
      hw::mbar_init(hw::smem_u32(&c.raw_empty[s]), kSplitWarps);
      hw::mbar_init(hw::smem_u32(&c.split_full[s]), kSplitWarps);
      hw::mbar_init(hw::smem_u32(&c.split_empty[s]), kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  // unit k of this CTA: unit_at(blockIdx.x, k, G); its Q phase k & 1. The
  // kv-th walked tile uses stage kv % kTStages of both rings (phase
  // (kv / kTStages) & 1). All three roles walk the same sequence.
  if (warp < 4) {
    hw::regs_dealloc<56>();
    if (warp == 0) {
      int kv = 0;
      for (int k = 0;; ++k) {
        const int u = unit_at(blockIdx.x, k, G);
        if (u >= total) break;
        const int bh = u / units, q0 = (u % units) * kTRows;
        const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
        const int2 own = sg ? asis::id_range(sg, q0, kTRows, N, lane) : make_int2(0, 0);
        if (lane == 0) {
          // the previous unit's Q is in the consumers' registers
          hw::mbar_wait(hw::smem_u32(&c.q_empty), (k & 1) ^ 1);
          hw::mbar_expect_tx(hw::smem_u32(&c.q_full), kTQBytes);
          hw::tma_load_3d(base, &qmap, hw::smem_u32(&c.q_full), 0, q0, bh);
          hw::tma_load_3d(base + kTQBytes / 2, &qmap, hw::smem_u32(&c.q_full), 32, q0, bh);
        }
        bool uni, uni_next;
        int j = next_live(sg, own, 0, tiles, kTKeys, N, lane, uni);
        while (j < tiles) {
          const int nxt = next_live(sg, own, j + 1, tiles, kTKeys, N, lane, uni_next);
          if (lane == 0) {
            const int s = kv % kTStages;
            const uint32_t full = hw::smem_u32(&c.raw_full[s]);
            // the stage's previous tile is split (passes at once in round 0)
            hw::mbar_wait(hw::smem_u32(&c.raw_empty[s]), ((kv / kTStages) & 1) ^ 1);
            c.raw_tile[s] = j;
            c.raw_flags[s] = (uni ? kUniform : 0) | (nxt >= tiles ? kLast : 0);
            const uint32_t st = base + kTRawOffset + s * kTRawBytes;
            hw::mbar_expect_tx(full, kTRawBytes);
            hw::tma_load_3d(st, &kmap, full, 0, j * kTKeys, bh);
            hw::tma_load_3d(st + kTHalf, &kmap, full, 32, j * kTKeys, bh);
            hw::tma_load_3d(st + 2 * kTHalf, &vmap, full, 0, j * kTKeys, bh);
            hw::tma_load_3d(st + 3 * kTHalf, &vmap, full, 32, j * kTKeys, bh);
          }
          __syncwarp();
          ++kv;
          j = nxt;
          uni = uni_next;
        }
      }
      if (walked != nullptr && lane == 0) atomicAdd(walked, kv);
    } else {
      const int x = threadIdx.x - 32;
      int kv = 0;
      for (int k = 0; unit_at(blockIdx.x, k, G) < total; ++k) {
        for (bool last = false; !last; ++kv) {
          const int s = kv % kTStages, ph = (kv / kTStages) & 1;
          hw::mbar_wait(hw::smem_u32(&c.raw_full[s]), ph);
          const int tile = c.raw_tile[s], flags = c.raw_flags[s];
          last = flags & kLast;
          hw::mbar_wait(hw::smem_u32(&c.split_empty[s]), ph ^ 1);  // passes at once in round 0
          hw::split_kv_stage<32 * kSplitWarps>(base_ptr + kTRawOffset + s * kTRawBytes,
                                               base_ptr + kTSplitOffset + s * kTSplitBytes, x);
          hw::fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            if (warp == 1) {
              c.tile[s] = tile;
              c.flags[s] = flags;
            }
            hw::mbar_arrive(hw::smem_u32(&c.raw_empty[s]));
            hw::mbar_arrive(hw::smem_u32(&c.split_full[s]));
          }
        }
      }
    }
  } else {
    hw::regs_alloc<224>();
    const int wg = (warp >> 2) - 1, tig = lane & 3;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and row + 8
    uint32_t qhi[8][4], qlo[8][4], plo[8][4];
    float acc[32], pv[32], sc[32];

    int kv = 0;
    for (int k = 0;; ++k) {
      const int u = unit_at(blockIdx.x, k, G);
      if (u >= total) break;
      const int bh = u / units, r0 = (u % units) * kTRows + row;
      const int* sg = seg ? seg + static_cast<size_t>(bh / H) * N : nullptr;
      // rows ≥ N are not stored: any id will do
      const int id0 = sg && r0 < N ? __ldg(sg + r0) : 0;
      const int id1 = sg && r0 + 8 < N ? __ldg(sg + r0 + 8) : 0;
      // Q's fragments: rows row, row + 8, dims 8kk + tig (+ 4) in half kk / 4
      hw::mbar_wait(hw::smem_u32(&c.q_full), k & 1);
      {
        const int sw = row & 7;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float* h0 = reinterpret_cast<const float*>(
              base_ptr + (kk >> 2) * (kTQBytes / 2) + row * 128);
          const float* h1 = h0 + 8 * 32;  // row + 8
          const int c0 = (((2 * kk) & 7) ^ sw) * 4 + tig, c1 = (((2 * kk + 1) & 7) ^ sw) * 4 + tig;
          hw::tf32_split(h0[c0], qhi[kk][0], qlo[kk][0]);
          hw::tf32_split(h1[c0], qhi[kk][1], qlo[kk][1]);
          hw::tf32_split(h0[c1], qhi[kk][2], qlo[kk][2]);
          hw::tf32_split(h1[c1], qhi[kk][3], qlo[kk][3]);
        }
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.q_empty));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 domain)
      float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sums
      for (bool last = false; !last; ++kv) {
        const int s = kv % kTStages;
        hw::mbar_wait(hw::smem_u32(&c.split_full[s]), (kv / kTStages) & 1);
        const int flags = c.flags[s], k0 = c.tile[s] * kTKeys;
        last = flags & kLast;
        const uint32_t st = base + kTSplitOffset + s * kTSplitBytes;
        // S = Q·Kᵀ: K_hi at st, K_lo at st + 2·kTHalf, each two dim halves;
        // the small products first, while S is small
        hw::fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          hw::fence_regs(qhi[kk]);
          hw::fence_regs(qlo[kk]);
        }
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t dk = hw::sw128_desc(st + (kk >> 2) * kTHalf) + 2 * (kk & 3);
          const uint64_t dl = dk + ((2 * kTHalf) >> 4);
          hw::wgmma_m64n64k8_tf32_rs(sc, qlo[kk], dk, kk > 0);
          hw::wgmma_m64n64k8_tf32_rs(sc, qhi[kk], dl, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hw::wgmma_m64n64k8_tf32_rs(sc, qhi[kk], hw::sw128_desc(st + (kk >> 2) * kTHalf) +
                                                      2 * (kk & 3), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          hw::fence_regs(qhi[kk]);
          hw::fence_regs(qlo[kk]);
        }
        float a0, a1;
        softmax(sc, flags, sg, k0, N, tig, sl2, id0, id1, m0, m1, a0, a1, l0, l1);
        hw::split_frags(sc, plo);  // P_hi in S's registers
        // this tile's P·V into pv (Vᵀ_hi at st + 4·kTHalf, Vᵀ_lo at
        // st + 6·kTHalf, each two key halves), the small products first
        hw::fence_regs(pv);
        hw::fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) hw::fence_regs(plo[kk]);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t phi[4];
          hw::hi_frag(sc, kk, phi);
          const uint64_t dv = hw::sw128_desc(st + (4 + (kk >> 2)) * kTHalf) + 2 * (kk & 3);
          hw::wgmma_m64n64k8_tf32_rs(pv, plo[kk], dv, kk > 0);
          hw::wgmma_m64n64k8_tf32_rs(pv, phi, dv + ((2 * kTHalf) >> 4), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t phi[4];
          hw::hi_frag(sc, kk, phi);
          hw::wgmma_m64n64k8_tf32_rs(
              pv, phi, hw::sw128_desc(st + (4 + (kk >> 2)) * kTHalf) + 2 * (kk & 3), 1);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(pv);
        hw::fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) hw::fence_regs(plo[kk]);
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(hw::smem_u32(&c.split_empty[s]));
        // O = O·a + P·V in fp32 round-to-nearest
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[4 * i] = fmaf(acc[4 * i], a0, pv[4 * i]);
          acc[4 * i + 1] = fmaf(acc[4 * i + 1], a0, pv[4 * i + 1]);
          acc[4 * i + 2] = fmaf(acc[4 * i + 2], a1, pv[4 * i + 2]);
          acc[4 * i + 3] = fmaf(acc[4 * i + 3], a1, pv[4 * i + 3]);
        }
      }

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // each row's own key is in its segment: m is a real score and l ≥ 1
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      float* head = o + static_cast<size_t>(bh) * N * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = i * 8 + tig * 2;
        if (r0 < N)
          *reinterpret_cast<float2*>(head + static_cast<size_t>(r0) * 64 + col) =
              make_float2(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (r0 + 8 < N)
          *reinterpret_cast<float2*>(head + static_cast<size_t>(r0 + 8) * 64 + col) =
              make_float2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
      if (tig == 0 && lse != nullptr) {
        if (r0 < N) lse[static_cast<size_t>(bh) * N + r0] = (m0 + log2f(l0)) * kLn2;
        if (r0 + 8 < N) lse[static_cast<size_t>(bh) * N + r0 + 8] = (m1 + log2f(l1)) * kLn2;
      }
    }
  }
}

}  // namespace

int asis::flash_fwd_tf32(const void* q, const void* k, const void* v, const int* seg, void* o,
                          float* lse, int* walked, int BH, int H, int N, float scale,
                          cudaStream_t stream) {
  static hw::LaunchCache cache;
  int sms = 0;
  const cudaError_t err = hw::prepare(cache, fa_fwd_tf32_kernel, kTSmemBytes, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);  // the max of raw scores
  CUtensorMap qm, km, vm;
  if (!hw::head_map_f32(&qm, q, BH, N, kTRows) || !hw::head_map_f32(&km, k, BH, N, kTKeys) ||
      !hw::head_map_f32(&vm, v, BH, N, kTKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = BH * ((N + kTRows - 1) / kTRows);
  fa_fwd_tf32_kernel<<<std::min(total, sms), kThreads, kTSmemBytes, stream>>>(
      qm, km, vm, seg, static_cast<float*>(o), lse, walked, BH, H, N, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

namespace {

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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B·H, N, Dh) in one dtype (is_bf16: bfloat16, else
// float32), Dh one of 16, 32, 64 (64: the tensor-core kernels, which take
// scale > 0); seg: contiguous (B, N) int32 segment ids, or null for one
// segment; lse: (B·H, N) float32, natural log. walked: null, or one int32
// to which the Dh-64 kernels add the tile pairs they walked, (64 queries,
// 128 keys) in bf16 and (128, 64) in fp32, counted by the warp that streams
// them (the consumers follow their headers; counting there costs spills);
// the CUDA-core paths (Dh 16, 32) walk every pair and leave it as it is.
// Launches on `stream`, writes the AttnKernel it launched to *kernel
// (flash_attn.cuh) and returns cudaGetLastError() (0 = launched).
int asis_flash_attn_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                        float* lse, int* walked, int B, int H, int N, int Dh, float scale,
                        int is_bf16, int* kernel, void* stream) {
  const int BH = B * H;
  if (B <= 0 || H <= 0 || N <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) {
    *kernel = is_bf16 ? asis::kAttnWgmma : asis::kAttnTf32x3;
    return is_bf16 ? launch_wgmma(q, k, v, seg, o, lse, walked, BH, H, N, scale, s)
                   : asis::flash_fwd_tf32(q, k, v, seg, o, lse, walked, BH, H, N, scale, s);
  }
  *kernel = asis::kAttnCudaCores;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, seg, o, lse, BH, H, N, Dh, scale, s)
                 : dispatch<float>(q, k, v, seg, o, lse, BH, H, N, Dh, scale, s);
}

}  // extern "C"
