// Shared pieces of K7, the flash attention with segment ids
// (flash_attn_fwd.cu, flash_attn_bwd.cu): the mask value, the element
// conversions of the CUDA-core paths, the bf16 rounding points, the codes
// of the kernels a launch reports, and the Hopper paths' tile skipping and
// work schedule (their tensor maps and launch cache are hopper.cuh's).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace asis {

// A pair whose segments differ gets the library kernel's additive mask
// value, −0.7·f32max (flash_attention.py DEFAULT_MASK_VALUE), not −inf: a row
// whose first key tiles are all masked keeps a finite max and a finite sum,
// which the first tile with a key of its own segment rescales by exp(−huge)
// = 0. The log2-domain kernels use the same constant unscaled: multiplied
// by log2(e) it would overflow to −inf.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// p and ds are rounded to the input dtype before the products they feed,
// as the library kernel casts them (p.astype(v.dtype), ds.astype(k.dtype))
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The segment of token i of a row (all tokens share segment 0 without ids).
__device__ __forceinline__ int segment_of(const int* seg, int i) { return seg ? seg[i] : 0; }

// The kernel a launch of asis_flash_attn_fwd or asis_flash_attn_bwd ran, as
// they write it to *kernel: ops/flash_attn.py:KERNELS names them in this
// order.
enum AttnKernel { kAttnWgmma = 0, kAttnTf32x3 = 1, kAttnCudaCores = 2 };

// ---- Hopper paths (Dh = 64: bf16, and fp32 as 3×TF32) ----------------------
//
// Tile skipping. A (query tile, key tile) pair is walked only if the two
// tiles' segment-id ranges [min, max] overlap: disjoint ranges share no id,
// so every pair of a skipped tile is masked, its p = exp(mask − ·) is an
// exact 0 and so is its ds. The rule is exact for any ids (interleaved ids
// simply skip nothing); ops/flash_attn.py `live_tiles` states the same rule
// for the tests and chip_smoke.py. A walked tile whose two ranges are the
// same single id ("uniform") needs no per-element mask; the others
// (straddling a segment boundary) compare ids per element.

// [min, max] of the ids of tokens start .. start + len − 1 (< N) of one row,
// reduced by the whole warp (every lane gets it).
__device__ __forceinline__ int2 id_range(const int* __restrict__ sg, int start, int len, int N,
                                         int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  const int end = min(start + len, N);
  for (int i = start + lane; i < end; i += 32) {
    const int id = __ldg(sg + i);
    lo = min(lo, id);
    hi = max(hi, id);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  return make_int2(lo, hi);
}

// The first tile j0, j0 + 1, ... of `tiles` tiles of `len` tokens whose id
// range meets `own`; `tiles` if none. `uniform` says whether its range and
// `own` are one and the same id. Without ids every tile meets and is
// uniform. Called by a whole warp.
__device__ __forceinline__ int next_live(const int* __restrict__ sg, int2 own, int j0, int tiles,
                                         int len, int N, int lane, bool& uniform) {
  uniform = true;
  if (sg == nullptr) return j0;
  for (int j = j0; j < tiles; ++j) {
    const int2 r = id_range(sg, j * len, len, N, lane);
    if (r.x <= own.y && own.x <= r.y) {
      uniform = r.x == r.y && own.x == own.y && r.x == own.x;
      return j;
    }
  }
  return tiles;
}

// Work schedule. Each of G workers w (a consumer warpgroup of the bf16
// kernels, G = 2·gridDim.x; a CTA of the fp32 ones, G = gridDim.x) walks its
// own units (a tile of rows of one head: unit i is head i / per_head, tile
// i % per_head): at step k unit k·G + (w + k) mod G. Each step covers G
// consecutive units, so the tiles of a head run together and share the L2,
// and a worker's tile position within the head changes from step to step,
// so the heavy tiles (the long segment's) are spread over all workers.
// Producer and consumer compute the same sequence; it rises
// with k, so the first unit ≥ total ends it.
__device__ __forceinline__ int unit_at(int w, int k, int G) { return k * G + (w + k) % G; }

// Stage header: the tile a ring stage holds and its flags, written by the
// producer before its arrival on the stage's full barrier and read by the
// consumers after their wait (the arrival releases, the wait acquires).
constexpr int kUniform = 1;  // the tile pair needs no per-element segment mask
constexpr int kLast = 2;     // the unit's last walked tile

// The fp32 Dh-64 forward (3×TF32 on wgmma, flash_attn_fwd.cu
// fa_fwd_tf32_kernel), shared by K7 and K3's fp32 path (flash_fwd.cu, which
// passes no ids and no lse). q, k, v, o: contiguous (BH, N, 64) fp32,
// 16-byte aligned; seg: (BH / H, N) int32 or null; lse: (BH, N) fp32 or
// null; walked: null or one int32 that takes the (128, 64) tile pairs
// walked; scale > 0. Returns cudaGetLastError() (0 = launched).
int flash_fwd_tf32(const void* q, const void* k, const void* v, const int* seg, void* o,
                   float* lse, int* walked, int BH, int H, int N, float scale,
                   cudaStream_t stream);

}  // namespace asis
