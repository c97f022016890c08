// Shared pieces of K7, the flash attention with segment ids
// (flash_attn_fwd.cu, flash_attn_bwd.cu): the mask value, the element
// conversions of the CUDA-core paths, and the bf16 rounding points.

#pragma once

#include <cuda_bf16.h>
#include <float.h>

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

}  // namespace asis
