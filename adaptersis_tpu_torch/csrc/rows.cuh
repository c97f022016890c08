// Row helpers shared by the LayerNorm kernel (layernorm.cu) and the GEMMs'
// epilogues (ln_gemm.cu): 16-byte vector loads and stores of bf16 or fp32
// rows as fp32 registers, parameters read as stored, and the per-row
// statistics of the TPU kernels (fp32 sums, fast variance E[x²] − E[x]²).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16.cuh"

namespace asis {

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements in one 16-byte load
};

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 a;
  a.x = pack_bf16(v[0], v[1]);
  a.y = pack_bf16(v[2], v[3]);
  a.z = pack_bf16(v[4], v[5]);
  a.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = a;
}

// n consecutive fp32 values (n a multiple of 4), 16-byte aligned.
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[n]) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = a.z;
    v[i + 3] = a.w;
  }
}

// A parameter vector (LayerNorm scale or shift, bias, LayerScale) as the
// module stores it, bf16 (is_bf16) or fp32, read as fp32: element i, or n
// consecutive elements from i (n and i multiples of 4, the vector 16-byte
// aligned).
__device__ __forceinline__ float param_at(const void* p, int i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

template <int n>
__device__ __forceinline__ void load_param(const void* p, int i, bool is_bf16, float (&v)[n]) {
  if (!is_bf16) {
    load_f32(static_cast<const float*>(p) + i, v);
    return;
  }
  const uint2* q = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
#pragma unroll
  for (int j = 0; j < n / 4; ++j) {
    const uint2 a = q[j];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
    v[4 * j] = lo.x;
    v[4 * j + 1] = lo.y;
    v[4 * j + 2] = hi.x;
    v[4 * j + 3] = hi.y;
  }
}

// One row of C values held in registers by the 32 lanes of a warp: lane l's
// i-th 16-byte vector starts at element (32·i + l)·V, V = Vec<T>::n; vectors
// at or past C are not loaded (and must not be read). NV is a compile-time
// count, so every load is issued before the first sum.
template <typename T>
__device__ __forceinline__ bool vec_in_row(int i, int C, int lane) {
  return (32 * i + lane) * Vec<T>::n < C;
}

template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* row, int C, int lane,
                                         float (&v)[NV][Vec<T>::n]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (vec_in_row<T>(i, C, lane)) load_vec(row + (32 * i + lane) * Vec<T>::n, v[i]);
}

// (mean, rstd) of the row in registers, as the TPU kernels compute them
// (adaptersis_tpu/ops/layernorm.py `_ln_kernel`): fp32 sums of x and x²,
// each lane over its vectors in order, then across the warp; var = E[x²] −
// E[x]², rstd = 1/√(var + eps). Every lane returns the result.
template <typename T, int NV>
__device__ __forceinline__ float2 row_stats(const float (&v)[NV][Vec<T>::n], int C, float eps,
                                            int lane) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!vec_in_row<T>(i, C, lane)) continue;
#pragma unroll
    for (int j = 0; j < Vec<T>::n; ++j) {
      s1 += v[i][j];
      s2 += v[i][j] * v[i][j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float inv_c = 1.f / static_cast<float>(C);
  const float mean = s1 * inv_c;
  const float var = s2 * inv_c - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

}  // namespace asis
