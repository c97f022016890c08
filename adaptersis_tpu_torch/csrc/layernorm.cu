// Row LayerNorm (K6) and the row statistics the LayerNorm-prologue GEMMs
// (K4, K5: ln_gemm.cu) read.
//
// Replaces: adaptersis_tpu/ops/layernorm.py `_ln_kernel` (via `_ln_fwd_impl`),
// the Pallas kernel behind ln_impl="pallas": y = (x − mean)·(rstd·w) + b
// with fp32 statistics in the fast-variance form var = E[x²] − E[x]², eps
// 1e-6 on the main path, output in x's dtype.
//
// What bounds it on the H100: it reads x once and writes y once, 4 bytes per
// bf16 element and a few operations each: at the main path's (16·1765,
// 1024) bf16 one call moves 115.7 MB, ≈ 0.035 ms at 3.35 TB/s. So the design
// is about bytes: one warp per row, 16-byte loads and stores, the row's
// second read (for the normalisation) served from L1, statistics in
// registers and warp shuffles, nothing written but y.
//
// The statistics kernel is the same first pass, writing (mean, rstd) as two
// fp32 per row: K4 and K5 normalise their A tiles with them while loading.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const void* __restrict__ b, bool params_bf16, T* __restrict__ y, int R, int C,
                 float eps) {
  constexpr int V = asis::Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * C;
  T* yr = y + static_cast<size_t>(row) * C;
  const float2 st = asis::warp_row_stats(xr, C, eps, lane);
  for (int c = lane * V; c < C; c += 32 * V) {
    float v[V], wv[V], bv[V];
    asis::load_vec(xr + c, v);
    asis::load_param(w, c, params_bf16, wv);
    asis::load_param(b, c, params_bf16, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (v[j] - st.x) * (st.y * wv[j]) + bv[j];
    asis::store_vec(yr + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
row_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int R, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const float2 st = asis::warp_row_stats(x + static_cast<size_t>(row) * C, C, eps, lane);
  if (lane == 0) stats[row] = st;
}

bool bad_shape(int R, int C, int vec) { return R <= 0 || C <= 0 || C % vec != 0; }

}  // namespace

extern "C" {

// x, y: contiguous (R, C) in one dtype (is_bf16: bfloat16, else float32);
// w, b: (C,) bfloat16 (params_bf16) or float32, 16-byte aligned; C a
// multiple of 8. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int asis_layernorm(const void* x, const void* w, const void* b, void* y, int R, int C,
                   float eps, int is_bf16, int params_bf16, void* stream) {
  if (bad_shape(R, C, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kWarps - 1) / kWarps);
  const bool pbf = params_bf16 != 0;
  if (is_bf16)
    layernorm_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, b, pbf, static_cast<__nv_bfloat16*>(y), R,
        C, eps);
  else
    layernorm_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), w, b, pbf, static_cast<float*>(y), R, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// x: contiguous (R, C) as above; stats: (R, 2) float32, (mean, rstd) per row.
int asis_row_stats(const void* x, void* stats, int R, int C, float eps, int is_bf16,
                   void* stream) {
  if (bad_shape(R, C, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kWarps - 1) / kWarps);
  float2* st = static_cast<float2*>(stats);
  if (is_bf16)
    row_stats_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), st, R, C, eps);
  else
    row_stats_kernel<float><<<grid, kWarps * 32, 0, s>>>(static_cast<const float*>(x), st,
                                                         R, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
