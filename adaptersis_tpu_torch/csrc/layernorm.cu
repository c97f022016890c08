// Row LayerNorm (K6), also the LayerNorm pass before the GEMMs of K4 and K5
// (ln_gemm.cu).
//
// Replaces: adaptersis_tpu/ops/layernorm.py `_ln_kernel` (via `_ln_fwd_impl`),
// the Pallas kernel behind ln_impl="pallas": y = (x − mean)·(rstd·w) + b
// with fp32 statistics in the fast-variance form var = E[x²] − E[x]², eps
// 1e-6 on the main path, output in x's dtype.
//
// What bounds it on the H100: it reads x once and writes y once, 4 bytes per
// bf16 element and a few operations each: at the main path's (16·1765,
// 1024) bf16 one call moves 115.7 MB, ≈ 0.035 ms at 3.35 TB/s; at the
// serving batch of 2, 14.5 MB, ≈ 0.0043 ms, less than the host takes to
// launch a kernel. So the design is about bytes and latency: one warp per
// row, the whole row in registers (NV 16-byte vectors per lane, a compile-
// time count, so each lane issues all its loads before the first sum),
// statistics from those registers and warp shuffles, then normalise and
// store without reading the row again; nothing written but y.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
// The vectors per lane the kernels are built for; a row takes the smallest
// that covers it, so C ≤ 16·32·V (4096 bf16, 2048 fp32).
constexpr int kMaxVectors = 16;

template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const void* __restrict__ b, bool params_bf16, T* __restrict__ y, int R, int C,
                 float eps) {
  constexpr int V = asis::Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  float v[NV][V];
  asis::load_row<T, NV>(x + static_cast<size_t>(row) * C, C, lane, v);
  const float2 st = asis::row_stats<T, NV>(v, C, eps, lane);
  T* yr = y + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!asis::vec_in_row<T>(i, C, lane)) continue;
    const int c = (32 * i + lane) * V;
    float wv[V], bv[V];
    asis::load_param(w, c, params_bf16, wv);
    asis::load_param(b, c, params_bf16, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = (v[i][j] - st.x) * (st.y * wv[j]) + bv[j];
    asis::store_vec(yr + c, v[i]);
  }
}

// Calls launch(std::integral_constant<int, NV>) with the smallest built NV
// that holds `vectors` per lane.
template <typename F>
int with_vectors(int vectors, F&& launch) {
  if (vectors <= 1) return launch(std::integral_constant<int, 1>{});
  if (vectors <= 2) return launch(std::integral_constant<int, 2>{});
  if (vectors <= 4) return launch(std::integral_constant<int, 4>{});
  if (vectors <= 8) return launch(std::integral_constant<int, 8>{});
  if (vectors <= kMaxVectors) return launch(std::integral_constant<int, kMaxVectors>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int vectors_per_lane(int C) {
  return (C / asis::Vec<T>::n + 31) / 32;
}

template <typename T>
int launch_layernorm(const void* x, const void* w, const void* b, bool pbf, void* y, int R,
                     int C, float eps, cudaStream_t s) {
  const dim3 grid((R + kWarps - 1) / kWarps);
  return with_vectors(vectors_per_lane<T>(C), [&](auto nv) {
    layernorm_kernel<T, decltype(nv)::value><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(x), w, b, pbf, static_cast<T*>(y), R, C, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

bool bad_shape(int R, int C, int vec) { return R <= 0 || C <= 0 || C % vec != 0; }

}  // namespace

extern "C" {

// x, y: contiguous (R, C) in one dtype (is_bf16: bfloat16, else float32);
// w, b: (C,) bfloat16 (params_bf16) or float32, 16-byte aligned; C a
// multiple of 8, at most 4096 (bf16) or 2048 (fp32). Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int asis_layernorm(const void* x, const void* w, const void* b, void* y, int R, int C,
                   float eps, int is_bf16, int params_bf16, void* stream) {
  if (bad_shape(R, C, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pbf = params_bf16 != 0;
  return is_bf16 ? launch_layernorm<__nv_bfloat16>(x, w, b, pbf, y, R, C, eps, s)
                 : launch_layernorm<float>(x, w, b, pbf, y, R, C, eps, s);
}

}  // extern "C"
