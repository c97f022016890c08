// Multi-scale deformable attention, forward:
//   out[b, q, m·D + d] = Σ_{l,p} aw[b,q,m,l,p] · bilinear(V_l[b, :, m, d], loc[b,q,m,l,p])
// with grid_sample semantics (align_corners=False, zero padding): the sample
// point is x = loc_x·W_l − 0.5, y = loc_y·H_l − 0.5, and each of its four
// corners that falls outside level l contributes nothing.
//
// Replaces: adaptersis_tpu/ops/msda_pallas.py `_fwd_kernel` (via `_fwd_impl`),
// the Pallas kernel behind msda_impl="pallas".
//
// What bounds it on the H100: it is a gather. Per (b, q, m) it reads
// L·P·4 corner rows of D values; at the CAViT shapes (B=2, Lq=1764, M=8,
// L=3, P=4, D=128, bf16) that is ≈ 173 MB of corner reads from a 28 MB value
// tensor, which stays in the 50 MB L2. So the bound is L2 bandwidth and load
// latency, not arithmetic (2 FLOP per byte read).
//
// Design: the TPU kernel built a dense one-hot sampling matrix per tile and
// multiplied it on the MXU, with activation tables to skip empty tiles —
// devices for a machine whose gathers are slow. Hopper gathers well, so this
// kernel gathers directly from the natural (B, S, M, D) value layout:
//   * one warp per (b, q, m); lane t holds channels t, t+32, ... (D/32 of
//     them), so every corner read of the warp is one contiguous run along D;
//   * a loop over (l, p) computes the sample point and its four corners,
//     skips corners outside the level, and accumulates in fp32;
//   * output (B, Lq, M·D) in fp32, as msda_pallas returns it.
// Locations and weights are fp32; value is bf16 or fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // warps per block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// CPL = channels per lane = ceil(D / 32)
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out, int B, int S,
                int M, int D, int Lq, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Lq * M) return;
  const int m = (int)(warp % M);
  const long long bq = warp / M;  // b·Lq + q
  const int b = (int)(bq / Lq);

  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

  const float* locw = loc + warp * L * P * 2;  // (L, P, 2) of this (b, q, m)
  const float* aww = aw + warp * L * P;        // (L, P)
  const size_t row = (size_t)M * D;            // elements per value token
  const T* vbm = value + (size_t)b * S * row + (size_t)m * D;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const T* vl = vbm + (size_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      // rounded as loc·W − 0.5 rounds in PyTorch and XLA (product, then
      // difference: no fused multiply-add), so a point within rounding of a
      // pixel edge takes the same corners as the plain version and K2
      const float x = __fsub_rn(__fmul_rn(locw[(l * P + p) * 2], (float)W), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locw[(l * P + p) * 2 + 1], (float)H), 0.5f);
      const float a = aww[l * P + p];
      const float x0f = floorf(x), y0f = floorf(y);
      const float tx = x - x0f, ty = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int xi = x0 + (corner & 1), yi = y0 + (corner >> 1);
        if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
        const float wx = (corner & 1) ? tx : 1.f - tx;
        const float wy = (corner >> 1) ? ty : 1.f - ty;
        const float wgt = wx * wy * a;
        const T* src = vl + (size_t)(yi * W + xi) * row;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = i * 32 + lane;
          if (c < D) acc[i] = fmaf(wgt, to_f32(src[c]), acc[i]);
        }
      }
    }
  }

  float* dst = out + bq * row + (size_t)m * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = i * 32 + lane;
    if (c < D) dst[c] = acc[i];
  }
}

template <typename T, int CPL>
int launch(const void* value, const float* loc, const float* aw, float* out, int B,
           int S, int M, int D, int Lq, int L, int P, const Levels& lv,
           cudaStream_t stream) {
  const long long warps = (long long)B * Lq * M;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_fwd_kernel<T, CPL><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, out, B, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* value, const float* loc, const float* aw, float* out, int B,
             int S, int M, int D, int Lq, int L, int P, const Levels& lv,
             cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 64) return launch<T, 2>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 128) return launch<T, 4>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 256) return launch<T, 8>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// value (B, S, M, D) bf16 (is_bf16) or fp32; loc (B, Lq, M, L, P, 2) fp32;
// aw (B, Lq, M, L, P) fp32; out (B, Lq, M·D) fp32; all contiguous.
// shapes: host array of L (H, W) pairs; starts: host array of L level offsets
// into S. Launches on `stream` and returns cudaGetLastError() (0 = launched).
int asis_msda_fwd(const void* value, const void* loc, const void* aw, void* out, int B,
                  int S, int M, int D, int Lq, int L, int P, const int* shapes,
                  const int* starts, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 256 || B < 1 || M < 1 || Lq < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = starts[l];
  }
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(aw);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(value, lp, ap, op, B, S, M, D, Lq, L, P, lv, s)
                 : dispatch<float>(value, lp, ap, op, B, S, M, D, Lq, L, P, lv, s);
}

}  // extern "C"
