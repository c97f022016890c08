// Multi-scale deformable attention, backward: given g = ∂loss/∂out of the
// forward (msda_fwd.cu),
//   dV[b, s, m, :]        = Σ over the corners (q, l, p, c) that land on s of a·wx·wy·g[b, q, m, :]
//   daw[b, q, m, l, p]    = Σ_c wx·wy·⟨V_l[corner c], g⟩
//   dloc_x[b, q, m, l, p] = a·W_l · Σ_c (∂wx/∂tx)·wy·⟨V_l[corner c], g⟩
//   dloc_y[b, q, m, l, p] = a·H_l · Σ_c wx·(∂wy/∂ty)·⟨V_l[corner c], g⟩
// with a = aw[b, q, m, l, p], ∂wx/∂tx = −1 for the x0 corner and +1 for the
// x0+1 corner (likewise in y). Corners outside level l contribute to no
// gradient, as they contribute nothing to the forward.
//
// Replaces: adaptersis_tpu/ops/msda_pallas.py `_msda_bwd` and the five TPU
// kernels it chooses between (`_bwd_merged_gather_kernel`,
// `_bwd_merged_uform_kernel`, `_bwd_merged_kernel`, `_bwd_dq_kernel`,
// `_bwd_dv_kernel`): one function, computed once here. The TPU path rounds g
// to the value dtype (bf16) before its products; this kernel reads g in fp32,
// which is the exact gradient of the forward.
//
// What bounds it on the H100: bytes. At the CAViT shapes of ViT-L/14 @ 588 px
// (B=2, Lq=1764, M=8, D=128, L=3, P=4, bf16 value) it must read V (28.5 MB),
// loc, aw and g (fp32, 14.5 MB) and write dV, dloc and daw: 79.5 MB, 0.024 ms
// at 3.35 TB/s; at CACNN (Lq=6949, L=1) 82.0 MB. The arithmetic is ≈ 4 FLOP
// per byte. What it really moves is more: every corner of every point
// re-reads a value row and adds a row into dV, ≈ 4·L·P row reads and atomic
// row adds per (b, q, m).
//
// Design (a simple, right first kernel, in K1's layout):
//   * one warp per (b, q, m); lane t holds channels t, t+32, ... of g (read
//     once, fp32) and of each corner's value row, so every corner read and
//     every atomic row add of the warp is one contiguous run along D;
//   * per (l, p) the sample point, its floors, tx, ty and the validity of
//     its four corners are recomputed exactly as K1 computes them;
//   * dV is scattered with fp32 atomicAdd into a zeroed fp32 scratch of
//     (B, S, M, D) that the wrapper casts to the value's dtype. The order of
//     the adds changes from run to run (≈ 63 adds per element at CACNN), so
//     dV is reproducible only to fp32 rounding;
//   * the three per-point sums are warp-reduced with __shfl_xor_sync and lane
//     0 writes daw, dloc_x and dloc_y.
// Not yet done: sorting the scatter by destination or summing it in shared
// memory, which would make dV deterministic and cut the atomic traffic.

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// CPL = channels per lane = ceil(D / 32)
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const float* __restrict__ grad,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ daw, int B, int S, int M, int D, int Lq, int L, int P,
                Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Lq * M) return;
  const int m = (int)(warp % M);
  const long long bq = warp / M;  // b·Lq + q
  const int b = (int)(bq / Lq);

  const size_t row = (size_t)M * D;  // elements per value token
  float gv[CPL];
  const float* gw = grad + bq * row + (size_t)m * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = i * 32 + lane;
    gv[i] = c < D ? gw[c] : 0.f;
  }

  const float* locw = loc + warp * L * P * 2;  // (L, P, 2) of this (b, q, m)
  const float* aww = aw + warp * L * P;        // (L, P)
  float* dlocw = dloc + warp * L * P * 2;
  float* daww = daw + warp * L * P;
  const size_t bm = (size_t)b * S * row + (size_t)m * D;
  const T* vbm = value + bm;
  float* dvbm = dvalue + bm;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const size_t lstart = (size_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      // rounded as loc·W − 0.5 rounds in PyTorch and XLA (product, then
      // difference: no fused multiply-add), so a point within rounding of a
      // pixel edge takes the same corners, and derivative, as the plain version
      const float x = __fsub_rn(__fmul_rn(locw[(l * P + p) * 2], (float)W), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locw[(l * P + p) * 2 + 1], (float)H), 0.5f);
      const float a = aww[l * P + p];
      const float x0f = floorf(x), y0f = floorf(y);
      const float tx = x - x0f, ty = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      float s_a = 0.f, s_x = 0.f, s_y = 0.f;  // this lane's share of the three sums
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int xi = x0 + (corner & 1), yi = y0 + (corner >> 1);
        if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
        const float wx = (corner & 1) ? tx : 1.f - tx;
        const float wy = (corner >> 1) ? ty : 1.f - ty;
        const float dwx = (corner & 1) ? 1.f : -1.f;
        const float dwy = (corner >> 1) ? 1.f : -1.f;
        const size_t off = lstart + (size_t)(yi * W + xi) * row;
        const T* src = vbm + off;
        float* dst = dvbm + off;
        const float wgt = a * wx * wy;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = i * 32 + lane;
          if (c < D) {
            dot = fmaf(to_f32(src[c]), gv[i], dot);
            atomicAdd(dst + c, wgt * gv[i]);
          }
        }
        s_a = fmaf(wx * wy, dot, s_a);
        s_x = fmaf(dwx * wy, dot, s_x);
        s_y = fmaf(wx * dwy, dot, s_y);
      }
      s_a = warp_sum(s_a);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        daww[l * P + p] = s_a;
        dlocw[(l * P + p) * 2] = a * W * s_x;
        dlocw[(l * P + p) * 2 + 1] = a * H * s_y;
      }
    }
  }
}

template <typename T, int CPL>
int launch(const void* value, const float* loc, const float* aw, const float* grad,
           float* dvalue, float* dloc, float* daw, int B, int S, int M, int D, int Lq,
           int L, int P, const Levels& lv, cudaStream_t stream) {
  const long long warps = (long long)B * Lq * M;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_bwd_kernel<T, CPL><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), loc, aw, grad, dvalue, dloc, daw, B, S, M, D, Lq, L,
      P, lv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* value, const float* loc, const float* aw, const float* grad,
             float* dvalue, float* dloc, float* daw, int B, int S, int M, int D, int Lq,
             int L, int P, const Levels& lv, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 1>(value, loc, aw, grad, dvalue, dloc, daw, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 64)
    return launch<T, 2>(value, loc, aw, grad, dvalue, dloc, daw, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 128)
    return launch<T, 4>(value, loc, aw, grad, dvalue, dloc, daw, B, S, M, D, Lq, L, P, lv, s);
  if (D <= 256)
    return launch<T, 8>(value, loc, aw, grad, dvalue, dloc, daw, B, S, M, D, Lq, L, P, lv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// value (B, S, M, D) bf16 (is_bf16) or fp32; loc (B, Lq, M, L, P, 2) fp32;
// aw (B, Lq, M, L, P) fp32; grad (B, Lq, M·D) fp32; dvalue (B, S, M, D) fp32,
// ZEROED by the caller (the kernel adds into it); dloc like loc and daw like
// aw, fp32, fully written. All contiguous. shapes: host array of L (H, W)
// pairs; starts: host array of L level offsets into S. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int asis_msda_bwd(const void* value, const void* loc, const void* aw, const void* grad,
                  void* dvalue, void* dloc, void* daw, int B, int S, int M, int D, int Lq,
                  int L, int P, const int* shapes, const int* starts, int is_bf16,
                  void* stream) {
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
  const float* gp = static_cast<const float*>(grad);
  float* dvp = static_cast<float*>(dvalue);
  float* dlp = static_cast<float*>(dloc);
  float* dap = static_cast<float*>(daw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(value, lp, ap, gp, dvp, dlp, dap, B, S, M, D, Lq,
                                           L, P, lv, s)
                 : dispatch<float>(value, lp, ap, gp, dvp, dlp, dap, B, S, M, D, Lq, L, P,
                                   lv, s);
}

}  // extern "C"
