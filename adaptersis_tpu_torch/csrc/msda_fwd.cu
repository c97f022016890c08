// Multi-scale deformable attention, forward (K1):
//   out[b, q, m·D + d] = Σ_{l,p} aw[b,q,m,l,p] · bilinear(V_l[b, :, m, d], loc[b,q,m,l,p])
// with grid_sample semantics (align_corners=False, zero padding): the sample
// point is x = loc_x·W_l − 0.5, y = loc_y·H_l − 0.5, and each of its four
// corners that falls outside level l contributes nothing.
//
// Replaces: adaptersis_tpu/ops/msda_pallas.py `_fwd_kernel` (via `_fwd_impl`),
// the Pallas kernel behind msda_impl="pallas". The TPU kernel built a dense
// one-hot sampling matrix per tile and multiplied it on the MXU; Hopper
// gathers, so this kernel reads the corner rows of the natural (B, S, M, D)
// value layout directly.
//
// What bounds it on the H100. HBM bytes: at the CAViT shapes of the training
// step (ViT-L/14 @ 588 px, B = 16, Lq = 1764, M = 8, D = 128, L = 3, P = 4,
// bf16 value) it must read V (228 MB), loc and aw (33 MB) and write the fp32
// output (116 MB): 0.11 ms at 3.35 TB/s; at CACNN (Lq = 6949, L = 1) it
// writes 455 MB, 0.17 ms. The gather moves more through the L2: every
// in-level corner re-reads a 256-byte value row, up to 48 rows per (b, q, m),
// ≈ 2 GB per call on uniform points, while V[b, :, m, :] of the heads in
// flight (1.8 MB each) stays in the 50 MB L2. So the L2's rate and the loads'
// latency bound it, not arithmetic (2 FLOP per byte read); phase 9 of
// chip_smoke.py prints the corner-row bytes and the rate reached.
//
// Design (msda.cuh): one warp per unit (b, q, m), or two units a warp when a
// unit has 16 corners (CACNN: a round of 32 corners would be half empty),
// units ordered (b, m, q) so that a block's warps take neighbouring queries
// of one head, whose points share corner rows in L1. The L·P points' loc and
// aw are read once, coalesced; lanes compute the corner table and hand tokens
// and weights out by __shfl_sync; each 256-byte corner row is read as 16
// lanes × 16 bytes, two corners per warp instruction, four steps' loads (eight
// at two units a warp) issued before their FMAs; an out-of-level corner is a
// predicated-off load of weight 0. Sums are fp32; the two half-warps' sums
// are added at the end. Output (B, Lq, M·D) in fp32, as msda_pallas returns
// it. Values bf16 or fp32, D a multiple of 16 bytes up to 256 values (fewer
// lanes per row for narrower heads: 4 lanes for D = 16 fp32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda.cuh"

namespace {

using namespace asis::msda;

// Corner steps whose loads are issued before their FMAs, and the blocks an SM
// holds (the register budget): measured best for one and two units a round.
template <int UPR>
constexpr int kBatch = UPR == 1 ? 4 : 8;
template <int UPR>
constexpr int kBlocksPerSM = UPR == 1 ? 5 : 4;

template <typename T, int G, int NV, int UPR>
__global__ void __launch_bounds__(kUnitWarps * 32, kBlocksPerSM<UPR>)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, float* __restrict__ out, int B, int S, int M,
                int D, int Lq, int L, int P, Levels lv) {
  constexpr int NG = 32 / G, VEC = Row<T>::kVec, CPU = 32 / UPR;
  const int lane = threadIdx.x & 31;
  const long long units = (long long)B * M * Lq;  // ordered (b, m, q)
  const long long u0 = ((long long)blockIdx.x * kUnitWarps + (threadIdx.x >> 5)) * UPR;
  if (u0 >= units) return;
  const int NPT = L * P, NC = 4 * NPT;
  const size_t row = (size_t)M * D;  // elements per value token
  Unit<T> un[UPR];
  bool live[UPR];
#pragma unroll
  for (int s = 0; s < UPR; ++s) {
    live[s] = u0 + s < units;
    const long long unit = live[s] ? u0 + s : u0;
    const int seg = (int)(unit / Lq);  // b·M + m
    un[s] = unit_at(value, loc, aw, seg / M, (int)(unit % Lq), seg % M, S, M, D, Lq, NPT);
  }
  const int h = lane / G, gl = lane % G;
  const int jl = gl * NG + h;            // this lane's corner in a round's table
  const int ls = UPR > 1 ? jl / CPU : 0;  // and its unit
  const float* lu = un[0].loc;
  const float* au = un[0].aw;
  bool alive = live[0];
#pragma unroll
  for (int s = 1; s < UPR; ++s)
    if (ls == s) {
      lu = un[s].loc;
      au = un[s].aw;
      alive = live[s];
    }

  float acc[UPR][NV][VEC];
#pragma unroll
  for (int s = 0; s < UPR; ++s)
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[s][i][v] = 0.f;

  for (int r0 = 0; r0 < NC; r0 += 32) {  // with UPR > 1, NC = CPU: one round
    const Corner c = corner_at(lu, au, UPR > 1 ? jl % CPU : r0 + jl, alive ? NPT : 0, P, lv);
    const int tok = c.token;
    const float wt = corner_weight(c);
    const int steps = UPR > 1 ? G : min(G, (NC - r0 + NG - 1) / NG);
#pragma unroll
    for (int k0 = 0; k0 < G; k0 += kBatch<UPR>) {
      uint4 raw[kBatch<UPR>][NV];
      float wk[kBatch<UPR>];
#pragma unroll
      for (int u = 0; u < kBatch<UPR>; ++u) {
        const int k = k0 + u;
        if (k < G) {
          const int src = h * G + k;
          const int tk = __shfl_sync(kFull, tok, src);
          wk[u] = __shfl_sync(kFull, wt, src);
          const T* r = un[UPR > 1 ? NG * k / CPU : 0].v + (size_t)tk * row;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int ch = (gl + G * i) * VEC;
            raw[u][i] = (k < steps && tk >= 0 && ch < D)
                            ? __ldg(reinterpret_cast<const uint4*>(r + ch))
                            : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch<UPR>; ++u) {
        const int k = k0 + u;
        if (k < G && k < steps) {
          float(&a)[NV][VEC] = acc[UPR > 1 ? NG * k / CPU : 0];
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            float f[VEC];
            Row<T>::unpack(raw[u][i], f);
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[i][v] = fmaf(wk[u], f[v], a[i][v]);
          }
        }
      }
    }
  }

  // the groups' sums, added in a fixed order
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int s = 0; s < UPR; ++s)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[s][i][v] += __shfl_xor_sync(kFull, acc[s][i][v], off);
  if (h == 0) {
#pragma unroll
    for (int s = 0; s < UPR; ++s) {
      if (!live[s]) continue;
      float* dst = out + un[s].pu * D;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int ch = (gl + G * i) * VEC;
        if (ch < D) {
#pragma unroll
          for (int v = 0; v < VEC; v += 4)
            *reinterpret_cast<float4*>(dst + ch + v) =
                make_float4(acc[s][i][v], acc[s][i][v + 1], acc[s][i][v + 2], acc[s][i][v + 3]);
        }
      }
    }
  }
}

template <typename T, int G, int NV>
int launch(const void* value, const float* loc, const float* aw, float* out, int B, int S,
           int M, int D, int Lq, int L, int P, const Levels& lv, cudaStream_t stream) {
  const int upr = units_per_round(4 * L * P);
  const long long units = (long long)B * M * Lq;
  const long long blocks = (units + kUnitWarps * upr - 1) / (kUnitWarps * upr);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (upr == 2)
    msda_fwd_kernel<T, G, NV, 2><<<(unsigned)blocks, kUnitWarps * 32, 0, stream>>>(
        static_cast<const T*>(value), loc, aw, out, B, S, M, D, Lq, L, P, lv);
  else
    msda_fwd_kernel<T, G, NV, 1><<<(unsigned)blocks, kUnitWarps * 32, 0, stream>>>(
        static_cast<const T*>(value), loc, aw, out, B, S, M, D, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* value, const float* loc, const float* aw, float* out, int B, int S,
             int M, int D, int Lq, int L, int P, const Levels& lv, cudaStream_t s) {
  constexpr int VEC = Row<T>::kVec;
  if (D % VEC) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = D / VEC;
  switch (group_lanes(nvec)) {
    case 4: return launch<T, 4, 1>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
    case 8: return launch<T, 8, 1>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
    case 16: return launch<T, 16, 1>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
    case 32:
      if (nvec <= 32) return launch<T, 32, 1>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
      if constexpr (VEC == 4)
        return launch<T, 32, 2>(value, loc, aw, out, B, S, M, D, Lq, L, P, lv, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// value (B, S, M, D) bf16 (is_bf16) or fp32, 16-byte aligned, D·element size
// a multiple of 16 bytes, D ≤ 256; loc (B, Lq, M, L, P, 2) fp32, 8-byte aligned;
// aw (B, Lq, M, L, P) fp32; out (B, Lq, M·D) fp32; all contiguous.
// shapes: host array of L (H, W) pairs; starts: host array of L level offsets
// into S. Launches on `stream` and returns cudaGetLastError() (0 = launched).
int asis_msda_fwd(const void* value, const void* loc, const void* aw, void* out, int B,
                  int S, int M, int D, int Lq, int L, int P, const int* shapes,
                  const int* starts, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 256 || B < 1 || M < 1 || Lq < 1 || P < 1 ||
      reinterpret_cast<uintptr_t>(value) % 16 || reinterpret_cast<uintptr_t>(loc) % 8)
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
