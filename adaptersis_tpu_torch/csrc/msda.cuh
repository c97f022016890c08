// The gather shared by the deformable-attention forward (msda_fwd.cu) and the
// point pass of its backward (msda_bwd.cu).
//
// One warp serves one unit (b, q, m): its L·P sample points, 4 bilinear
// corners each, NC = 4·L·P corners, taken in rounds of 32. Per round:
//   * the corner table: lane L computes one corner from the point's loc and
//     aw (loaded once per round, 8 points of 12 bytes: one coalesced read),
//     its token (the row to read), its bilinear weights and whether it lies
//     inside the level. An out-of-level corner has token −1: its load is
//     predicated off and it takes weight 0, no branch, and the same sum as
//     the plain version's `valid` mask (which multiplies its weight by 0);
//   * the gather: a corner row of D values is read by a group of G lanes,
//     16 bytes each (G = 16 for D = 128 bf16: one warp instruction reads two
//     corner rows), so NG = 32 / G corners are read per instruction and a
//     round takes G steps. At step k, group h reads corner NG·k + h, whose
//     token it takes from the table lane by __shfl_sync. The table lane of
//     corner j is lane(j) = (j mod NG)·G + j / NG, so after the backward's
//     transpose reduction (`group_transpose_sum`) the full dot product of a
//     corner lands in its own table lane.
// A sample point x = loc_x·W − 0.5 is rounded as PyTorch and XLA round it
// (product, then difference: `__fmul_rn`/`__fsub_rn`, no fused multiply-add),
// so a point within rounding of a pixel centre takes the same corners as the
// plain version in both kernels.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace asis {
namespace msda {

constexpr int kMaxLevels = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitWarps = 8;  // warps (units) per block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// One corner of one sample point, as the table lane computes it.
struct Corner {
  int token;     // row in value's S axis; −1 outside the level
  bool inside;   // the corner lies inside the level (and the point exists)
  float wx, wy;  // bilinear weights along x and y
  float a;       // the point's attention weight
  float W, H;    // the level's width and height
};

__device__ __forceinline__ Corner corner_at(const float* __restrict__ locu,
                                            const float* __restrict__ awu, int jj, int NPT,
                                            int P, const Levels& lv) {
  Corner c{-1, false, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int pt = jj >> 2, k = jj & 3;
  if (pt >= NPT) return c;
  const int l = pt / P;
  int H = lv.h[0], W = lv.w[0], start = lv.start[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (l == i) {
      H = lv.h[i];
      W = lv.w[i];
      start = lv.start[i];
    }
  const float2 xy = __ldg(reinterpret_cast<const float2*>(locu) + pt);
  const float x = __fsub_rn(__fmul_rn(xy.x, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, (float)H), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = x - x0f, ty = y - y0f;
  const int xi = (int)x0f + (k & 1), yi = (int)y0f + (k >> 1);
  c.inside = xi >= 0 && xi < W && yi >= 0 && yi < H;
  if (c.inside) c.token = start + yi * W + xi;
  c.wx = (k & 1) ? tx : 1.f - tx;
  c.wy = (k >> 1) ? ty : 1.f - ty;
  c.a = __ldg(awu + pt);
  c.W = (float)W;
  c.H = (float)H;
  return c;
}

// When a unit has 16 corners (L·P = 4: CACNN's single level), a warp's round
// of 32 corners serves two units, one per half of the corner table: UPR
// units per round. Otherwise a unit takes ceil(NC / 32) rounds of its own.
inline int units_per_round(int nc) { return nc == 16 ? 2 : 1; }

// The pointers of one unit (b, q, m).
template <typename T>
struct Unit {
  const float* loc;  // its (L·P, 2) sample locations
  const float* aw;   // its L·P attention weights
  const T* v;        // value[b, 0, m, :]; token s is at + s·M·D
  size_t pu;         // (b·Lq + q)·M + m: its place in loc, aw, out, g, dloc, daw
};

template <typename T>
__device__ __forceinline__ Unit<T> unit_at(const T* value, const float* loc, const float* aw,
                                           int b, int q, int m, int S, int M, int D, int Lq,
                                           int NPT) {
  Unit<T> u;
  u.pu = ((size_t)b * Lq + q) * M + m;
  u.loc = loc + u.pu * NPT * 2;
  u.aw = aw + u.pu * NPT;
  u.v = value + (size_t)b * S * M * D + (size_t)m * D;
  return u;
}

// The forward's weight of a corner, a·wx·wy rounded as (wx·wy)·a (the plain
// version's w·valid·a), or 0 outside the level.
__device__ __forceinline__ float corner_weight(const Corner& c) {
  return c.inside ? (c.wx * c.wy) * c.a : 0.f;
}

// 16 bytes of a corner row as fp32: 8 bf16 or 4 fp32 values.
template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[kVec]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);  // element 2i is the low half
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[kVec]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

// After the call, lane gl of each G-lane group holds the sum over the group's
// lanes of v[gl]: G − 1 shuffles for G values (a warp reduction of each would
// take G·log2 G).
template <int G>
__device__ __forceinline__ float group_transpose_sum(float (&v)[G], int gl) {
#pragma unroll
  for (int step = G / 2; step >= 1; step /= 2) {
    const bool upper = (gl & step) != 0;
#pragma unroll
    for (int t = 0; t < step; ++t) {
      const float send = upper ? v[t] : v[t + step];
      const float keep = upper ? v[t + step] : v[t];
      v[t] = keep + __shfl_xor_sync(kFull, send, step);
    }
  }
  return v[0];
}

// Lanes per corner row for a head width of `nvec` 16-byte vectors: the
// kernels are instantiated for G = 4, 8, 16, 32 (and two vectors a lane at
// G = 32); 0 when D is wider than 64 vectors.
inline int group_lanes(int nvec) {
  return nvec <= 4 ? 4 : nvec <= 8 ? 8 : nvec <= 16 ? 16 : nvec <= 64 ? 32 : 0;
}

}  // namespace msda
}  // namespace asis
