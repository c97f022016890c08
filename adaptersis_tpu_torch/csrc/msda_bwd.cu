// Multi-scale deformable attention, backward (K2): given g = ∂loss/∂out of the
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
// `_bwd_dv_kernel`). The TPU kernels' dV is the product Aᵀ·g accumulated
// tile by tile in one fixed order; so is this one's: dV has the same bits on
// every call. The TPU path rounds g to the value dtype (bf16) before its
// products; these kernels read g in fp32, the exact gradient of the forward
// (a bf16 copy of g for the dV pass gained little on the H100: the pass is
// held by its shared-memory traffic, not by the bytes of g; PERF.md §6).
//
// What bounds it on the H100. HBM bytes: at the CAViT shapes of the training
// step (ViT-L/14 @ 588 px, B = 16, Lq = 1764, M = 8, D = 128, L = 3, P = 4,
// bf16 value) it must read V (228 MB), loc and aw (33 MB) and g (fp32,
// 116 MB) and write dV (228 MB), dloc and daw (33 MB): 0.19 ms at
// 3.35 TB/s; at CACNN (Lq = 6949, L = 1) 0.20 ms. Through the L2 it moves
// far more: each in-level corner re-reads a 256-byte value row (up to 2.8 GB
// per call, as K1) and adds a 512-byte fp32 g row into dV (up to 5.5 GB);
// phase 9 of chip_smoke.py prints both and the rate reached.
//
// Design: four passes, no float atomics.
//   1. Point pass (`point_kernel`), one warp per unit (b, q, m) (two per round
//      at CACNN's 16 corners), K1's gather (msda.cuh): each 16-byte slice of
//      a corner row is dotted with the lane's slice of g, the corners'
//      partial dots are reduced by a transpose reduction (one shuffle per
//      corner), and the four corners of a point by two shuffles; daw and
//      dloc are written once. The pass also writes one dV entry per
//      in-level corner, in source order (b, m, q, l, p, c): its bin
//      (destination token / 8), the query and token within the bin, and the
//      weight a·wx·wy rounded as K1 rounds it; and each block (a tile of
//      about 2048 entries of one (b, m)) counts its entries per bin
//      (shared-memory int atomics: counts do not depend on order).
//   2. Tile sort (`sort_kernel`), one warp per tile: the tile's entries in
//      source order, 32 at a time, take their places in shared memory by
//      bin (lanes of one bin by __match_any_sync and the count of lower
//      lanes: a stable counting sort), then go out as one contiguous write
//      into the tile's own region, with each bin's offset there. Sorting
//      straight into (b, m)-wide bins instead scatters 4- to 20-byte runs,
//      whose partly written sectors made that pass several times slower
//      on the H100.
//   3. Plan (`plan_kernel`), one block per (b, m): each bin's entries over
//      all tiles, and its chunks of at most kChunk entries in walk order
//      (tile by tile, each tile's run in source order). Sum warp d takes
//      bin d's first chunk; an exclusive scan gives each further chunk a
//      warp after the bins' and each bin of more than one chunk its slots
//      of partial rows.
//   4. Sum (`sum_kernel`), one warp per chunk: it walks its chunk of its
//      bin's runs, tile by tile (a lane-parallel search finds the tile of
//      each of 32 entries at once), so every token's contributions come in
//      source order, whatever the scheduling; it reads each g row with
//      16-byte loads (four rows in flight), adds w·g into the token's row in
//      shared memory, then writes the 8 dV rows once, in the value's dtype.
//      A bin of more chunks (a hot token: one that takes every corner of a
//      head, as trained offsets can make it) is summed by as many warps:
//      each writes its fp32 partial rows to its slot, and the last to
//      arrive (an int counter) adds the slots in chunk order and writes dV.
//      Which warp adds them varies; the order of the sum does not.
// Scratch (entries, counts, offsets, plan, partial rows) is one workspace from the caller
// (`asis_msda_bwd_workspace` bytes); dV is written, not accumulated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "bf16.cuh"
#include "msda.cuh"

namespace {

using namespace asis::msda;

constexpr int kBatch = 4;            // corner steps whose loads precede their FMAs
constexpr int kBinTokens = 8;        // destination tokens per bin (one sum warp)
constexpr int kTileEntries = 2048;   // dV entries per block of the point pass, about
constexpr uint16_t kNoBin = 0xFFFF;  // the entry of an out-of-level corner
constexpr int kRounds = 4;           // rounds of 32 entries a sort warp loads ahead
constexpr int kSortWarps = 4;        // tiles (one a warp) per sort block, at most
constexpr int kSumBatch = 4;         // g rows in flight per sum warp
constexpr int kChunk = 1024;         // entries of a bin one sum warp takes, at most
constexpr int kPlanThreads = 1024;   // bins a plan block takes at a time
constexpr int kSmemCap = 48 * 1024;  // dynamic shared memory without an opt-in

struct Geometry {
  int npt, nc, segs, ndig, upw, tiles, te;  // te: entries per tile, at most
  int extra, slots;  // per (b, m): chunks after bins' first, partial-row slots, at most
  size_t entries;
};

Geometry geometry(int B, int S, int M, int Lq, int L, int P) {
  Geometry g{};
  g.npt = L * P;
  g.nc = 4 * g.npt;
  g.segs = B * M;
  g.ndig = (S + kBinTokens - 1) / kBinTokens;
  g.upw = kTileEntries / (kUnitWarps * g.nc);
  if (g.upw < 1) g.upw = 1;
  g.upw += g.upw % units_per_round(g.nc);  // a warp takes whole rounds
  const int tu = kUnitWarps * g.upw;
  g.tiles = (Lq + tu - 1) / tu;
  g.te = tu * g.nc;
  g.entries = (size_t)g.segs * Lq * g.nc;
  // a bin of n > kChunk entries has ceil(n / kChunk) < 2·n / kChunk chunks,
  // so its chunks after the first number < n / kChunk, and all its chunks
  // < 2·n / kChunk: over the bins, < n_seg / kChunk and 2·n_seg / kChunk
  const long long per_seg = (long long)Lq * g.nc;
  g.extra = (int)(per_seg / kChunk) + 1;
  g.slots = (int)(2 * per_seg / kChunk) + 1;
  return g;
}

// The workspace, carved in 256-byte aligned pieces.
struct Work {
  uint16_t* bin;   // per entry in source order: its bin, or kNoBin
  uint32_t* pay;   // per entry: q·8 + token mod 8
  float* w;        // per entry: a·wx·wy
  uint2* sorted;   // (pay, w) per entry, each tile's sorted by bin (stable) in its region
  int* count;      // (b·M + m, tile, bin): the tile's entries in the bin
  int* offset;     // (b·M + m, tile, bin): where the bin's run starts in the tile's region
  int4* binfo;     // (b·M + m, bin): entries, first further chunk, first slot, parts arrived
  int* chunk_bin;  // (b·M + m, further chunk): its bin
  int* nchunks;    // (b·M + m): its further chunks
  float* partial;  // (b·M + m, slot, 8 tokens, D): a chunk's fp32 rows
};

size_t layout(const Geometry& g, int D, char* base, Work* wk) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  Work w{};
  w.bin = reinterpret_cast<uint16_t*>(take(g.entries * sizeof(uint16_t)));
  w.pay = reinterpret_cast<uint32_t*>(take(g.entries * sizeof(uint32_t)));
  w.w = reinterpret_cast<float*>(take(g.entries * sizeof(float)));
  w.sorted = reinterpret_cast<uint2*>(take(g.entries * sizeof(uint2)));
  w.count = reinterpret_cast<int*>(take((size_t)g.segs * g.tiles * g.ndig * sizeof(int)));
  w.offset = reinterpret_cast<int*>(take((size_t)g.segs * g.tiles * g.ndig * sizeof(int)));
  w.binfo = reinterpret_cast<int4*>(take((size_t)g.segs * g.ndig * sizeof(int4)));
  w.chunk_bin = reinterpret_cast<int*>(take((size_t)g.segs * g.extra * sizeof(int)));
  w.nchunks = reinterpret_cast<int*>(take((size_t)g.segs * sizeof(int)));
  w.partial = reinterpret_cast<float*>(
      take((size_t)g.segs * g.slots * kBinTokens * D * sizeof(float)));
  if (wk) *wk = w;
  return off;
}

// ---- 1. point pass: daw, dloc, and the dV entries -------------------------

template <typename T, int G, int NV, int UPR>
__global__ void __launch_bounds__(kUnitWarps * 32, 4)
point_kernel(const T* __restrict__ value, const float* __restrict__ loc,
             const float* __restrict__ aw, const float* __restrict__ grad,
             float* __restrict__ dloc, float* __restrict__ daw, Work wk, int S, int M, int D,
             int Lq, int L, int P, int ndig, int upw, int tiles, Levels lv) {
  constexpr int NG = 32 / G, VEC = Row<T>::kVec, CPU = 32 / UPR;
  // the lanes holding corners 1 and 2 of a point, relative to corner 0's
  constexpr int M1 = NG >= 2 ? G : 1;
  constexpr int M2 = NG >= 4 ? 2 * G : (NG == 2 ? 1 : 2);
  extern __shared__ int shist[];  // this block's entries per bin
  for (int i = threadIdx.x; i < ndig; i += blockDim.x) shist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x, seg = blockIdx.y;
  const int m = seg % M, b = seg / M;
  const int NPT = L * P, NC = 4 * NPT;
  const size_t row = (size_t)M * D;
  const int h = lane / G, gl = lane % G;
  const int jl = gl * NG + h;            // this lane's corner in a round's table
  const int ls = UPR > 1 ? jl / CPU : 0;  // and its unit
  const int kc = jl & 3;                 // which corner of its point
  const float dwx = (kc & 1) ? 1.f : -1.f, dwy = (kc >> 1) ? 1.f : -1.f;

  for (int u = 0; u < upw; u += UPR) {
    const int q0 = (t * kUnitWarps + warp) * upw + u;
    if (q0 >= Lq) break;
    Unit<T> un[UPR];
    float gr[UPR][NV][VEC];  // this lane's slice of each unit's g
#pragma unroll
    for (int s = 0; s < UPR; ++s) {
      un[s] = unit_at(value, loc, aw, b, min(q0 + s, Lq - 1), m, S, M, D, Lq, NPT);
      const float* gu = grad + un[s].pu * D;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int ch = (gl + G * i) * VEC;
#pragma unroll
        for (int v = 0; v < VEC; v += 4) {
          const float4 x = ch < D ? __ldg(reinterpret_cast<const float4*>(gu + ch + v))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          gr[s][i][v] = x.x;
          gr[s][i][v + 1] = x.y;
          gr[s][i][v + 2] = x.z;
          gr[s][i][v + 3] = x.w;
        }
      }
    }
    // the unit of this lane's table corner
    const int q = q0 + ls;
    const bool alive = q < Lq;
    const float* lu = un[0].loc;
    const float* au = un[0].aw;
    size_t pu = un[0].pu;
#pragma unroll
    for (int s = 1; s < UPR; ++s)
      if (ls == s) {
        lu = un[s].loc;
        au = un[s].aw;
        pu = un[s].pu;
      }
    const size_t e0 = ((size_t)seg * Lq + q) * NC;  // its first entry

    for (int r0 = 0; r0 < NC; r0 += 32) {  // with UPR > 1, NC = CPU: one round
      const int jj = UPR > 1 ? jl % CPU : r0 + jl;  // the corner within its unit
      const Corner c = corner_at(lu, au, jj, alive ? NPT : 0, P, lv);
      const int tok = c.token;
      const int steps = UPR > 1 ? G : min(G, (NC - r0 + NG - 1) / NG);
      float dot[G];  // this lane's partial ⟨row, g⟩ of each step's corner
#pragma unroll
      for (int k0 = 0; k0 < G; k0 += kBatch) {
        uint4 raw[kBatch][NV];
#pragma unroll
        for (int u2 = 0; u2 < kBatch; ++u2) {
          const int k = k0 + u2;
          if (k < G) {
            const int tk = __shfl_sync(kFull, tok, h * G + k);
            const T* r = un[UPR > 1 ? NG * k / CPU : 0].v + (size_t)tk * row;
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              const int ch = (gl + G * i) * VEC;
              raw[u2][i] = (k < steps && tk >= 0 && ch < D)
                               ? __ldg(reinterpret_cast<const uint4*>(r + ch))
                               : make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
#pragma unroll
        for (int u2 = 0; u2 < kBatch; ++u2) {
          const int k = k0 + u2;
          if (k < G) {
            const float(&gk)[NV][VEC] = gr[UPR > 1 ? NG * k / CPU : 0];
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              float f[VEC];
              Row<T>::unpack(raw[u2][i], f);
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc = fmaf(f[v], gk[i][v], acc);
            }
            dot[k] = acc;
          }
        }
      }
      // the full dot of this lane's own table corner
      const float d = group_transpose_sum<G>(dot, gl);
      float sa = c.inside ? (c.wx * c.wy) * d : 0.f;
      float sx = c.inside ? (dwx * c.wy) * d : 0.f;
      float sy = c.inside ? (c.wx * dwy) * d : 0.f;
      sa += __shfl_xor_sync(kFull, sa, M1);
      sx += __shfl_xor_sync(kFull, sx, M1);
      sy += __shfl_xor_sync(kFull, sy, M1);
      sa += __shfl_xor_sync(kFull, sa, M2);
      sx += __shfl_xor_sync(kFull, sx, M2);
      sy += __shfl_xor_sync(kFull, sy, M2);
      const int pt = jj >> 2;
      if (alive && kc == 0 && pt < NPT) {
        daw[pu * NPT + pt] = sa;
        reinterpret_cast<float2*>(dloc)[pu * NPT + pt] =
            make_float2(c.a * c.W * sx, c.a * c.H * sy);
      }
      if (alive && jj < NC) {  // this corner's dV entry
        const size_t e = e0 + jj;
        if (c.inside) {
          const int bin = c.token / kBinTokens;
          wk.bin[e] = static_cast<uint16_t>(bin);
          wk.pay[e] = (static_cast<uint32_t>(q) << 3) | static_cast<uint32_t>(c.token & 7);
          wk.w[e] = corner_weight(c);
          atomicAdd(&shist[bin], 1);
        } else {
          wk.bin[e] = kNoBin;
        }
      }
    }
  }
  __syncthreads();
  int* hout = wk.count + ((size_t)seg * tiles + t) * ndig;
  for (int i = threadIdx.x; i < ndig; i += blockDim.x) hout[i] = shist[i];
}

// ---- 2. tile sort: each tile's entries by bin, stable ---------------------

// Shared memory of one sort warp: per bin its next local place; per local
// place the tile entry there.
size_t sort_warp_bytes(const Geometry& g) {
  return ((size_t)g.ndig + (g.te + 1) / 2) * sizeof(int);
}

__global__ void __launch_bounds__(kSortWarps * 32)
sort_kernel(Work wk, int Lq, int NC, int upw, int tiles, int ndig, int te, int units) {
  extern __shared__ int sort_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int id = blockIdx.x * (blockDim.x >> 5) + warp;  // (b·M + m)·tiles + tile
  if (id >= units) return;
  const int seg = id / tiles, t = id % tiles;
  int* cursor = sort_smem + (size_t)warp * (ndig + (te + 1) / 2);
  uint16_t* place = reinterpret_cast<uint16_t*>(cursor + ndig);
  const int* cnt = wk.count + (size_t)id * ndig;
  int* offset = wk.offset + (size_t)id * ndig;
  // each bin's place in the tile: the exclusive prefix of the tile's counts
  for (int d = lane; d < ndig; d += 32) cursor[d] = cnt[d];
  __syncwarp();
  int total = 0;
  for (int d0 = 0; d0 < ndig; d0 += 32) {
    const int d = d0 + lane;
    const int c = d < ndig ? cursor[d] : 0;
    int inc = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += n;
    }
    if (d < ndig) cursor[d] = offset[d] = total + inc - c;
    total += __shfl_sync(kFull, inc, 31);
  }
  __syncwarp();
  const int tu = kUnitWarps * upw;
  const int q0 = t * tu, q1 = min(Lq, q0 + tu);
  const size_t e0 = ((size_t)seg * Lq + q0) * NC;  // the tile's entries, and its region
  const int n = (q1 - q0) * NC;
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < n; r += 32 * kRounds) {
    int bin[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int i = r + 32 * u + lane;
      bin[u] = i < n ? wk.bin[e0 + i] : kNoBin;
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const unsigned peers = __match_any_sync(kFull, bin[u]);
      const bool real = bin[u] != kNoBin;
      const int pos = real ? cursor[bin[u]] + __popc(peers & below) : 0;
      __syncwarp();
      if (real) {
        place[pos] = static_cast<uint16_t>(r + 32 * u + lane);
        if ((peers & below) == 0u) cursor[bin[u]] = pos + __popc(peers);
      }
      __syncwarp();
    }
  }
#pragma unroll 4
  for (int p = lane; p < total; p += 32) {
    const int i = place[p];
    wk.sorted[e0 + p] = make_uint2(wk.pay[e0 + i], __float_as_uint(wk.w[e0 + i]));
  }
}

// ---- 3. plan: each bin's chunks, and the slots of its partial rows --------

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(Work wk, int tiles, int ndig, int extra) {
  __shared__ int2 wsum[kPlanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, seg = blockIdx.x;
  const int* cnt = wk.count + (size_t)seg * tiles * ndig;
  int4* info = wk.binfo + (size_t)seg * ndig;
  int* cbin = wk.chunk_bin + (size_t)seg * extra;
  int2 carry = make_int2(0, 0);  // further chunks and slots of the bins before this round's
  for (int d0 = 0; d0 < ndig; d0 += kPlanThreads) {
    const int d = d0 + threadIdx.x;
    int total = 0;
    if (d < ndig)
#pragma unroll 8
      for (int t = 0; t < tiles; ++t) total += cnt[(size_t)t * ndig + d];
    const int ns = total > kChunk ? (total + kChunk - 1) / kChunk : 0;  // its slots
    const int n = ns > 0 ? ns - 1 : 0;                                     // further chunks
    int2 inc = make_int2(n, ns);  // inclusive scan over the block
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, inc.x, off), y = __shfl_up_sync(kFull, inc.y, off);
      if (lane >= off) {
        inc.x += x;
        inc.y += y;
      }
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int2 w = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(kFull, w.x, off), y = __shfl_up_sync(kFull, w.y, off);
        if (lane >= off) {
          w.x += x;
          w.y += y;
        }
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int2 before = warp ? wsum[warp - 1] : make_int2(0, 0);
    const int first = carry.x + before.x + inc.x - n;
    if (d < ndig) {
      info[d] = make_int4(total, first, carry.y + before.y + inc.y - ns, 0);
      for (int j = 0; j < n; ++j) cbin[first + j] = d;
    }
    carry.x += wsum[31].x;
    carry.y += wsum[31].y;
    __syncthreads();  // wsum is read before the next round writes it
  }
  if (threadIdx.x == 0) wk.nchunks[seg] = carry.x;
}

// ---- 4. dV: each chunk's entries summed in order --------------------------

__device__ __forceinline__ void store4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(asis::pack_bf16(x.x, x.y), asis::pack_bf16(x.z, x.w));
}

template <typename T, int NV>
__global__ void __launch_bounds__(256)
sum_kernel(Work wk, const float* __restrict__ grad, T* __restrict__ dvalue, int S, int M,
           int D, int Lq, int NC, int ndig, int tiles, int te, int extra, int slots) {
  extern __shared__ float4 acc_all[];  // per warp: kBinTokens rows of D fp32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + warp, seg = blockIdx.y;
  // warp d < ndig: bin d's first chunk; after them, the further chunks
  const int further = chunk - ndig;
  if (further >= 0 && further >= wk.nchunks[seg]) return;
  const int bin = further < 0 ? chunk : wk.chunk_bin[(size_t)seg * extra + further];
  int4* info = wk.binfo + (size_t)seg * ndig + bin;
  const int4 bi = *info;  // entries, first further chunk, first slot
  const int parts = bi.x > kChunk ? (bi.x + kChunk - 1) / kChunk : 1;
  const int part = further < 0 ? 0 : further - bi.y + 1;
  const int k_lo = part * kChunk, k_hi = min(bi.x, k_lo + kChunk);  // in walk order
  const int m = seg % M, b = seg / M;
  float* acc = reinterpret_cast<float*>(acc_all) + (size_t)warp * kBinTokens * D;
  for (int i = lane * 4; i < kBinTokens * D; i += 128)
    *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  const size_t o0 = (size_t)seg * Lq * NC;  // this (b, m)'s entries
  const size_t row = (size_t)M * D;
  const float* gseg = grad + (size_t)b * Lq * row + (size_t)m * D;
  int base = 0;  // entries of the bin in the tiles before t0
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    // lane j: the run of this bin in tile t0 + j, and its place in the walk
    const int tj = t0 + lane;
    const size_t meta = ((size_t)seg * tiles + tj) * ndig + bin;
    const int cnt = tj < tiles ? wk.count[meta] : 0;
    const size_t at = o0 + (size_t)tj * te + (tj < tiles ? wk.offset[meta] : 0);
    int pre = cnt;  // inclusive scan over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(kFull, pre, off);
      if (lane >= off) pre += n;
    }
    const int total = __shfl_sync(kFull, pre, 31);
    pre -= cnt;  // exclusive
    const int lo = max(k_lo - base, 0), hi = min(k_hi - base, total);
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const int cnt_c = min(32, hi - c0);
      // the tile of entry c0 + lane: the last lane j with pre_j <= c0 + lane
      const int k = c0 + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step >= 1; step >>= 1) {
        const int p = __shfl_sync(kFull, pre, j + step);
        if (p <= k) j += step;
      }
      const int pre_j = __shfl_sync(kFull, pre, j);
      const unsigned long long at_j = __shfl_sync(kFull, (unsigned long long)at, j);
      const uint2 mine = lane < cnt_c ? wk.sorted[at_j + (k - pre_j)] : make_uint2(0u, 0u);
      const uint32_t my_pay = mine.x;
      const float my_w = __uint_as_float(mine.y);
      for (int k0 = 0; k0 < cnt_c; k0 += kSumBatch) {
        float4 gv[kSumBatch][NV];
        float wv[kSumBatch];
        int tl[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) {
          const int kk = k0 + u;
          const uint32_t p = __shfl_sync(kFull, my_pay, kk & 31);
          wv[u] = __shfl_sync(kFull, my_w, kk & 31);
          tl[u] = static_cast<int>(p & 7u);
          const float* gr = gseg + (size_t)(p >> 3) * row;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int ch = (lane + 32 * i) * 4;
            gv[u][i] = (kk < cnt_c && ch < D) ? __ldg(reinterpret_cast<const float4*>(gr + ch))
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) {
          if (k0 + u < cnt_c) {
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              const int ch = (lane + 32 * i) * 4;
              if (ch < D) {
                float4* a = reinterpret_cast<float4*>(acc + tl[u] * D + ch);
                float4 x = *a;
                x.x = fmaf(wv[u], gv[u][i].x, x.x);
                x.y = fmaf(wv[u], gv[u][i].y, x.y);
                x.z = fmaf(wv[u], gv[u][i].z, x.z);
                x.w = fmaf(wv[u], gv[u][i].w, x.w);
                *a = x;
              }
            }
          }
        }
      }
    }
    base += total;
    if (base >= k_hi) break;
  }
  __syncwarp();
  if (parts > 1) {
    // publish this part; the last part to arrive adds them all, in part order
    float* slot0 = wk.partial + ((size_t)seg * slots + bi.z) * kBinTokens * D;
    float* mine = slot0 + (size_t)part * kBinTokens * D;
    for (int i = lane * 4; i < kBinTokens * D; i += 128)
      *reinterpret_cast<float4*>(mine + i) = *reinterpret_cast<const float4*>(acc + i);
    __threadfence();
    __syncwarp();
    int arrived = 0;
    if (lane == 0) arrived = atomicAdd(&info->w, 1);
    if (__shfl_sync(kFull, arrived, 0) != parts - 1) return;
    __threadfence();
    for (int i = lane * 4; i < kBinTokens * D; i += 128) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < parts; ++q) {
        const float4 y = __ldcg(reinterpret_cast<const float4*>(
            slot0 + (size_t)q * kBinTokens * D + i));
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      *reinterpret_cast<float4*>(acc + i) = x;
    }
    __syncwarp();
  }
  for (int tl = 0; tl < kBinTokens; ++tl) {
    const int s = bin * kBinTokens + tl;
    if (s >= S) break;
    T* dst = dvalue + ((size_t)b * S + s) * row + (size_t)m * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int ch = (lane + 32 * i) * 4;
      if (ch < D) store4(dst + ch, *reinterpret_cast<const float4*>(acc + tl * D + ch));
    }
  }
}

// ---- host -------------------------------------------------------------------

int clamp_warps(int bytes_per_warp) {
  const int w = kSmemCap / bytes_per_warp;
  return w < 1 ? 1 : (w > 8 ? 8 : w);
}

template <typename T, int G, int NV>
int run(const void* value, const float* loc, const float* aw, const float* grad,
        void* dvalue, float* dloc, float* daw, const Work& wk, const Geometry& g, int S,
        int M, int D, int Lq, int L, int P, const Levels& lv, cudaStream_t s) {
  const dim3 tiles(g.tiles, g.segs);
  if (units_per_round(g.nc) == 2)
    point_kernel<T, G, NV, 2><<<tiles, kUnitWarps * 32, g.ndig * sizeof(int), s>>>(
        static_cast<const T*>(value), loc, aw, grad, dloc, daw, wk, S, M, D, Lq, L, P, g.ndig,
        g.upw, g.tiles, lv);
  else
    point_kernel<T, G, NV, 1><<<tiles, kUnitWarps * 32, g.ndig * sizeof(int), s>>>(
        static_cast<const T*>(value), loc, aw, grad, dloc, daw, wk, S, M, D, Lq, L, P, g.ndig,
        g.upw, g.tiles, lv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = g.segs * g.tiles;
  const size_t per_warp = sort_warp_bytes(g);
  const int wpb = per_warp * kSortWarps <= kSmemCap ? kSortWarps
                  : per_warp * 2 <= kSmemCap ? 2 : 1;
  sort_kernel<<<(units + wpb - 1) / wpb, wpb * 32, wpb * per_warp, s>>>(
      wk, Lq, g.nc, g.upw, g.tiles, g.ndig, g.te, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_kernel<<<g.segs, kPlanThreads, 0, s>>>(wk, g.tiles, g.ndig, g.extra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wps = clamp_warps(kBinTokens * D * sizeof(float));
  const dim3 grid((g.ndig + g.extra + wps - 1) / wps, g.segs);
  const size_t smem = (size_t)wps * kBinTokens * D * sizeof(float);
  if (D <= 128)
    sum_kernel<T, 1><<<grid, wps * 32, smem, s>>>(wk, grad, static_cast<T*>(dvalue), S, M, D,
                                                  Lq, g.nc, g.ndig, g.tiles, g.te, g.extra,
                                                  g.slots);
  else
    sum_kernel<T, 2><<<grid, wps * 32, smem, s>>>(wk, grad, static_cast<T*>(dvalue), S, M, D,
                                                  Lq, g.nc, g.ndig, g.tiles, g.te, g.extra,
                                                  g.slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* value, const float* loc, const float* aw, const float* grad,
             void* dvalue, float* dloc, float* daw, const Work& wk, const Geometry& g, int S,
             int M, int D, int Lq, int L, int P, const Levels& lv, cudaStream_t s) {
  constexpr int VEC = Row<T>::kVec;
  if (D % VEC) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = D / VEC;
  switch (group_lanes(nvec)) {
    case 4:
      return run<T, 4, 1>(value, loc, aw, grad, dvalue, dloc, daw, wk, g, S, M, D, Lq, L, P,
                          lv, s);
    case 8:
      return run<T, 8, 1>(value, loc, aw, grad, dvalue, dloc, daw, wk, g, S, M, D, Lq, L, P,
                          lv, s);
    case 16:
      return run<T, 16, 1>(value, loc, aw, grad, dvalue, dloc, daw, wk, g, S, M, D, Lq, L, P,
                           lv, s);
    case 32:
      if (nvec <= 32)
        return run<T, 32, 1>(value, loc, aw, grad, dvalue, dloc, daw, wk, g, S, M, D, Lq, L,
                             P, lv, s);
      if constexpr (VEC == 4)
        return run<T, 32, 2>(value, loc, aw, grad, dvalue, dloc, daw, wk, g, S, M, D, Lq, L,
                             P, lv, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the kernels take (the wrapper raises first, with a message).
bool supported(int B, int S, int M, int D, int Lq, int L, int P) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 256 || D % 4 || B < 1 || M < 1 || Lq < 1 ||
      P < 1 || S < 1)
    return false;
  const Geometry g = geometry(B, S, M, Lq, L, P);
  return g.segs <= 65535 && g.ndig < kNoBin && (size_t)g.ndig * sizeof(int) <= kSmemCap &&
         sort_warp_bytes(g) <= kSmemCap && g.te <= 65535 && Lq < (1 << 28) &&
         (size_t)Lq * g.nc < (1u << 31);
}

}  // namespace

extern "C" {

// Bytes of workspace `asis_msda_bwd` needs for these shapes (0: unsupported).
size_t asis_msda_bwd_workspace(int B, int S, int M, int D, int Lq, int L, int P) {
  if (!supported(B, S, M, D, Lq, L, P)) return 0;
  return layout(geometry(B, S, M, Lq, L, P), D, nullptr, nullptr);
}

// value (B, S, M, D) bf16 (is_bf16) or fp32, 16-byte aligned, D·element size
// a multiple of 16 bytes, D ≤ 256, S up to ≈ 90000 (a sort warp's bins and
// tile fit its shared memory); loc (B, Lq, M, L, P, 2) fp32, 8-byte aligned;
// aw (B, Lq, M, L, P) fp32; grad (B, Lq, M·D) fp32, 16-byte aligned; dvalue
// like value, dloc like loc, daw like aw: all fully written; workspace of
// `ws_bytes` ≥ asis_msda_bwd_workspace(...) bytes, 256-byte aligned. All
// contiguous. shapes: host array of L (H, W) pairs; starts: host array of L
// level offsets into S. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
int asis_msda_bwd(const void* value, const void* loc, const void* aw, const void* grad,
                  void* dvalue, void* dloc, void* daw, void* workspace, size_t ws_bytes, int B,
                  int S, int M, int D, int Lq, int L, int P, const int* shapes,
                  const int* starts, int is_bf16, void* stream) {
  if (!supported(B, S, M, D, Lq, L, P) || reinterpret_cast<uintptr_t>(value) % 16 ||
      reinterpret_cast<uintptr_t>(loc) % 8 || reinterpret_cast<uintptr_t>(grad) % 16 ||
      reinterpret_cast<uintptr_t>(workspace) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(B, S, M, Lq, L, P);
  if (ws_bytes < layout(g, D, nullptr, nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Work wk;
  layout(g, D, static_cast<char*>(workspace), &wk);
  Levels lv{};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = starts[l];
  }
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(aw);
  const float* gp = static_cast<const float*>(grad);
  float* dlp = static_cast<float*>(dloc);
  float* dap = static_cast<float*>(daw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(value, lp, ap, gp, dvalue, dlp, dap, wk, g, S, M, D,
                                           Lq, L, P, lv, s)
                 : dispatch<float>(value, lp, ap, gp, dvalue, dlp, dap, wk, g, S, M, D, Lq, L,
                                   P, lv, s);
}

}  // extern "C"
