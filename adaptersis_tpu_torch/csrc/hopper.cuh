// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads through a
// tensor map, wgmma products with shared-memory descriptors (bf16, and tf32
// with the split of an fp32 operand into two tf32 values), register fences
// and setmaxnreg; on the host, the tensor-map encoders and the per-card
// launch cache. Written against the PTX ISA directly, so the
// kernels need no CUTLASS.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace asis {
namespace hopper {

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to the
// other threads (after a __syncthreads()).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts 2²⁸ polls (seconds; a real one takes microseconds) can only
// be a lost arrival: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 28)) __trap();
}

// ---- TMA ---------------------------------------------------------------

// The box of `map` at element coordinates (c0, c1, c2), innermost first,
// into shared memory at `dst`; completes `bar`'s transactions. Rows of the
// box outside the tensor are filled with zeros and still count as bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box of a two-dimensional `map` at element coordinates (c0, c1),
// innermost first; as tma_load_3d.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The `box` elements of a one-dimensional `map` from element c0 into shared
// memory at `dst` (16-byte aligned); elements past the end read as zeros.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------

// Descriptor of a bf16 operand tile in shared memory written by TMA with
// 128-byte swizzling: rows of 64 elements (128 bytes), 8-row atoms of
// 1024 bytes, the tile 1024-byte aligned. Both strides are 1024 bytes:
// for a K-major operand (rows along M or N) the leading offset is unused
// and the stride offset steps 8 rows; for an MN-major one (rows along K)
// the stride offset steps 8 rows of K and the leading offset, which would
// step 64 elements of MN, is unused at a width of 64. A k-step of 16
// elements along a K-major row advances the start address by 32 bytes
// (+2 in the descriptor); along MN-major rows by 16 rows, 2048 bytes (+128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (kStride << 16) | (kStride << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the (volatile) commit and wait around them.
template <int n>
__device__ __forceinline__ void fence_regs(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64×256, fp32) = or += a (64×16, K-major, shared) · b (256×16, K-major,
// shared)ᵀ; d's layout is wgmma_m64n128k16_ss's with 32 column groups.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64×128, fp32) = or += a (64×16, K-major, shared) · b (128×16, K-major,
// shared)ᵀ. Thread t of the warpgroup holds rows 16·(t/32) + (t%32)/4 (+8)
// at columns 8j + 2·(t%4) (+1): d[4j], d[4j+1] on the first row, d[4j+2],
// d[4j+3] on the second.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64×64, fp32) = or += a (64×16, K-major, shared) · b (64×16, K-major,
// shared)ᵀ; d's layout is wgmma_m64n128k16_ss's with 8 column groups.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64×64, fp32) += a (64×16, registers: the mma.sync A fragment of each
// warp's 16 rows) · b (16×64, MN-major in shared memory: 16 rows of 64
// elements, the transpose bit set). d's layout is wgmma_m64n128k16_ss's.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- tf32 wgmma: the fp32 paths' 3×TF32 products -------------------------
//
// A tf32 wgmma reads the top 19 bits of each fp32 operand (sign, exponent,
// 10 mantissa bits) and ignores the low 13, so a raw fp32 operand would be
// truncated to 11 significant bits: a product error of ≈ 2⁻¹¹. The fp32
// paths split every operand x = hi + lo explicitly (`tf32_split`: hi =
// cvt.rna(x), lo = cvt.rna(x − hi), each a tf32 value) and accumulate
// lo·hi + hi·lo + hi·hi in fp32 (3×TF32): what is dropped, lo·lo and lo's own
// rounding, is ≈ 2⁻²² of each product. The accumulation itself truncates
// (rounds toward zero) at every step on the tensor cores, so the kernels
// keep each chain of wgmmas short and sum the chains in fp32 registers
// with round-to-nearest adds. For
// 32-bit operands wgmma has no transpose bits: B must be K-major in shared
// memory (rows along N, K contiguous); a k8 step is 32 bytes of such a row,
// the same descriptor arithmetic as bf16's k16 (`sw128_desc` + 2 per step).
// A comes from registers: the mma.sync tf32 A fragment of each warp's 16
// rows, a[0] = (r, c), a[1] = (r + 8, c), a[2] = (r, c + 4), a[3] = (r + 8,
// c + 4) with r = lane / 4, c = lane % 4.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ≈ 2⁻²² of |x|; both as tf32 bit patterns.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads), before the barrier that hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64×128, fp32) = or += a (64×8 tf32, registers) · b (128×8 tf32, K-major,
// shared)ᵀ; d's layout is wgmma_m64n128k16_ss's.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64×32, fp32) = or += a (64×8 tf32, K-major, shared) · b (32×8 tf32,
// K-major, shared)ᵀ; d's layout is wgmma_m64n128k16_ss's with 4 column
// groups. A K-major tf32 A operand takes the same descriptor as B.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64×64, fp32) = or += a (64×8 tf32, registers) · b (64×8 tf32, K-major,
// shared)ᵀ; d's layout is wgmma_m64n128k16_ss's with 8 column groups.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// An fp32 accumulator's 8-column groups as tf32 A fragments over its
// columns, split x = hi + lo in place: hi's bit patterns replace c, lo goes
// to lo[j]; `hi_frag` reads group j's hi fragment back. Group j's columns
// 8j + 2t, 8j + 2t + 1 (t = lane % 4) are taken as the fragment's k = t and
// t + 4. The B operand that meets them holds its K rows in the same order:
// row p of each 8-row step at K column p/2 + 4·(p mod 2) (`kperm`). The sum
// over a step's K is the same.
template <int n>
__device__ __forceinline__ void split_frags(float (&c)[n], uint32_t (&lo)[n / 4][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    uint32_t hi;
    tf32_split(c[i], hi, lo[i >> 2][(i & 1) * 2 + ((i >> 1) & 1)]);
    c[i] = __uint_as_float(hi);
  }
}

template <int n>
__device__ __forceinline__ void hi_frag(const float (&c)[n], int j, uint32_t (&a)[4]) {
  a[0] = __float_as_uint(c[4 * j]);
  a[1] = __float_as_uint(c[4 * j + 2]);
  a[2] = __float_as_uint(c[4 * j + 1]);
  a[3] = __float_as_uint(c[4 * j + 3]);
}

__host__ __device__ constexpr int kperm(int p) { return (p & ~7) + ((p & 7) >> 1) + 4 * (p & 1); }

// Byte offset of element (row, col) in a tile of 128-byte rows (32 fp32)
// swizzled as TMA's 128-byte mode lays them out: 16-byte chunk col / 4 of
// row `row` at chunk (col / 4) ^ (row % 8).
__host__ __device__ constexpr int sw128_at(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7))) << 4) + 4 * (col & 3);
}

// Raw K/V stage → split stage for the fp32 attention forward (K7's
// fa_fwd_tf32_kernel, which K3's fp32 path launches too), by `threads` threads (x
// = 0 .. threads − 1). The raw stage holds a tile of 64 keys × 64 as TMA
// wrote it: K's two 32-column halves (8 KB each, 128-byte swizzled), then
// V's. The split stage gets K_hi and K_lo in K's own layout (K-major for S
// = Q·Kᵀ: an elementwise split of 16-byte chunks), then Vᵀ_hi, Vᵀ_lo (64
// rows of Dh, keys contiguous, in two key halves of 32: K-major for O +=
// P·V; 32-bit wgmma operands cannot be transposed by the hardware), keys
// in `kperm` order. A warp takes 32 consecutive keys of one d-chunk: its V
// reads hit 8 distinct swizzled chunks per 8 lanes, its Vᵀ writes 32
// distinct banks of one row.
template <int threads>
__device__ __forceinline__ void split_kv_stage(const uint8_t* raw, uint8_t* split, int x) {
  constexpr int kHalf = 64 * 128;
  for (int i = x; i < 1024; i += threads) {
    const float4 a = *reinterpret_cast<const float4*>(raw + 16 * i);
    uint32_t h[4], l[4];
    tf32_split(a.x, h[0], l[0]);
    tf32_split(a.y, h[1], l[1]);
    tf32_split(a.z, h[2], l[2]);
    tf32_split(a.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(split + 16 * i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(split + 2 * kHalf + 16 * i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  const uint8_t* vraw = raw + 2 * kHalf;
  uint8_t* vt_hi = split + 4 * kHalf;
  uint8_t* vt_lo = split + 6 * kHalf;
  for (int i = x; i < 1024; i += threads) {
    const int key = i & 63, c = i >> 6;  // d = 4c .. 4c + 3, in half c / 8
    const float4 a = *reinterpret_cast<const float4*>(
        vraw + (c >> 3) * kHalf + key * 128 + (((c & 7) ^ (key & 7)) << 4));
    const int kb = key >> 5, col = kperm(key & 31);
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = kb * kHalf + sw128_at(4 * c + e, col);
      uint32_t hi, lo;
      tf32_split(v[e], hi, lo);
      *reinterpret_cast<uint32_t*>(vt_hi + at) = hi;
      *reinterpret_cast<uint32_t*>(vt_lo + at) = lo;
    }
  }
}

// ---- named barriers ----------------------------------------------------

// Barrier `id` (1..15; 0 is __syncthreads) completes when `threads` threads
// have reached it, by sync (waiting) or arrive (not waiting).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register budgets (warp specialisation) -----------------------------

template <int n>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(n));
}

template <int n>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(n));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: tensor maps and the launch cache ------------------------------

// cuTensorMapEncodeTiled from the driver, reached through the runtime, so
// the library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (B·H, N, 64) bf16 tensor as boxes of `rows` × 64, swizzled in 128-byte
// atoms (a 64-wide row is one atom); rows past a head's N read as zeros.
inline bool head_map(CUtensorMap* map, const void* ptr, int BH, int N, int rows) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {64 * 2, static_cast<cuuint64_t>(N) * 64 * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) bf16 matrix, cols a multiple of 64, as boxes of
// `box_rows` rows × 64 columns, swizzled in 128-byte atoms (a box row is
// one atom); rows past the end read as zeros.
inline bool mat_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) float32 matrix, cols a multiple of 32, as boxes
// of `box_rows` rows × 32 columns (128 bytes, one swizzle atom) at column
// offsets that are multiples of 32; rows past the end read as zeros.
inline bool mat_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (B·H, N, 64) float32 tensor as boxes of `rows` × 32 (one half of the
// head width, 128 bytes, swizzled in 128-byte atoms); rows past a head's N
// read as zeros.
inline bool head_map_f32(CUtensorMap* map, const void* ptr, int BH, int N, int rows) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {64 * 4, static_cast<cuuint64_t>(N) * 64 * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n float32 values as one-dimensional boxes of `box` (the row statistics,
// B·H·N long: a box that runs past a head's N reads the next head's values,
// which the kernels mask; past the end zeros). A box's start must be a
// multiple of 4 values (16 bytes): others fault.
inline bool vec_map(CUtensorMap* map, const float* ptr, size_t n, int box) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // rank − 1 = 0 of them are read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides,
                boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per card and kernel: the dynamic shared-memory limit raised to
// `smem` bytes, and the card's SM count.
struct LaunchCache {
  bool set[64] = {};
  int sms[64] = {};
};

template <typename Kernel>
inline cudaError_t prepare(LaunchCache& cache, Kernel kernel, int smem, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cache.set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&cache.sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache.set[dev] = true;
  }
  *sms = cache.sms[dev];
  return cudaSuccess;
}

}  // namespace hopper
}  // namespace asis
