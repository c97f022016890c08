// bf16 pair packing shared by the kernels of this directory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace asis {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace asis
