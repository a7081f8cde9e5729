// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_ring.cu) share beside hopper.cuh: the bf16 type, log2(e) for the
// exp2 softmax, and the packing of two f32 values into a bf16 pair -- the
// step that turns a wgmma accumulator (P, dS) into the register A fragment
// of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tfs_flash {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tfs_flash
