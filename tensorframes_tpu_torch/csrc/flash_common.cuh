// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_ring.cu) share beside hopper.cuh: the 16-bit element types, log2(e)
// for the exp2 softmax, and the packing of two f32 values into a pair of
// the element type -- the step that turns a wgmma accumulator (P, dS) into
// the register A fragment of the next product, and an f32 result into its
// stored output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tfs_flash {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr float LOG2E = 1.4426950408889634f;

// two f32 values rounded to T (bf16 or f16), the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tfs_flash
