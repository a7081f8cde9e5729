// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_ring.cu) share beside hopper.cuh: the 16-bit element types, log2(e)
// for the exp2 softmax, the packing of two f32 values into a pair of
// the element type -- the step that turns a wgmma accumulator (P, dS) into
// the register A fragment of the next product, and an f32 result into its
// stored output -- the element conversions of the ring step's FMA kernel,
// which holds every tile in f32 whatever the element type (in f32, and in
// bf16 and f16 from 256 on, above its tensor-core builds), the cp.async
// copies of the f32 SIMT kernels (flash_fwd_simt, flash_bwd_dq_simt,
// flash_bwd_dkv_simt), and the rule that splits a head dim above 512 into
// chunks of 512 (SPLIT, chunk_width), which every kernel follows.
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

// -- element conversions (the ring step's FMA kernel) -----------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

// an f32 value rounded to the element type (round to nearest even)
template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and read back: the cast the TPU kernels make before a
// product (p.astype(v.dtype), dS to q's dtype); the identity for f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// four consecutive elements as f32: one 16-byte load of f32, two 4-byte
// pair loads of a 16-bit type (the wrappers keep rows 16-byte aligned)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <>
__device__ __forceinline__ float4 load4<f16>(const f16* p) {
  const __half2* p2 = reinterpret_cast<const __half2*>(p);
  const float2 a = __half22float2(p2[0]);
  const float2 b = __half22float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The ring step's FMA tiling at head dim D: a lane pair per query row
// (half the keys each for the scores, half of D each for P V), Q, K and V
// tiles in shared memory as f32 with rows of D + 8, the
// scores (then P) and the output accumulator beside them.  The tiles shrink
// with D to fit the 227 KB a block may hold: 64 queries x 64 keys up to
// D = 128, 64 x 32 at D = 256 (206 KB), 32 x 16 at D = 512 (202 KB, also
// each 512-column chunk of a wider head dim); above D = 128 the P V loop
// runs 32 output columns a pass, so that its accumulators stay in
// registers.
template <int D>
struct FmaTiles {
  static constexpr int BQ = D > 256 ? 32 : 64;
  static constexpr int BK = D > 256 ? 16 : D > 128 ? 32 : 64;
  static constexpr int THREADS = 2 * BQ;  // 16 query rows a warp
  static constexpr int T_LD = D + 8, S_LD = BK + 4, O_LD = D + 4;
  static constexpr int HALF = D / 2, HK = BK / 2;
  static constexpr int PV = D > 128 ? 32 : HALF;
  static constexpr size_t SMEM =
      (size_t(BQ + 2 * BK) * T_LD + size_t(BQ) * S_LD + size_t(BQ) * O_LD) *
      sizeof(float);
  static_assert(SMEM <= 232448, "FMA tiles exceed a block's shared memory");
};

// -- cp.async (the f32 SIMT kernels of the forward and the backward) --------

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The widest build.  A head dim above it, padded by the wrapper to a
// multiple of it, runs that build split into chunks of SPLIT columns, one
// grid axis over them (parallel/flash.py::head_dim_chunks, the same rule).
constexpr int SPLIT = 512;

// The head dim a launch runs at: D itself, or SPLIT with *nc = D / SPLIT
// chunks when D is a larger multiple of it (*nc = 1 otherwise); 0 when the
// chunks would not fit a grid axis
inline int chunk_width(int D, int* nc) {
  *nc = D > SPLIT && D % SPLIT == 0 ? D / SPLIT : 1;
  return *nc > 65535 ? 0 : *nc > 1 ? SPLIT : D;
}

// rows [row0, row0 + rows) of a [L, D] slice with row stride s_l, as f32
// into rows of D + 8 (zeros past L)
template <typename T, int D>
__device__ __forceinline__ void load_tile_fma(float* dst, const T* base,
                                              int64_t s_l, int row0, int rows,
                                              int L, int tid, int threads) {
  constexpr int VPR = D / 4;
  for (int i = tid; i < rows * VPR; i += threads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L) val = load4<T>(base + row * s_l + c);
    *reinterpret_cast<float4*>(dst + r * (D + 8) + c) = val;
  }
}

}  // namespace tfs_flash
