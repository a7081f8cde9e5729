// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_ring.cu) share beside hopper.cuh: the 16-bit element types, log2(e)
// for the exp2 softmax, the packing of two f32 values into a pair of
// the element type -- the step that turns a wgmma accumulator (P, dS) into
// the register A fragment of the next product, and an f32 result into its
// stored output -- the cp.async copies of the f32 SIMT kernels
// (flash_fwd_simt, flash_bwd_dq_simt, flash_bwd_dkv_simt, ring_step_simt),
// the register tiling that the forward's and the ring step's SIMT kernels
// share (Simt), and the rule that splits a head dim above 512 into chunks
// of 512 (SPLIT, chunk_width), which every kernel follows.
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

// -- cp.async (the f32 SIMT kernels: the forward, the backward, the ring) --

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

// The f32 SIMT tiling of the forward (flash_fwd.cu::flash_fwd_simt) and the
// ring step (flash_ring.cu::ring_step_simt) at head dim D (each chunk of a
// wider one), 256 threads:
//  * S = Q K^T, BQ x BK: a thread forms a 4 x 4 micro-tile, rows rg + i NRG
//    and keys kg + j NKG, from float4 loads along Dh; G lanes (neighbours)
//    split the reduction over Dh by 16-byte chunk (chunk gs + G n), and a
//    butterfly of shuffles sums their partials.  A warp holds NR_LO row
//    groups x NK_LO key groups x G splits, so its loads touch few rows.
//  * The softmax: RT lanes (neighbours) a row, each BK / RT of its keys.
//  * O += P V, BQ x D: a thread holds 4 consecutive rows x CH float4 chunks
//    of columns (chunk cg + NCG m), a warp 4 row groups x 8 column groups:
//    one float4 of P^T and CH of V feed 16 CH FMAs.
//  * Shared memory, rows padded (floats): Q, K and V rows of LD = D + 4 G,
//    so that LD / 4 = G (mod 8) and the chunks a warp loads fall in
//    distinct banks; the scores S (rows of BK + RT), P^T (rows of BQ + 32 /
//    RT) and per-row alpha and l.  BQ x BK is 64 x 64 at D = 64, 64 x 32
//    at 128 (89 KB each), 32 x 32 at 256 (115 KB) and 512 (213 KB).
//  * Two CTAs an SM up to D = 256: ptxas is held to 128 registers a thread
//    and the S loop stays rolled, so that its loads fit them (measured
//    1.09-1.16x faster than one CTA at 154-190 registers,
//    tools/fwd_simt_variant.py); one at 512, where shared memory allows no
//    second and the unrolled loop is faster.
template <int D>
struct Simt {
  static constexpr int THREADS = 256;
  static constexpr int BQ = D >= 256 ? 32 : 64;
  static constexpr int BK = D >= 128 ? 32 : 64;
  static constexpr int NRG = BQ / 4, NKG = BK / 4;
  static constexpr int G = THREADS / (NRG * NKG);
  static constexpr int NK_LO = G == 1 ? 8 : 4;
  static constexpr int NR_LO = 32 / (G * NK_LO);
  static constexpr int NK_HI = NKG / NK_LO;
  static constexpr int RT = THREADS / BQ;
  static constexpr int NCG = THREADS / NRG;
  static constexpr int CH = D / 4 / NCG;
  static constexpr int NC_HI = NCG / 8;
  static constexpr int LD = D + 4 * G;
  static constexpr int LDS = BK + RT;
  static constexpr int LDP = BQ + 32 / RT;
  static constexpr size_t SMEM = (size_t(BQ + 2 * BK) * LD + size_t(BQ) * LDS +
                                  size_t(BK) * LDP + 2 * size_t(BQ)) * sizeof(float);
  static_assert(NRG * NKG * G == THREADS && NR_LO * NK_LO * G == 32, "S's lanes");
  static_assert(NKG % NK_LO == 0 && (NRG / NR_LO) * NK_HI == THREADS / 32, "S's warps");
  static_assert(CH * NCG * 4 == D && (NRG / 4) * NC_HI == THREADS / 32, "O's lanes");
  static_assert((D / 4) % G == 0 && (LD / 4 - G) % 8 == 0 && LDP % 4 == 0, "strides");
  static_assert(SMEM <= 232448, "f32 SIMT tiles exceed a block's shared memory");
};

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

}  // namespace tfs_flash
