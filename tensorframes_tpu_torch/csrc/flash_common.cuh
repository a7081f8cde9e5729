// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// asynchronous global->shared copies, ldmatrix, the m16n8k16 bf16 tensor-core
// product, and the strided row loader.
//
// mma.sync m16n8k16 fragment layout (lane = 4*g + t4): an accumulator
// c[0..3] holds rows g (c[0], c[1]) and g+8 (c[2], c[3]) at columns
// 2*t4 and 2*t4+1 of its 16x8 tile.  Two neighbouring accumulator tiles,
// packed to bf16, are exactly the A fragment of the next product, so a
// result can feed another product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tfs_flash {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past the end of the sequence)
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8]
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + nrows) of one head -> shared tile with rows of D + 8
// elements, asynchronously; rows at or past L are zero-filled
template <int D, int NTHREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* base,
                                                int64_t s_l, int row0,
                                                int nrows, int L, int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < nrows * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = row0 + r;
    const bool ok = row < L;
    cp_async16(smem_addr(dst + r * (D + 8) + c),
               base + (ok ? row * s_l + c : 0), ok);
  }
}

// A fragment (16 rows x 16 columns) of a row-major shared tile with row
// stride ld, rows [r0, r0 + 16), columns [c0, c0 + 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0, int lane) {
  ldmatrix_x4(a, smem_addr(tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8));
}

// B fragments for two 8-column tiles of X^T, where the tile holds X
// row-major ([n][k]): rows [n0, n0 + 16) of X are the 16 output columns,
// its columns [k0, k0 + 16) the reduction.  b[0..1] feed columns n0..n0+7,
// b[2..3] columns n0+8..n0+15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int n0, int k0, int lane) {
  ldmatrix_x4(b, smem_addr(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld +
                           k0 + ((lane >> 3) & 1) * 8));
}

// B fragments for two 8-column tiles of X itself, the tile holding X
// row-major ([k][n]): rows [k0, k0 + 16) are the reduction, columns
// [n0, n0 + 16) the output.  b[0..1] feed n0..n0+7, b[2..3] n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, smem_addr(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                 n0 + (lane >> 4) * 8));
}

}  // namespace tfs_flash
