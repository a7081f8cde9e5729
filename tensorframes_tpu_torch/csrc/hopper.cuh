// Hopper (sm_90a) building blocks of the four 16-bit flash-attention kernels:
// the forward (flash_fwd.cu::flash_fwd_tma), the ring step
// (flash_ring.cu::ring_step_tma), dQ and dK/dV (flash_bwd.cu::
// flash_bwd_dq_tma, ::flash_bwd_dkv_tma), each instantiated for bf16 and
// f16: TMA descriptors and loads, mbarriers, the wgmma shared-memory matrix
// descriptor and the m64nNk16 bf16/f16 products, and setmaxnreg.  Raw PTX
// in inline asm; no CUTLASS/CuTe.
//
// What it is for: the TPU kernels these replace
// (tensorframes_tpu/parallel/flash.py::_flash_kernel, ::_ring_step_kernel,
// ::_flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel) are bound by
// operations (the ring's diagonal hop by its carry's bytes), and on an H100
// the full tensor-core rate is reached only by wgmma, fed from shared
// memory that TMA fills without spending threads on the copy.  The layout
// they all agree on (bf16 and f16 are both 2 bytes, so one layout serves
// both; only the TMA data type, the wgmma mnemonic and the rounding of P
// and dS differ):
//
//  * A tile of a [B, L, heads, Dh] 16-bit tensor is `rows` consecutive
//    sequence positions of one (batch, head), loaded as boxes of 64 columns
//    (128 bytes: one 128B swizzle atom wide) x rows.  In shared memory a box
//    is rows x 128 bytes, 8-row groups of 1024 bytes, the 16-byte chunks of
//    row r XOR-swizzled by r % 8 (CU_TENSOR_MAP_SWIZZLE_128B).  A Dh of 128
//    is two boxes, the second `rows * 128` bytes after the first, and a Dh
//    of 256 four.  Every box starts 1024-byte aligned, so the descriptor's
//    base offset is 0.  Other head dims are zero-padded to 64, 128 or 256 by
//    the wrapper (parallel/flash.py), so every box is full width.
//  * K-major operand (the reduction runs along the 128-byte row: Q and K in
//    Q K^T, K and Q in K Q^T): descriptor SBO = 1024 (next 8 rows), LBO
//    unused; the k-th 16-wide slice of the reduction starts 32 * (k % 4)
//    bytes into box k / 4.
//  * MN-major operand (the reduction runs down the rows: V in P V, K in
//    dS K, dO and Q in P^T dO and dS^T Q), read through the transpose bit:
//    SBO = 1024 (the next 8 rows of the reduction), LBO = the bytes between
//    the 64-column boxes of the output width; the k-th 16-row slice starts
//    2048 * k bytes in.  An output 256 columns wide is two m64n128
//    products, the second's descriptor two boxes on.
//  * A wgmma accumulator m64nN (f32) gives thread lane = 4 g + t4 of warp w
//    in its warpgroup rows 16 w + g (d[4j], d[4j+1]) and 16 w + g + 8
//    (d[4j+2], d[4j+3]) at columns 8 j + 2 t4 (+1): mma.sync's m16n8 layout,
//    one 8-column block j after another.  Packed to pairs of the element
//    type, chunks 2k and 2k+1 are exactly the register A fragment of the
//    k-th 16-wide slice of the next product (wgmma_rs), so P and dS never
//    touch shared memory.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types (header only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tfs_hopper {

// the kernels' element types: __nv_bfloat16 or __half
template <typename T>
constexpr bool is_f16 = std::is_same_v<T, __half>;
static_assert(sizeof(__half) == 2 && sizeof(__nv_bfloat16) == 2);

// ---------------------------------------------------------------------------
// host: TMA descriptors
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: it is fetched through the
// runtime, so the library needs no link against libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA descriptor of one [B, L, heads, D] tensor of T (bf16 or f16) with
// element strides (batch, length, head) and a contiguous head dim: 4 dims (D, heads,
// L, B), a box of 64 columns x 1 head x `rows` positions x 1 batch, 128B
// swizzle, zero fill past the ends (so a ragged tile never reads the next
// batch's rows).  TMA needs a 16-byte aligned base and byte strides that are
// multiples of 16 below 2^40; the wrapper checks them first, and an encode
// that refuses returns cudaErrorInvalidValue.
template <typename T>
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int B,
                                 int L, int heads, int D, int64_t s_b,
                                 int64_t s_l, int64_t s_h, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(L > 0 ? L : 1), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 2, cuuint64_t(s_l) * 2,
                                 cuuint64_t(s_b) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

constexpr int ATOM_BYTES = 1024;  // 8 rows x 128 bytes: one swizzle atom
constexpr int BOX_COLS = 64;      // 16-bit columns per box (128 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to the swizzle atom (the kernels
// request ATOM_BYTES more than they use)
__device__ __forceinline__ unsigned char* atom_aligned(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ATOM_BYTES - (a & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` to complete: the k-th completion of
// a barrier (k = 1, 2, ...) has parity (k - 1) & 1.  A phase that never
// completes is a bug (a lost arrival, a wrong parity): after ~2^35 cycles
// (about 20 s) the kernel traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box of `map` at coordinates (column, head, row, batch) into shared
// memory; its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// 2^x on the special-function unit, one instruction: results below 2^-126
// flush to 0 (exp2f keeps them, at three more instructions per call, and no
// p that small moves a 16-bit output or an f32 sum)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a 128B-swizzled operand at `smem`
// (see the top of this file for LBO/SBO of K-major and MN-major operands)
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(smem) & 0x3FFFF) >> 4) |
         uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}
// the same descriptor `bytes` further on (a slice of the reduction)
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// the same value, hidden from the compiler's loop-invariant code motion:
// descriptors derived from it are then computed where they are used
// instead of holding registers across a loop
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// before a wgmma reads registers (accumulators, A fragments) that ordinary
// instructions wrote, and before the first wgmma after shared memory changed
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
// that completes it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// device: the m64nNk16 products of T (bf16 or f16), f32 accumulate (one
// warpgroup); T picks the mnemonic's input types
// ---------------------------------------------------------------------------

// d[16] (+)= A[64x16] B[16x32], A and B from shared memory (descriptors), both K-major
#define TFS_WGMMA_SS_16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_f16<T>)
    TFS_WGMMA_SS_16("f16");
  else
    TFS_WGMMA_SS_16("bf16");
}

// d[32] (+)= A[64x16] B[16x64], A and B from shared memory (descriptors), both K-major
#define TFS_WGMMA_SS_32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_f16<T>)
    TFS_WGMMA_SS_32("f16");
  else
    TFS_WGMMA_SS_32("bf16");
}

// d[64] (+)= A[64x16] B[16x128], A and B from shared memory (descriptors), both K-major
#define TFS_WGMMA_SS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_f16<T>)
    TFS_WGMMA_SS_64("f16");
  else
    TFS_WGMMA_SS_64("bf16");
}

// d[32] += A[64x16] B[16x64], A from registers (the accumulator layout packed
// to pairs of T), B from shared memory, MN-major (the transpose bit)
#define TFS_WGMMA_RS_32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (is_f16<T>)
    TFS_WGMMA_RS_32("f16");
  else
    TFS_WGMMA_RS_32("bf16");
}

// d[64] += A[64x16] B[16x128], A from registers (the accumulator layout packed
// to pairs of T), B from shared memory, MN-major (the transpose bit)
#define TFS_WGMMA_RS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (is_f16<T>)
    TFS_WGMMA_RS_64("f16");
  else
    TFS_WGMMA_RS_64("bf16");
}

// ---------------------------------------------------------------------------
// device: register budgets of the warp roles
// ---------------------------------------------------------------------------

// A producer warpgroup gives registers up and the consumer warpgroups take
// them; every warp of a warpgroup executes it, and the roles must be one
// if/else at the top of the kernel that never reconverges (or ptxas ignores
// it, warning C7508).  ptxas (CUDA 12.8) still allocates a thread no more
// than its sub-partition's share under the launch bound -- 16384 registers
// over the most warps one of the SM's four holds, 168 at 384 threads --
// whatever setmaxnreg grants, so a kernel that needs more (the Dh = 256
// forward, dQ and dK/dV, ~200) runs 8 warps and no producer warpgroup.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace tfs_hopper
