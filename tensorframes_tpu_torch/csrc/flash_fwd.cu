// Flash-attention forward for Hopper (sm_90a).
//
// Replaces tensorframes_tpu/parallel/flash.py::_flash_kernel, the Pallas TPU
// kernel launched by _flash_fwd_impl (pallas_call at flash.py:177) and exposed
// as flash_attention.  It computes out = softmax(Q K^T * scale) V and the
// per-row logsumexp, with the online-softmax recurrence, so the [Lq, Lk]
// scores never reach device memory.
//
// What bounds it on the H100: at the flagship shape (B=8, L=2048, H=16,
// Dh=64, causal, bf16) the work is ~69 GFLOP against ~17 MB of inputs and
// outputs, about 4000 FLOP per byte -- far above the card's ~295 FLOP/byte
// ridge, so it is bound by operations: the tensor-core rate, and in practice
// by how well the loop keeps the tensor cores fed.
//
// What the design does about it (the bf16 kernel, the main path):
//  * One CTA of 8 warps owns one (batch*head, 128-query tile); each warp owns
//    16 query rows.  The TPU kernel's sequential third grid axis over K/V
//    blocks (running max, denominator and accumulator carried in VMEM scratch
//    between grid steps) becomes a loop over 64-key tiles inside the CTA: GPU
//    blocks run in no order, so nothing may carry between them.
//  * Both products run on the tensor cores (mma.sync m16n8k16 bf16, f32
//    accumulate; operands loaded with ldmatrix).  Products of two bf16
//    values are exact in f32, matching JAX's preferred_element_type=f32.
//  * Scores, probabilities, the running max/denominator and the output
//    accumulator all stay in registers: the score accumulator's layout is
//    the next product's A-operand layout, so P never touches shared memory.
//  * K/V tiles are double-buffered in shared memory with cp.async: tile t+1
//    is in flight while tile t is multiplied; each tile is read by all eight
//    warps.  Loads are 16-byte vectors straight from the [B, L, H, Dh]
//    layout through its strides (no transpose or pad copy); the ragged tail
//    is zero-filled by the copy and masked here.
//  * Causal: the tile loop ends at the diagonal, a warp skips the tiles
//    wholly above its rows, only tiles that cross the diagonal (or the end
//    of the keys) are masked, and CTAs of later (heavier) query tiles are
//    launched first.
//  * GQA: query head h reads kv head h / (H / KVH), flash.py:_kv_head_map.
// f32 inputs take a plain FMA kernel (TF32 would lose precision the JAX
// reference keeps); it is off the main path.
// Not yet done (later work): TMA loads, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace tfs_flash;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 128;           // query rows per CTA
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;      // 8 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q tile + two K and two V tiles, rows padded by 8 elements so that the
  // eight row addresses of an ldmatrix fall in distinct banks
  return size_t(BQ + 4 * BK) * (D + 8) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int H, int KVH, int Lq, int Lk,
               int causal, int64_t q_sb, int64_t q_sl, int64_t q_sh,
               int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
               int64_t v_sl, int64_t v_sh, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;  // 8-key column tiles of S per warp
  constexpr int DT = D / 8;   // 8-wide column tiles of O per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;      // two buffers of BK rows
  bf16* Vs = Ks + 2 * BK * LD;  // two buffers of BK rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x) * BQ;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Lq) - 1) / BK + 1);

  load_rows_async<D, THREADS>(Qs, qb, q_sl, q0, BQ, Lq, tid);
  if (n_tiles > 0) {
    load_rows_async<D, THREADS>(Ks, kb, k_sl, 0, BK, Lk, tid);
    load_rows_async<D, THREADS>(Vs, vb, v_sl, 0, BK, Lk, tid);
  }
  cp_async_commit();

  const int wq0 = q0 + warp * 16;    // this warp's first query row
  const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in during this one
      load_rows_async<D, THREADS>(Ks + (buf ^ 1) * BK * LD, kb, k_sl, (t + 1) * BK, BK, Lk, tid);
      load_rows_async<D, THREADS>(Vs + (buf ^ 1) * BK * LD, vb, v_sl, (t + 1) * BK, BK, Lk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();

    const int k0 = t * BK;
    // a tile wholly above this warp's rows contributes nothing
    if (!causal || k0 <= wq0 + 15) {
      const bf16* Kt = Ks + buf * BK * LD;
      const bf16* Vt = Vs + buf * BK * LD;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                 (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, smem_addr(Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_16816(s[2 * np], a, bq[0], bq[1]);
          mma_16816(s[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      // scale, then mask the tiles that cross the diagonal or the key end
      const bool need_mask = (k0 + BK > Lk) || (causal && k0 + BK - 1 > wq0);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (need_mask) {
            const int col = k0 + j * 8 + 2 * t4 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= Lk || (causal && row < col)) x = -INFINITY;
          }
          s[j][e] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      // a row's 64 scores are spread over the 4 lanes of its quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // -inf-safe: a row with no unmasked key yet keeps m = -inf and adds
      // zeros, never NaNs (flash.py:101-105)
      const float ms_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float ms_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = m_a == -INFINITY ? 0.f : exp2f((m_a - ms_a) * LOG2E);
      const float al_b = m_b == -INFINITY ? 0.f : exp2f((m_b - ms_b) * LOG2E);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f((s[j][0] - ms_a) * LOG2E);
        s[j][1] = exp2f((s[j][1] - ms_a) * LOG2E);
        s[j][2] = exp2f((s[j][2] - ms_b) * LOG2E);
        s[j][3] = exp2f((s[j][3] - ms_b) * LOG2E);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
      l_a = al_a * l_a + sum_a;  // the f32 p, before its cast (flash.py:106)
      l_b = al_b * l_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
      // O += P V, P cast to bf16 (v's dtype, flash.py:107-108) straight from
      // the score registers into A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          dp * 16 + (lane >> 4) * 8));
          mma_16816(o[2 * dp], a, bv[0], bv[1]);
          mma_16816(o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();

  // finish (flash.py:115-122): out in bf16, lse = m + log(l)
  const float den_a = l_a == 0.f ? 1.f : l_a;
  const float den_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_a) * H + h) * D + col) =
          pack_bf16(o[j][0] / den_a, o[j][1] / den_a);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_b) * H + h) * D + col) =
          pack_bf16(o[j][2] / den_b, o[j][3] / den_b);
  }
  if (t4 == 0) {
    if (row_a < Lq) lse[int64_t(bh) * Lq + row_a] = m_a + logf(den_a);
    if (row_b < Lq) lse[int64_t(bh) * Lq + row_b] = m_b + logf(den_b);
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA kernel (two lanes per query row, tiles in shared memory)
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;
constexpr int F_BK = 64;
constexpr int F_THREADS = 128;  // 4 warps x 16 query rows
constexpr int S_LD = F_BK + 4;

template <int D>
constexpr size_t f32_smem_bytes() {
  return size_t(3) * F_BQ * (D + 8) * sizeof(float)  // Q, K, V tiles
         + size_t(F_BQ) * S_LD * sizeof(float)       // scores, then p
         + size_t(F_BQ) * (D + 4) * sizeof(float);   // output accumulator
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              int64_t s_l, int row0, int L,
                                              int tid) {
  constexpr int VPR = D / 4;
  for (int i = tid; i < F_BQ * VPR; i += F_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L) val = *reinterpret_cast<const float4*>(base + row * s_l + c);
    *reinterpret_cast<float4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int H, int KVH, int Lq, int Lk,
              int causal, int64_t q_sb, int64_t q_sl, int64_t q_sh,
              int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
              int64_t v_sl, int64_t v_sh, float scale) {
  constexpr int T_LD = D + 8, O_LD = D + 4, HALF = D / 2, HK = F_BK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + F_BQ * T_LD;
  float* Vs = Ks + F_BK * T_LD;
  float* Ss = Vs + F_BK * T_LD;
  float* Os = Ss + F_BQ * S_LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x) * F_BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  load_tile_f32<D>(Qs, qb, q_sl, q0, Lq, tid);
  for (int i = tid; i < F_BQ * O_LD; i += F_THREADS) Os[i] = 0.f;

  // lane pair (2r, 2r+1) owns row r of its warp: half the keys, half of Dh
  const int r = lane >> 1, half = lane & 1;
  const int wrow = warp * 16 + r;
  const int qrow = q0 + wrow;
  float* srow = Ss + wrow * S_LD + half * HK;
  float* orow = Os + wrow * O_LD + half * HALF;
  float m_i = -INFINITY, l_i = 0.f;

  int n_tiles = (Lk + F_BK - 1) / F_BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + F_BQ, Lq) - 1) / F_BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * F_BK;
    __syncthreads();
    load_tile_f32<D>(Ks, kb, k_sl, k0, Lk, tid);
    load_tile_f32<D>(Vs, vb, v_sl, k0, Lk, tid);
    __syncthreads();

    float sv[HK];
#pragma unroll
    for (int c = 0; c < HK; ++c) sv[c] = 0.f;
    const float* qr = Qs + wrow * T_LD;
    const float* kr = Ks + half * HK * T_LD;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int c = 0; c < HK; ++c) sv[c] = fmaf(qv, kr[c * T_LD + d], sv[c]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < HK; ++c) {
      const int j = k0 + half * HK + c;
      const bool ok = j < Lk && (!causal || qrow >= j);  // top-left causal
      sv[c] = ok ? sv[c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < HK; ++c) {
      const float p = expf(sv[c] - m_safe);
      srow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = m_i == -INFINITY ? 0.f : expf(m_i - m_safe);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    __syncwarp();  // p of both halves of the row is in Ss

    float acc[HALF];
#pragma unroll
    for (int dd = 0; dd < HALF; ++dd) acc[dd] = orow[dd] * alpha;
    const float* prow = Ss + wrow * S_LD;
    for (int j = 0; j < F_BK; ++j) {
      const float p = prow[j];
      const float* vr = Vs + j * T_LD + half * HALF;
#pragma unroll
      for (int dd = 0; dd < HALF; ++dd) acc[dd] = fmaf(p, vr[dd], acc[dd]);
    }
#pragma unroll
    for (int dd = 0; dd < HALF; ++dd) orow[dd] = acc[dd];
  }
  __syncthreads();  // with no tile at all, Os holds only the zero fill

  if (qrow < Lq) {
    const float denom = l_i == 0.f ? 1.f : l_i;
    float* dst = out + ((int64_t(b) * Lq + qrow) * H + h) * D + half * HALF;
#pragma unroll
    for (int dd = 0; dd < HALF; ++dd) dst[dd] = orow[dd] / denom;
    if (half == 0) lse[int64_t(bh) * Lq + qrow] = m_i + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, int bq, int threads, size_t bytes,
                   const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KVH, int Lq, int Lk,
                   int causal, const int64_t* s, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + bq - 1) / bq, B * H);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KVH, Lq, Lk,
      causal, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Lq, H, D], k/v: [B, Lk, KVH, D] with element strides
// (batch, length, head) each and a contiguous head dim; out: contiguous
// [B, Lq, H, D] in the input dtype; lse: contiguous [B, H, Lq] f32.
// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 = launched).
extern "C" int tfs_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int H, int KVH,
                             int Lq, int Lk, int D, int dtype, int causal,
                             int64_t q_sb, int64_t q_sl, int64_t q_sh,
                             int64_t k_sb, int64_t k_sl, int64_t k_sh,
                             int64_t v_sb, int64_t v_sl, int64_t v_sh,
                             float scale, void* stream) {
  if (B * H > 65535 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk < 0)
    return int(cudaErrorInvalidValue);
  const int64_t s[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && D == 64)
    err = launch<decltype(&flash_fwd_bf16<64>), bf16>(
        flash_fwd_bf16<64>, BQ, THREADS, mma_smem_bytes<64>(), q, k, v, out,
        lse, B, H, KVH, Lq, Lk, causal, s, scale, st);
  else if (dtype == 1 && D == 128)
    err = launch<decltype(&flash_fwd_bf16<128>), bf16>(
        flash_fwd_bf16<128>, BQ, THREADS, mma_smem_bytes<128>(), q, k, v, out,
        lse, B, H, KVH, Lq, Lk, causal, s, scale, st);
  else if (dtype == 0 && D == 64)
    err = launch<decltype(&flash_fwd_f32<64>), float>(
        flash_fwd_f32<64>, F_BQ, F_THREADS, f32_smem_bytes<64>(), q, k, v,
        out, lse, B, H, KVH, Lq, Lk, causal, s, scale, st);
  else if (dtype == 0 && D == 128)
    err = launch<decltype(&flash_fwd_f32<128>), float>(
        flash_fwd_f32<128>, F_BQ, F_THREADS, f32_smem_bytes<128>(), q, k, v,
        out, lse, B, H, KVH, Lq, Lk, causal, s, scale, st);
  return int(err);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
