// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV kernels.
//
// Replaces tensorframes_tpu/parallel/flash.py::_flash_bwd_dq_kernel
// (pallas_call at flash.py:526) and ::_flash_bwd_dkv_kernel (pallas_call at
// flash.py:546), both launched by _flash_bwd_impl, the backward of
// flash_attention's custom_vjp.  Given q, k, v, dO, the forward's per-row
// logsumexp and D = rowsum(dO * O) (computed outside, in f32, as JAX does),
// each recomputes the probabilities P = exp(S * scale - lse) tile by tile,
// so no [Lq, Lk] array reaches device memory:
//   dQ = scale * sum_k (P o (dP - D)) K          with dP = dO V^T
//   dV = sum_q P^T dO,   dK = scale * sum_q (P o (dP - D))^T Q
// dK/dV sum over every query head of a GQA group and come out at kv width.
//
// What bounds them on the H100: at the flagship shape (B=8, L=2048, H=16,
// Dh=64, causal, bf16) dQ does 6*Dh and dK/dV 8*Dh FLOP per (query, key)
// pair (~103 and ~137 GFLOP) against ~0.2 GB of inputs each: bound by
// operations, i.e. by how well the loops keep the tensor cores fed.
//
// What the design does about it (bf16, the main path):
//  * The TPU grid's sequential axis becomes a loop inside one CTA, so
//    nothing carries between blocks and nothing needs atomics: the results
//    are deterministic.
//  * dQ: one CTA of 4 warps owns one (batch*head, 64-query tile); each warp
//    owns 16 query rows.  Q and dO are loaded once; 64-key K/V tiles stream
//    through a cp.async double buffer up to the diagonal (the causal skip is
//    the loop bound).  S = Q K^T and dP = dO V^T run on the tensor cores
//    (mma.sync m16n8k16, f32 accumulate), P and dS stay in registers, and dS
//    (cast to bf16) is the A operand of dQ += dS K straight from them.
//  * dK/dV: one CTA of 4 warps owns one (batch*kv head, 64-key tile); each
//    warp owns 16 keys.  K and V are loaded once; the CTA loops over every
//    (query head of the group, query tile) pair from the diagonal on, with
//    Q, dO, lse and D double-buffered.  It computes S^T = K Q^T and
//    dP^T = V dO^T directly, so P^T and dS^T are already the A operands of
//    dV += P^T dO and dK += dS^T Q; dK and dV stay in f32 registers across
//    the whole group (the TPU kernel's VMEM accumulation, flash.py:537-541).
//  * Loads are 16-byte vectors straight from [B, L, H, Dh] through its
//    strides (no transpose or pad copy); ragged tails are zero-filled by the
//    copy and masked here.
// Numerics kept from flash.py: P is cast to dO's dtype before P^T dO (:482)
// and dS to q/k's dtype before its products (:443, :489); the scale is
// applied in f32; a row whose lse is -inf takes lse 0 under the mask and
// never computes exp(finite - (-inf)) (:409-412); the causal mask is
// top-left (q >= k) when Lq != Lk.
// f32 inputs take plain FMA kernels (TF32 would lose precision the JAX
// reference keeps); they are off the main path.
// Not yet done (later work): TMA loads, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace tfs_flash;

// element strides (batch, length, head) of q, k, v and dO
struct Strides {
  int64_t q[3], k[3], v[3], d[3];
};

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Lq] f32, the forward's logsumexp
  const float* delta;  // [B, H, Lq] f32, rowsum(dO * O)
  int H, KVH, Lq, Lk, causal;
  float scale;
  Strides s;
};

// lse of one query row as the mask uses it: 0 outside the sequence and for
// all-masked rows (lse = -inf), flash.py:411
__device__ __forceinline__ float safe_lse(const float* lse, int64_t i, bool ok) {
  if (!ok) return 0.f;
  const float x = lse[i];
  return x == -INFINITY ? 0.f : x;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int BQ = 64;        // query rows per dQ CTA
constexpr int BK = 64;        // keys per dQ tile
constexpr int BKV = 64;       // keys per dK/dV CTA

// query rows per dK/dV tile: fewer at Dh=128, where dK and dV take 128
// accumulator registers a thread
template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q and dO tiles + two K and two V tiles, rows padded by 8 elements
  return size_t(2 * BQ + 4 * BK) * (D + 8) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K and V tiles + two Q and two dO tiles + two (lse, D) row vectors
  return size_t(2 * BKV + 4 * dkv_bq<D>()) * (D + 8) * sizeof(bf16) +
         size_t(4 * dkv_bq<D>()) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16(Problem p, bf16* __restrict__ dq) {
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;  // 8-key column tiles of S per warp
  constexpr int DT = D / 8;   // 8-wide column tiles of dQ per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BQ * LD;      // dO
  bf16* Ks = Os + BQ * LD;      // two buffers of BK rows
  bf16* Vs = Ks + 2 * BK * LD;  // two buffers of BK rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int H = p.H, Lq = p.Lq, Lk = p.Lk;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / p.KVH);
  // causal: the heavier (later) query tiles are launched first
  const int q0 = int(p.causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x) * BQ;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.s.q[0] + h * p.s.q[2];
  const bf16* ob = static_cast<const bf16*>(p.dout) + b * p.s.d[0] + h * p.s.d[2];
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.s.k[0] + kvh * p.s.k[2];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.s.v[0] + kvh * p.s.v[2];

  int n_tiles = (Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + BQ, Lq) - 1) / BK + 1);

  load_rows_async<D, THREADS>(Qs, qb, p.s.q[1], q0, BQ, Lq, tid);
  load_rows_async<D, THREADS>(Os, ob, p.s.d[1], q0, BQ, Lq, tid);
  if (n_tiles > 0) {
    load_rows_async<D, THREADS>(Ks, kb, p.s.k[1], 0, BK, Lk, tid);
    load_rows_async<D, THREADS>(Vs, vb, p.s.v[1], 0, BK, Lk, tid);
  }
  cp_async_commit();

  const int wq0 = q0 + warp * 16;                // this warp's first query row
  const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
  const int64_t r0 = int64_t(bh) * Lq;
  const float la_a = safe_lse(p.lse, r0 + row_a, row_a < Lq) * LOG2E;
  const float la_b = safe_lse(p.lse, r0 + row_b, row_b < Lq) * LOG2E;
  const float dd_a = row_a < Lq ? p.delta[r0 + row_a] : 0.f;
  const float dd_b = row_b < Lq ? p.delta[r0 + row_b] : 0.f;
  const float sl2 = p.scale * LOG2E;
  float acc[DT][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in during this one
      load_rows_async<D, THREADS>(Ks + (buf ^ 1) * BK * LD, kb, p.s.k[1], (t + 1) * BK, BK, Lk, tid);
      load_rows_async<D, THREADS>(Vs + (buf ^ 1) * BK * LD, vb, p.s.v[1], (t + 1) * BK, BK, Lk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile t have landed
    __syncthreads();

    const int k0 = t * BK;
    // a tile wholly above this warp's rows contributes nothing
    if (!p.causal || k0 <= wq0 + 15) {
      const bf16* Kt = Ks + buf * BK * LD;
      const bf16* Vt = Vs + buf * BK * LD;
      float s[NT][4] = {}, dp[NT][4] = {};
      // S = Q K^T and dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        load_a(aq, Qs, LD, warp * 16, kk * 16, lane);
        load_a(ao, Os, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4], bv[4];
          load_bt(bk, Kt, LD, np * 16, kk * 16, lane);
          mma_16816(s[2 * np], aq, bk[0], bk[1]);
          mma_16816(s[2 * np + 1], aq, bk[2], bk[3]);
          load_bt(bv, Vt, LD, np * 16, kk * 16, lane);
          mma_16816(dp[2 * np], ao, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }
      // P = exp(S * scale - lse), masked where the tile crosses the
      // diagonal or an end of the sequences; then dS = P o (dP - D) in place
      const bool need_mask =
          k0 + BK > Lk || wq0 + 16 > Lq || (p.causal && k0 + BK - 1 > wq0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_a : row_b;
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          float pr = exp2f(s[j][e] * sl2 - (e < 2 ? la_a : la_b));
          if (need_mask && (col >= Lk || row >= Lq || (p.causal && row < col)))
            pr = 0.f;
          s[j][e] = pr * (dp[j][e] - (e < 2 ? dd_a : dd_b));
        }
      }
      // dQ += dS K, dS cast to bf16 (k's dtype) straight from registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          uint32_t bk[4];
          load_b(bk, Kt, LD, kk * 16, dn * 16, lane);
          mma_16816(acc[2 * dn], a, bk[0], bk[1]);
          mma_16816(acc[2 * dn + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();

  // dQ (contiguous [B, Lq, H, D]) = scale * acc, in q's dtype
  const float sc = p.scale;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_a) * H + h) * D + col) =
          pack_bf16(acc[j][0] * sc, acc[j][1] * sc);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_b) * H + h) * D + col) =
          pack_bf16(acc[j][2] * sc, acc[j][3] * sc);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16(Problem p, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int LD = D + 8;
  constexpr int BQ2 = dkv_bq<D>();
  constexpr int NT = BQ2 / 8;  // 8-query column tiles of S^T per warp
  constexpr int DT = D / 8;    // 8-wide column tiles of dK/dV per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;       // two buffers of BQ2 rows
  bf16* Os = Qs + 2 * BQ2 * LD;   // dO: two buffers of BQ2 rows
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ2 * LD);  // lse*log2(e), x2
  float* Ds = Ls + 2 * BQ2;                                  // D, x2

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = p.H, KVH = p.KVH, Lq = p.Lq, Lk = p.Lk, grp = H / KVH;
  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int k0 = blockIdx.x * BKV;
  const int wk0 = k0 + warp * 16;                // this warp's first key
  const int key_a = wk0 + g, key_b = key_a + 8;  // this thread's two keys
  const int nq = (Lq + BQ2 - 1) / BQ2;
  // causal: query tiles that end before k0 see none of these keys
  const int qt0 = p.causal ? min(k0 / BQ2, nq) : 0;
  const int nqe = nq - qt0;
  const int n_iter = grp * nqe;  // (query head of the group, query tile)
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.s.k[0] + kvh * p.s.k[2];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.s.v[0] + kvh * p.s.v[2];

  // stage pair `it` (its Q, dO, lse and D) into buffer `buf`
  auto stage = [&](int it, int buf) {
    const int h = kvh * grp + it / nqe;
    const int qq0 = (qt0 + it % nqe) * BQ2;
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.s.q[0] + h * p.s.q[2];
    const bf16* ob = static_cast<const bf16*>(p.dout) + b * p.s.d[0] + h * p.s.d[2];
    load_rows_async<D, THREADS>(Qs + buf * BQ2 * LD, qb, p.s.q[1], qq0, BQ2, Lq, tid);
    load_rows_async<D, THREADS>(Os + buf * BQ2 * LD, ob, p.s.d[1], qq0, BQ2, Lq, tid);
    if (tid < BQ2) {
      const int row = qq0 + tid;
      const int64_t i = (int64_t(b) * H + h) * Lq + row;
      Ls[buf * BQ2 + tid] = safe_lse(p.lse, i, row < Lq) * LOG2E;
      Ds[buf * BQ2 + tid] = row < Lq ? p.delta[i] : 0.f;
    }
  };

  load_rows_async<D, THREADS>(Ks, kb, p.s.k[1], k0, BKV, Lk, tid);
  load_rows_async<D, THREADS>(Vs, vb, p.s.v[1], k0, BKV, Lk, tid);
  if (n_iter > 0) stage(0, 0);
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;
  float adk[DT][4] = {}, adv[DT][4] = {};

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and pair `it` have landed
    __syncthreads();

    const int qq0 = (qt0 + it % nqe) * BQ2;
    // a query tile wholly before this warp's keys contributes nothing
    if (!p.causal || qq0 + BQ2 - 1 >= wk0) {
      const bf16* Qt = Qs + buf * BQ2 * LD;
      const bf16* Ot = Os + buf * BQ2 * LD;
      const float* Lt = Ls + buf * BQ2;
      const float* Dt = Ds + buf * BQ2;
      float st[NT][4] = {}, dpt[NT][4] = {};
      // S^T = K Q^T and dP^T = V dO^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, LD, warp * 16, kk * 16, lane);
        load_a(av, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bq[4], bo[4];
          load_bt(bq, Qt, LD, np * 16, kk * 16, lane);
          mma_16816(st[2 * np], ak, bq[0], bq[1]);
          mma_16816(st[2 * np + 1], ak, bq[2], bq[3]);
          load_bt(bo, Ot, LD, np * 16, kk * 16, lane);
          mma_16816(dpt[2 * np], av, bo[0], bo[1]);
          mma_16816(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      const bool need_mask =
          qq0 + BQ2 > Lq || wk0 + 16 > Lk || (p.causal && qq0 < wk0 + 15);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t4 + (e & 1);
          const int col = qq0 + ql;  // the query
          const int key = e < 2 ? key_a : key_b;
          float pr = exp2f(st[j][e] * sl2 - Lt[ql]);
          if (need_mask && (col >= Lq || key >= Lk || (p.causal && col < key)))
            pr = 0.f;
          st[j][e] = pr;                          // P^T
          dpt[j][e] = pr * (dpt[j][e] - Dt[ql]);  // dS^T
        }
      }
      // dV += P^T dO (P cast to dO's dtype), dK += dS^T Q (dS cast to q's)
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk) {
        const uint32_t ap[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]),
        };
        const uint32_t as[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          uint32_t bo[4], bq[4];
          load_b(bo, Ot, LD, kk * 16, dn * 16, lane);
          mma_16816(adv[2 * dn], ap, bo[0], bo[1]);
          mma_16816(adv[2 * dn + 1], ap, bo[2], bo[3]);
          load_b(bq, Qt, LD, kk * 16, dn * 16, lane);
          mma_16816(adk[2 * dn], as, bq[0], bq[1]);
          mma_16816(adk[2 * dn + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();

  // dK = scale * acc and dV (contiguous [B, Lk, KVH, D]), in k/v's dtype
  const float sc = p.scale;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (key_a < Lk) {
      const int64_t o = ((int64_t(b) * Lk + key_a) * KVH + kvh) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(adk[j][0] * sc, adk[j][1] * sc);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(adv[j][0], adv[j][1]);
    }
    if (key_b < Lk) {
      const int64_t o = ((int64_t(b) * Lk + key_b) * KVH + kvh) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(adk[j][2] * sc, adk[j][3] * sc);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(adv[j][2], adv[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA kernels over 32 x 32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int FT = 32;          // query rows and keys per f32 tile
constexpr int F_THREADS = 128;  // 4 threads per output row

template <int D>
constexpr size_t f32_smem_bytes() {
  // Q, dO, K, V tiles (rows of D + 1), P and dS tiles, lse and D vectors
  return (size_t(4) * FT * (D + 1) + 2 * FT * (FT + 1) + 2 * FT) * sizeof(float);
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              int64_t s_l, int row0, int L,
                                              int tid) {
  for (int i = tid; i < FT * D; i += F_THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < L ? base[row * s_l + c] : 0.f;
  }
}

// lse (safe) and D of query rows [q0, q0 + FT) of head bh
__device__ __forceinline__ void load_rows_f32(float* Ls, float* Ds,
                                              const Problem& p, int64_t bh,
                                              int q0, int tid) {
  if (tid < FT) {
    const int row = q0 + tid;
    const int64_t i = bh * p.Lq + row;
    Ls[tid] = safe_lse(p.lse, i, row < p.Lq);
    Ds[tid] = row < p.Lq ? p.delta[i] : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair, [query][key] in Ps / Ss
template <int D>
__device__ __forceinline__ void p_ds_tile_f32(
    const float* Qs, const float* Os, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, int q0, int k0, const Problem& p,
    float* Ps, float* Ss, int tid) {
  for (int i = tid; i < FT * FT; i += F_THREADS) {
    const int r = i / FT, c = i % FT;
    const float* qr = Qs + r * (D + 1);
    const float* orow = Os + r * (D + 1);
    const float* kr = Ks + c * (D + 1);
    const float* vr = Vs + c * (D + 1);
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(orow[d], vr[d], dp);
    }
    const int qi = q0 + r, kj = k0 + c;
    const bool ok = qi < p.Lq && kj < p.Lk && (!p.causal || qi >= kj);
    const float pr = ok ? expf(s * p.scale - Ls[r]) : 0.f;
    Ps[r * (FT + 1) + c] = pr;
    Ss[r * (FT + 1) + c] = pr * (dp - Ds[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32(Problem p, float* __restrict__ dq) {
  constexpr int LD = D + 1, NJ = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + FT * LD;
  float* Ks = Os + FT * LD;
  float* Vs = Ks + FT * LD;
  float* Ps = Vs + FT * LD;
  float* Ss = Ps + FT * (FT + 1);
  float* Ls = Ss + FT * (FT + 1);
  float* Ds = Ls + FT;

  const int tid = threadIdx.x;
  const int H = p.H, Lq = p.Lq, Lk = p.Lk;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / p.KVH);
  const int q0 = blockIdx.x * FT;
  const float* qb = static_cast<const float*>(p.q) + b * p.s.q[0] + h * p.s.q[2];
  const float* ob = static_cast<const float*>(p.dout) + b * p.s.d[0] + h * p.s.d[2];
  const float* kb = static_cast<const float*>(p.k) + b * p.s.k[0] + kvh * p.s.k[2];
  const float* vb = static_cast<const float*>(p.v) + b * p.s.v[0] + kvh * p.s.v[2];
  load_tile_f32<D>(Qs, qb, p.s.q[1], q0, Lq, tid);
  load_tile_f32<D>(Os, ob, p.s.d[1], q0, Lq, tid);
  load_rows_f32(Ls, Ds, p, bh, q0, tid);

  const int r = tid / 4, c0 = tid % 4;  // this thread: row r, columns c0 + 4j
  float acc[NJ] = {};
  int n_tiles = (Lk + FT - 1) / FT;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + FT, Lq) - 1) / FT + 1);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile is consumed
    load_tile_f32<D>(Ks, kb, p.s.k[1], t * FT, Lk, tid);
    load_tile_f32<D>(Vs, vb, p.s.v[1], t * FT, Lk, tid);
    __syncthreads();
    p_ds_tile_f32<D>(Qs, Os, Ks, Vs, Ls, Ds, q0, t * FT, p, Ps, Ss, tid);
    __syncthreads();
    for (int c = 0; c < FT; ++c) {
      const float ds = Ss[r * (FT + 1) + c];
      const float* kr = Ks + c * LD + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = fmaf(ds, kr[4 * j], acc[j]);
    }
  }
  const int row = q0 + r;
  if (row < Lq) {
    float* dst = dq + ((int64_t(b) * Lq + row) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[4 * j] = acc[j] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkv_f32(Problem p, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int LD = D + 1, NJ = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + FT * LD;
  float* Ks = Os + FT * LD;
  float* Vs = Ks + FT * LD;
  float* Ps = Vs + FT * LD;
  float* Ss = Ps + FT * (FT + 1);
  float* Ls = Ss + FT * (FT + 1);
  float* Ds = Ls + FT;

  const int tid = threadIdx.x;
  const int H = p.H, KVH = p.KVH, Lq = p.Lq, Lk = p.Lk, grp = H / KVH;
  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int k0 = blockIdx.x * FT;
  const float* kb = static_cast<const float*>(p.k) + b * p.s.k[0] + kvh * p.s.k[2];
  const float* vb = static_cast<const float*>(p.v) + b * p.s.v[0] + kvh * p.s.v[2];
  load_tile_f32<D>(Ks, kb, p.s.k[1], k0, Lk, tid);
  load_tile_f32<D>(Vs, vb, p.s.v[1], k0, Lk, tid);

  const int kr = tid / 4, c0 = tid % 4;  // this thread: key kr, columns c0 + 4j
  float adk[NJ] = {}, adv[NJ] = {};
  const int nq = (Lq + FT - 1) / FT;
  const int qt0 = p.causal ? min(k0 / FT, nq) : 0;
  for (int gi = 0; gi < grp; ++gi) {
    const int h = kvh * grp + gi;
    const float* qb = static_cast<const float*>(p.q) + b * p.s.q[0] + h * p.s.q[2];
    const float* ob = static_cast<const float*>(p.dout) + b * p.s.d[0] + h * p.s.d[2];
    for (int qt = qt0; qt < nq; ++qt) {
      __syncthreads();  // the previous pair is consumed
      load_tile_f32<D>(Qs, qb, p.s.q[1], qt * FT, Lq, tid);
      load_tile_f32<D>(Os, ob, p.s.d[1], qt * FT, Lq, tid);
      load_rows_f32(Ls, Ds, p, int64_t(b) * H + h, qt * FT, tid);
      __syncthreads();
      p_ds_tile_f32<D>(Qs, Os, Ks, Vs, Ls, Ds, qt * FT, k0, p, Ps, Ss, tid);
      __syncthreads();
      for (int r = 0; r < FT; ++r) {
        const float pr = Ps[r * (FT + 1) + kr];
        const float ds = Ss[r * (FT + 1) + kr];
        const float* qr = Qs + r * LD + c0;
        const float* orow = Os + r * LD + c0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          adv[j] = fmaf(pr, orow[4 * j], adv[j]);
          adk[j] = fmaf(ds, qr[4 * j], adk[j]);
        }
      }
    }
  }
  const int key = k0 + kr;
  if (key < Lk) {
    const int64_t o = ((int64_t(b) * Lk + key) * KVH + kvh) * D + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[o + 4 * j] = adk[j] * p.scale;
      dv[o + 4 * j] = adv[j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename... Out>
cudaError_t run(void (*kernel)(Problem, Out...), dim3 grid, int threads,
                size_t bytes, cudaStream_t stream, const Problem& p,
                Out... out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p, out...);
  return cudaGetLastError();
}

bool valid(int B, int heads, int H, int KVH, int Lq, int Lk) {
  return B * heads <= 65535 && KVH > 0 && H % KVH == 0 && Lq > 0 && Lk > 0;
}

Problem problem(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, int H, int KVH, int Lq,
                int Lk, int causal, const int64_t* st, float scale) {
  Problem p{q, k, v, dout, lse, delta, H, KVH, Lq, Lk, causal, scale, {}};
  for (int i = 0; i < 3; ++i) {
    p.s.q[i] = st[i];
    p.s.k[i] = st[3 + i];
    p.s.v[i] = st[6 + i];
    p.s.d[i] = st[9 + i];
  }
  return p;
}

}  // namespace

// q, dout: [B, Lq, H, D]; k, v: [B, Lk, KVH, D], with element strides
// (batch, length, head) of q, k, v, dout in `strides` (12 values) and a
// contiguous head dim.  lse, delta: contiguous [B, H, Lq] f32.  dq:
// contiguous [B, Lq, H, D] in the input dtype.  dtype: 0 = f32, 1 = bf16.
// Returns a cudaError_t (0 = launched).
extern "C" int tfs_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int H,
                                int KVH, int Lq, int Lk, int D, int dtype,
                                int causal, const int64_t* strides,
                                float scale, void* stream) {
  if (!valid(B, H, H, KVH, Lq, Lk)) return int(cudaErrorInvalidValue);
  const Problem p = problem(q, k, v, dout, lse, delta, H, KVH, Lq, Lk, causal,
                            strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_mma((Lq + BQ - 1) / BQ, B * H), grid_f32((Lq + FT - 1) / FT, B * H);
  bf16* o16 = static_cast<bf16*>(dq);
  float* o32 = static_cast<float*>(dq);
  if (dtype == 1 && D == 64)
    return int(run(flash_bwd_dq_bf16<64>, grid_mma, THREADS, dq_smem_bytes<64>(), st, p, o16));
  if (dtype == 1 && D == 128)
    return int(run(flash_bwd_dq_bf16<128>, grid_mma, THREADS, dq_smem_bytes<128>(), st, p, o16));
  if (dtype == 0 && D == 64)
    return int(run(flash_bwd_dq_f32<64>, grid_f32, F_THREADS, f32_smem_bytes<64>(), st, p, o32));
  if (dtype == 0 && D == 128)
    return int(run(flash_bwd_dq_f32<128>, grid_f32, F_THREADS, f32_smem_bytes<128>(), st, p, o32));
  return int(cudaErrorInvalidValue);
}

// The same inputs; dk, dv: contiguous [B, Lk, KVH, D] in the input dtype.
extern "C" int tfs_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv, int B,
                                 int H, int KVH, int Lq, int Lk, int D,
                                 int dtype, int causal, const int64_t* strides,
                                 float scale, void* stream) {
  if (!valid(B, KVH, H, KVH, Lq, Lk)) return int(cudaErrorInvalidValue);
  const Problem p = problem(q, k, v, dout, lse, delta, H, KVH, Lq, Lk, causal,
                            strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_mma((Lk + BKV - 1) / BKV, B * KVH), grid_f32((Lk + FT - 1) / FT, B * KVH);
  bf16 *k16 = static_cast<bf16*>(dk), *v16 = static_cast<bf16*>(dv);
  float *k32 = static_cast<float*>(dk), *v32 = static_cast<float*>(dv);
  if (dtype == 1 && D == 64)
    return int(run(flash_bwd_dkv_bf16<64>, grid_mma, THREADS, dkv_smem_bytes<64>(), st, p, k16, v16));
  if (dtype == 1 && D == 128)
    return int(run(flash_bwd_dkv_bf16<128>, grid_mma, THREADS, dkv_smem_bytes<128>(), st, p, k16, v16));
  if (dtype == 0 && D == 64)
    return int(run(flash_bwd_dkv_f32<64>, grid_f32, F_THREADS, f32_smem_bytes<64>(), st, p, k32, v32));
  if (dtype == 0 && D == 128)
    return int(run(flash_bwd_dkv_f32<128>, grid_f32, F_THREADS, f32_smem_bytes<128>(), st, p, k32, v32));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
