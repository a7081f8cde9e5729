// One ring-attention hop for Hopper (sm_90a).
//
// Replaces tensorframes_tpu/parallel/flash.py::_ring_step_kernel, the Pallas
// TPU kernel launched by flash_ring_step (pallas_call at flash.py:344) on
// every forward hop of ring attention (attn_impl="ring_flash").  It folds
// one K/V chunk into the carried online-softmax state of a query chunk:
// per query row the running max m, the denominator l and the f32 numerator
// o, all read from device memory and written back WITHOUT the final 1/l and
// without forming a logsumexp -- the next hop continues from them.  The
// causal mask uses global positions, q_off + row >= k_off + col.
//
// What bounds it on the H100, at the flagship chunk (B=8, C=2048, H=16,
// Dh=64, bf16): the carry makes every hop read and write an f32
// [B, C, H, Dh] o (134 MB) beside 100 MB of q/k/v, so
//  * the diagonal hop (q_off == k_off, half the pairs) is bound by bytes:
//    ~0.071 ms at 3.35 TB/s against 0.0695 ms of operations;
//  * an off-diagonal hop (every pair visible) is bound by operations:
//    137 GFLOP, 0.139 ms at 989 TFLOP/s.
// The carry stays f32 (JAX carries f32); nothing is saved by rounding it.
//
// The design (the 16-bit kernel ring_step_tma, the main path, one template
// instantiated for bf16 and f16) is the forward's
// (flash_fwd.cu), warp-specialised on TMA and wgmma (building blocks in
// hopper.cuh), with the carry and the offsets:
//  * Warp roles.  One CTA owns one (batch*head, query tile).  Warpgroup 0
//    is the producer: one thread issues the TMA loads, Q once, then 128-key
//    K and V tiles of the chunk into a ring of STAGES slots guarded by full
//    and empty mbarriers.  setmaxnreg moves its registers to the consumer
//    warpgroups of 64 query rows each: three at Dh = 64 (192-query tiles),
//    two at Dh = 128, whose O accumulator leaves no registers for a third.
//  * S = Q K^T is wgmma m64n128k16 with both operands in 128B-swizzled
//    shared memory (K-major); O += P V is wgmma m64nDk16 with P in
//    registers, cast to T straight from the S accumulator, and V read
//    MN-major through the transpose bit.  Each consumer warpgroup runs its
//    tile loop on its own, so one's softmax overlaps the others' products.
//  * The carry in: before its first wait, each consumer thread loads its
//    rows' o (float2 per 8-column block: the wgmma accumulator layout,
//    which is mma.sync's m16n8) straight into the accumulator registers,
//    and m and l into its row registers, so the loads overlap the
//    producer's first TMA loads.  o makes one round trip through device
//    memory per hop, which is the least it can.
//  * m is the running max of the scaled scores, the softmax's own, so a
//    carried m goes in and out unconverted; alpha is exactly 1 while the
//    max holds, so a carry that no key outweighs comes out to f32 rounding.
//  * The carry out, un-normalised: no 1/l, no lse.  A skipped tile would
//    have left a row with a finite max unchanged and zeroed (alpha = 0) a
//    row whose max is -inf, so rows whose max is still -inf at the end
//    store m = -inf, l = 0 and o = 0: exactly what the TPU kernel stores
//    after folding every tile, with no NaN.  A hop hidden from every row of
//    a query tile visits no tile and returns its carry so.
//  * The mask on global positions: the tile loop ends at the last key any
//    row of the tile can see (visible_tiles), only tiles that cross the
//    diagonal or the end of the keys are masked, and an off-diagonal hop
//    (k_off + C <= q_off) masks nothing and visits every tile.  With three
//    consumers, a consumer releases without compute the trailing tiles
//    wholly hidden from its 64 rows (and every tile when its rows are past
//    the end), after the tile's K has landed, so the arrival counts for
//    this use of the slot; the consumer holding a tile's last row computes
//    it, so no load is left in flight at exit.
//  * The chunks are read through their strides by the TMA descriptors, so
//    q/k/v may be views; the descriptors bound L per batch and zero-fill,
//    the masks cover keys >= Lk, and rows >= Lq are neither loaded nor
//    stored.  GQA: query head h reads kv head h / (H / KVH).
//  * The forward keeps its own copy of this loop: built from one shared
//    loop, the forward measured 2-4% slower (PERF.md).  Both copies cover
//    Dh = 64 and 128; the forward's alone is built at 256 too.
// Numerics kept from the TPU kernel: P is cast to v's dtype before PV
// (flash.py:271-273), l sums the f32 p, and the running max is -inf-safe
// (flash.py:265-268), so a row that has seen no key adds zeros, never NaN.
// f32 inputs take a plain FMA kernel (TF32 would lose precision the JAX
// reference keeps), and so do bf16 and f16 at Dh = 256 and 512 (head dims
// 129..512, padded, the carried o with them): one template on the element
// type, P rounded to it before P V as above, the carry f32.  A head dim
// above 512 (padded to a multiple of it) runs the 512-wide build split into
// chunks of 512 columns of o, one grid axis over them.  Both are off the
// main path.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tfs_flash;
using namespace tfs_hopper;

// How many key tiles of width bk a query tile whose last row is q_last must
// visit: with the causal mask, key columns past q_off + q_last - k_off are
// hidden from every row (0 tiles when the whole chunk is hidden).
__device__ __forceinline__ int visible_tiles(int Lk, int bk, int causal,
                                             int q_off, int k_off, int q_last) {
  const int n = (Lk + bk - 1) / bk;
  if (!causal) return n;
  const long long last_col = (long long)q_off + q_last - k_off;
  if (last_col < 0) return 0;
  const long long need = last_col / bk + 1;
  return need < n ? int(need) : n;
}

// ---------------------------------------------------------------------------
// bf16 and f16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int BK = 128;  // keys per tile

template <int D>
struct Ring {
  // consumer warpgroups of 64 query rows each: three at Dh = 64, two at
  // Dh = 128, whose O accumulator leaves no registers for a third
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // the registers the CTA starts with, moved from the producer to the
  // consumers: 128 x 24 + 384 x 160 = 64512 = 512 x 126;
  // 128 x 40 + 256 x 232 = 64512 = 384 x 168
  static constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
  static constexpr int Q_BOX = BQ * 128;  // one 64-column box of the Q tile
  static constexpr int BOX = BK * 128;    // one 64-column box of a K or V tile
  static constexpr int Q_TILE = (D / BOX_COLS) * Q_BOX;
  static constexpr int TILE = (D / BOX_COLS) * BOX;  // one K or V tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  // Q; K full, V full and empty per slot
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr size_t SMEM = size_t(Q_TILE) + size_t(TILE) * 2 * STAGES +
                                 8 * BARRIERS + ATOM_BYTES;
};

// the carry: o [B, Lq, H, D] and m, l [B, H, Lq], f32 and contiguous, in
// and out (flash.py:241-245, :275-279)
struct Carry {
  const float* o_in;
  const float* m_in;
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
};

// flash_fwd.cu::fwd_narrow (flash_fwd_tma below Dh 512) holds a second
// copy of this loop (the same roles, ring, barrier phases, masks and early
// tile release), kept apart because one shared loop made the forward 2-4%
// slower (PERF.md).  A fix to any of those here is made there too, and the
// other way round.  The copies differ on purpose only in the prologue and
// epilogue (carry in and out here; 1/l and lse there), the global offsets
// of the mask, and alpha, which here is exactly 1 while the max holds.
template <typename T, int D>
__global__ void __launch_bounds__(Ring<D>::THREADS, 1)
ring_step_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const Carry cy,
              int H, int KVH, int Lq, int Lk, int causal, int q_off,
              int k_off, float scale) {
  using F = Ring<D>;
  constexpr int S = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const Qs = atom_aligned(smem_raw);
  unsigned char* const ring = Qs + F::Q_TILE;  // slot s: K tile, then V tile
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(ring + 2 * S * F::TILE);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + S;
  uint64_t* const empty = v_full + S;

  // the query tiles of one head are neighbours in the launch order, so the
  // CTAs in flight share their heads' K and V in L2; causal: the heavier
  // (later) tiles of a head launch first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * F::BQ;
  const int n_tiles =
      visible_tiles(Lk, BK, causal, q_off, k_off, min(q0 + F::BQ, Lq) - 1);
  // a key column is hidden from a row when col > row + delta
  const int delta = q_off - k_off;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 4 * F::CONSUMERS);  // every consumer warp releases a slot
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    regs_dec<F::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, F::Q_TILE);
      for (int x = 0; x < D / BOX_COLS; ++x)
        tma_load(Qs + x * F::Q_BOX, &q_map, q_full, x * BOX_COLS, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + s, (t / S - 1) & 1);  // its last use is done
        unsigned char* const Kt = ring + 2 * s * F::TILE;
        mbar_arrive_expect_tx(k_full + s, F::TILE);
        for (int x = 0; x < D / BOX_COLS; ++x)
          tma_load(Kt + x * F::BOX, &k_map, k_full + s, x * BOX_COLS, kvh, t * BK, b);
        mbar_arrive_expect_tx(v_full + s, F::TILE);
        for (int x = 0; x < D / BOX_COLS; ++x)
          tma_load(Kt + F::TILE + x * F::BOX, &v_map, v_full + s, x * BOX_COLS,
                   kvh, t * BK, b);
      }
    }
  } else {
    // a consumer: 64 query rows, 16 per warp
    regs_inc<F::CONSUMER_REGS>();
    constexpr int NT = BK / 8;  // 8-key column blocks of S
    constexpr int DT = D / 8;   // 8-wide column blocks of O
    const int c = threadIdx.x / 128 - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
    const int wg0 = q0 + 64 * c;             // this warpgroup's first row
    const int wq0 = wg0 + 16 * w;            // this warp's first row
    const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
    const bool in_a = row_a < Lq, in_b = row_b < Lq;
    const float sl2 = scale * LOG2E;
    // the carry in, before the first wait so that its loads overlap the
    // producer's first TMA loads: o straight into the accumulator
    // fragments, the running max of the scaled scores and the denominator
    // into this thread's two rows' registers
    const int64_t oa = ((int64_t(b) * Lq + row_a) * H + h) * D;
    const int64_t ob = ((int64_t(b) * Lq + row_b) * H + h) * D;
    const int64_t ra = int64_t(bh) * Lq + row_a, rb = int64_t(bh) * Lq + row_b;
    float o[DT * 4];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = j * 8 + 2 * t4;
      const float2 xa = in_a ? *reinterpret_cast<const float2*>(cy.o_in + oa + col)
                             : make_float2(0.f, 0.f);
      const float2 xb = in_b ? *reinterpret_cast<const float2*>(cy.o_in + ob + col)
                             : make_float2(0.f, 0.f);
      o[4 * j] = xa.x;
      o[4 * j + 1] = xa.y;
      o[4 * j + 2] = xb.x;
      o[4 * j + 3] = xb.y;
    }
    float m_a = in_a ? cy.m_in[ra] : -INFINITY, m_b = in_b ? cy.m_in[rb] : -INFINITY;
    float l_a = in_a ? cy.l_in[ra] : 0.f, l_b = in_b ? cy.l_in[rb] : 0.f;
    // A of S = Q K^T: this warpgroup's 64 rows of the Q tile
    const uint64_t q_desc = sw128_desc(Qs + 64 * c * 128, 16, ATOM_BYTES);
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const uint32_t ph = (t / S) & 1;
      const int k0 = t * BK;
      unsigned char* const Kt = ring + 2 * s * F::TILE;
      mbar_wait(k_full + s, ph);
      // rows past the end, or a tile wholly hidden from this warpgroup's
      // rows (the trailing tiles of its loop), add nothing: release the
      // slot, after the K wait so the arrival counts for this use of it.
      // Three consumers only, as in the forward (with two, few key tiles
      // lie wholly above a consumer's rows)
      if (F::CONSUMERS == 3 && (wg0 >= Lq || (causal && k0 > wg0 + 63 + delta))) {
        if (lane == 0) mbar_arrive(empty + s);
        continue;
      }
      // S = Q K^T, the reduction over Dh in 16-wide slices
      float sc[NT * 4];
      const uint64_t a_desc = opaque(q_desc);
      const uint64_t k_desc = sw128_desc(Kt, 16, ATOM_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(sc, desc_at(a_desc, (kk / 4) * F::Q_BOX + off),
                 desc_at(k_desc, (kk / 4) * F::BOX + off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask the tiles that cross the diagonal or the key end
      if ((k0 + BK > Lk) || (causal && k0 + BK - 1 > wq0 + delta)) {
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) {
          const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (col >= Lk || (causal && col > row + delta)) sc[i] = -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      // a row's 128 scores are spread over the 4 lanes of its quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // the max of the scaled scores is the scaled max of the raw ones
      // (rounding is monotonic)
      const float mn_a = fmaxf(m_a, mx_a * scale), mn_b = fmaxf(m_b, mx_b * scale);
      // -inf-safe: a row with no unmasked key yet keeps m = -inf and adds
      // zeros, never NaNs; p = exp(s * scale - m) as one FMA into exp2.
      // alpha is exactly 1 while the max holds: the FMA against the rounded
      // m * log2(e) leaves that rounding in alpha, and a carried o would
      // drift by it from tile to tile.  A max that leaves -inf gives
      // alpha = exp2(-inf) = 0; one that stays at -inf keeps alpha = 1 on
      // an o that the end stores as 0.  (Written as (m - mn) * log2(e)
      // instead, the kernel spilled at Dh = 64.)
      const float ms_a = mn_a == -INFINITY ? 0.f : mn_a * LOG2E;
      const float ms_b = mn_b == -INFINITY ? 0.f : mn_b * LOG2E;
      const float al_a = m_a == mn_a ? 1.f : exp2_ftz(fmaf(m_a, LOG2E, -ms_a));
      const float al_b = m_b == mn_b ? 1.f : exp2_ftz(fmaf(m_b, LOG2E, -ms_b));
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[4 * j] = exp2_ftz(fmaf(sc[4 * j], sl2, -ms_a));
        sc[4 * j + 1] = exp2_ftz(fmaf(sc[4 * j + 1], sl2, -ms_a));
        sc[4 * j + 2] = exp2_ftz(fmaf(sc[4 * j + 2], sl2, -ms_b));
        sc[4 * j + 3] = exp2_ftz(fmaf(sc[4 * j + 3], sl2, -ms_b));
        sum_a += sc[4 * j] + sc[4 * j + 1];
        sum_b += sc[4 * j + 2] + sc[4 * j + 3];
      }
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
      l_a = al_a * l_a + sum_a;  // the f32 p, before its cast (flash.py:270)
      l_b = al_b * l_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
      // p cast to T (v's dtype, flash.py:271-273): the A fragments of
      // the 16-key slices, straight from the score registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V, V MN-major: 16 keys (2048 bytes) per slice
      mbar_wait(v_full + s, ph);
      const uint64_t v_desc = sw128_desc(Kt + F::TILE, F::BOX, ATOM_BYTES);
      wgmma_fence();  // o was rescaled and pa written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T>(o, pa[kk], desc_at(v_desc, kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the slot
    }

    // the carry out (flash.py:275-279), not normalised: a row that saw no
    // key keeps m = -inf and stores l = 0, o = 0
    const bool dead_a = m_a == -INFINITY, dead_b = m_b == -INFINITY;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = j * 8 + 2 * t4;
      if (in_a)
        *reinterpret_cast<float2*>(cy.o_out + oa + col) =
            dead_a ? make_float2(0.f, 0.f) : make_float2(o[4 * j], o[4 * j + 1]);
      if (in_b)
        *reinterpret_cast<float2*>(cy.o_out + ob + col) =
            dead_b ? make_float2(0.f, 0.f) : make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (t4 == 0) {
      if (in_a) {
        cy.m_out[ra] = m_a;
        cy.l_out[ra] = dead_a ? 0.f : l_a;
      }
      if (in_b) {
        cy.m_out[rb] = m_b;
        cy.l_out[rb] = dead_b ? 0.f : l_b;
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v,
                       const Carry& cy, int B, int H, int KVH, int Lq, int Lk,
                       int causal, int q_off, int k_off, const int64_t* s,
                       float scale, cudaStream_t stream) {
  using F = Ring<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_tile_map<T>(&q_map, q, B, Lq, H, D, s[0], s[1], s[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, k, B, Lk, KVH, D, s[3], s[4], s[5], BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, v, B, Lk, KVH, D, s[6], s[7], s[8], BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ring_step_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H);
  ring_step_tma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      q_map, k_map, v_map, cy, H, KVH, Lq, Lk, causal, q_off, k_off, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA kernel: f32 at every head dim, bf16 and f16 at Dh = 256 and 512 (two lanes
// per query row, tiles in shared memory as f32; FmaTiles in
// flash_common.cuh).  A head dim of nc * D (nc > 1: above the widest build,
// padded to a multiple of it, the carried o with it) is split into nc
// chunks of D columns, one per blockIdx.z, as the forward's f32 kernel
// (flash_fwd.cu::flash_fwd_simt) splits its own: every chunk's block forms
// S = sum_c Q_c K_c^T in chunk order and runs the same online softmax from
// the same carried m and l, and folds only its own chunk of o (P V_c);
// chunk 0 writes m_out and l_out, which no block reads (the carry comes in
// through m_in, l_in).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(FmaTiles<D>::THREADS, 1)
ring_step_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ o_in,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ o_out, float* __restrict__ m_out,
              float* __restrict__ l_out, int H, int KVH, int Lq, int Lk,
              int q_off, int k_off, int causal, int nc, int64_t q_sb, int64_t q_sl,
              int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
              int64_t v_sb, int64_t v_sl, int64_t v_sh, float scale) {
  using F = FmaTiles<D>;
  constexpr int T_LD = F::T_LD, S_LD = F::S_LD, O_LD = F::O_LD;
  constexpr int HALF = F::HALF, HK = F::HK, BQ = F::BQ, BK = F::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * T_LD;
  float* Vs = Ks + BK * T_LD;
  float* Ss = Vs + BK * T_LD;
  float* Os = Ss + BQ * S_LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x) * BQ;
  const int ch = blockIdx.z;  // this block's chunk of o's columns
  const int64_t W = int64_t(nc) * D;  // the full (padded) head dim
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  if (nc == 1) load_tile_fma<T, D>(Qs, qb, q_sl, q0, BQ, Lq, tid, F::THREADS);
  // the output accumulator starts from the carried o (this block's chunk)
  constexpr int VPR = D / 4;
  for (int i = tid; i < BQ * VPR; i += F::THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int row = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < Lq)
      val = *reinterpret_cast<const float4*>(
          o_in + ((int64_t(b) * Lq + row) * H + h) * W + ch * D + c);
    *reinterpret_cast<float4*>(Os + r * O_LD + c) = val;
  }

  // lane pair (2r, 2r+1) owns row r of its warp: half the keys, half of Dh
  const int r = lane >> 1, half = lane & 1;
  const int wrow = warp * 16 + r;
  const int qrow = q0 + wrow;
  const int qpos = q_off + qrow;
  float* srow = Ss + wrow * S_LD + half * HK;
  float* orow = Os + wrow * O_LD + half * HALF;
  const int64_t rr = int64_t(bh) * Lq + qrow;
  float m_i = qrow < Lq ? m_in[rr] : -INFINITY;
  float l_i = qrow < Lq ? l_in[rr] : 0.f;

  const int n_tiles =
      visible_tiles(Lk, BK, causal, q_off, k_off, min(q0 + BQ, Lq) - 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float sv[HK];
#pragma unroll
    for (int c = 0; c < HK; ++c) sv[c] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous chunk or tile is consumed
      if (nc > 1) load_tile_fma<T, D>(Qs, qb + cc * D, q_sl, q0, BQ, Lq, tid, F::THREADS);
      load_tile_fma<T, D>(Ks, kb + cc * D, k_sl, k0, BK, Lk, tid, F::THREADS);
      if (cc == nc - 1)
        load_tile_fma<T, D>(Vs, vb + ch * D, v_sl, k0, BK, Lk, tid, F::THREADS);
      __syncthreads();

      const float* qr = Qs + wrow * T_LD;
      const float* kr = Ks + half * HK * T_LD;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d];
#pragma unroll
        for (int c = 0; c < HK; ++c) sv[c] = fmaf(qv, kr[c * T_LD + d], sv[c]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < HK; ++c) {
      const int j = k0 + half * HK + c;
      const bool ok = j < Lk && (!causal || qpos >= k_off + j);  // global positions
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
      srow[c] = round_to<T>(p);  // p cast to v's dtype (flash.py:271-273)
      sum += p;                  // l sums the f32 p
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = m_i == -INFINITY ? 0.f : expf(m_i - m_safe);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    __syncwarp();  // p of both halves of the row is in Ss

    const float* prow = Ss + wrow * S_LD;
    for (int c0 = 0; c0 < HALF; c0 += F::PV) {
      float acc[F::PV];
#pragma unroll
      for (int dd = 0; dd < F::PV; ++dd) acc[dd] = orow[c0 + dd] * alpha;
      for (int j = 0; j < BK; ++j) {
        const float p = prow[j];
        const float* vr = Vs + j * T_LD + half * HALF + c0;
#pragma unroll
        for (int dd = 0; dd < F::PV; ++dd) acc[dd] = fmaf(p, vr[dd], acc[dd]);
      }
#pragma unroll
      for (int dd = 0; dd < F::PV; ++dd) orow[c0 + dd] = acc[dd];
    }
  }
  __syncthreads();  // with no tile at all, Os holds the carry as loaded

  if (qrow < Lq) {
    const bool dead = m_i == -INFINITY;  // saw no key: m = -inf, l = 0, o = 0
    float* dst = o_out + ((int64_t(b) * Lq + qrow) * H + h) * W + ch * D + half * HALF;
#pragma unroll 8
    for (int dd = 0; dd < HALF; ++dd) dst[dd] = dead ? 0.f : orow[dd];
    if (half == 0 && ch == 0) {
      m_out[rr] = m_i;
      l_out[rr] = dead ? 0.f : l_i;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const float* o_in, const float* m_in, const float* l_in,
                       float* o_out, float* m_out, float* l_out, int B, int H,
                       int KVH, int Lq, int Lk, int q_off, int k_off, int causal,
                       int nc, const int64_t* s, float scale, cudaStream_t stream) {
  using F = FmaTiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ring_step_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H, nc);
  ring_step_fma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o_in, m_in, l_in, o_out, m_out, l_out, H,
      KVH, Lq, Lk, q_off, k_off, causal, nc, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Lq, H, D], k/v: [B, Lk, KVH, D] with element strides (batch,
// length, head) each and a contiguous head dim; the carry in and out:
// contiguous o [B, Lq, H, D] f32 and m, l [B, H, Lq] f32 (out must not alias
// in).  q_off/k_off: the chunks' global positions.  dtype: 0 = f32,
// 1 = bf16, 2 = f16 (the 16-bit types take TMA at D = 64 and 128: 16-byte
// aligned bases and strides).  D: 64, 128, 256, 512 or a multiple of 512
// (the wrapper pads other head dims); bf16 and f16 at 256 and 512, and f32
// at every D, take the FMA kernel, and a multiple of 512 runs its 512-wide
// build split into D / 512 chunks of o's columns.  *route is set to the
// kernel launched (0 = ring_step_tma, 1 = ring_step_fma).  Returns a
// cudaError_t (0 = launched).
extern "C" int tfs_flash_ring_step(const void* q, const void* k, const void* v,
                                   const float* o_in, const float* m_in,
                                   const float* l_in, float* o_out,
                                   float* m_out, float* l_out, int B, int H,
                                   int KVH, int Lq, int Lk, int D, int dtype,
                                   int causal, int q_off, int k_off,
                                   const int64_t* strides, float scale,
                                   void* stream, int* route) {
  if (B * H > 65535 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Carry carry{o_in, m_in, l_in, o_out, m_out, l_out};
  int nc;
  const int W = chunk_width(D, &nc);
#define TFS_RING_TMA(T, DD)                                                    \
  do {                                                                         \
    *route = 0;                                                                \
    return int(launch_tma<T, DD>(q, k, v, carry, B, H, KVH, Lq, Lk, causal,    \
                                 q_off, k_off, strides, scale, st));           \
  } while (0)
#define TFS_RING_FMA(T, DD)                                                     \
  do {                                                                          \
    *route = 1;                                                                 \
    return int(launch_fma<T, DD>(q, k, v, o_in, m_in, l_in, o_out, m_out, l_out, \
                                 B, H, KVH, Lq, Lk, q_off, k_off, causal, nc,    \
                                 strides, scale, st));                           \
  } while (0)
  if (dtype == 1 && W == 64) TFS_RING_TMA(bf16, 64);
  if (dtype == 1 && W == 128) TFS_RING_TMA(bf16, 128);
  if (dtype == 1 && W == 256) TFS_RING_FMA(bf16, 256);
  if (dtype == 1 && W == 512) TFS_RING_FMA(bf16, 512);
  if (dtype == 2 && W == 64) TFS_RING_TMA(f16, 64);
  if (dtype == 2 && W == 128) TFS_RING_TMA(f16, 128);
  if (dtype == 2 && W == 256) TFS_RING_FMA(f16, 256);
  if (dtype == 2 && W == 512) TFS_RING_FMA(f16, 512);
  if (dtype == 0 && W == 64) TFS_RING_FMA(float, 64);
  if (dtype == 0 && W == 128) TFS_RING_FMA(float, 128);
  if (dtype == 0 && W == 256) TFS_RING_FMA(float, 256);
  if (dtype == 0 && W == 512) TFS_RING_FMA(float, 512);
#undef TFS_RING_TMA
#undef TFS_RING_FMA
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
