// One ring-attention hop for Hopper (sm_90a).
//
// Replaces tensorframes_tpu/parallel/flash.py::_ring_step_kernel, the Pallas
// TPU kernel launched by flash_ring_step (pallas_call at flash.py:344) on
// every forward hop of ring attention (attn_impl="ring_flash").  It folds
// one K/V chunk into the carried online-softmax state of a query chunk:
// per query row the running max m, the denominator l and the f32 numerator
// o, all read from device memory and written back WITHOUT the final 1/l and
// without forming a logsumexp -- the next hop continues from them.  The
// causal mask uses global positions, q_off + row >= k_off + col.  Two
// kernels, by element type, as the forward (flash_fwd.cu) has:
//  * ring_step_tma<T, D>, bf16 and f16 at every head dim, on TMA + wgmma:
//    the narrow body (ring_narrow) at D = 64, 128 and 256, the wide body
//    (ring_wide) at D = 512 and every multiple of it;
//  * ring_step_simt<float, D>, f32 at every head dim: exact f32 FMAs on
//    register tiles (TF32 would lose precision the JAX reference keeps).
//
// What bounds them on the H100, at the flagship chunk (B=8, C=2048, H=16,
// Dh=64, bf16): the carry makes every hop read and write an f32
// [B, C, H, Dh] o (134 MB) beside 100 MB of q/k/v, so
//  * the diagonal hop (q_off == k_off, half the pairs) is bound by bytes:
//    ~0.071 ms at 3.35 TB/s against 0.0695 ms of operations;
//  * an off-diagonal hop (every pair visible) is bound by operations:
//    137 GFLOP, 0.139 ms at 989 TFLOP/s (2.05 ms in f32 at the FMA pipe's
//    67 TFLOP/s), whatever the head dim at the same d_model.
// The carry stays f32 (JAX carries f32); nothing is saved by rounding it.
//
// Both 16-bit bodies are the forward's (flash_fwd.cu::fwd_narrow and
// ::fwd_wide; building blocks in hopper.cuh) with the carry and the
// offsets:
//  * The narrow body.  One CTA owns one (batch*head, query tile).  One
//    thread issues the TMA loads, Q once, then K and V tiles of the chunk
//    into a ring of STAGES slots guarded by full and empty mbarriers; the
//    consumer warpgroups hold 64 query rows each.  At Dh 64 and 128 the
//    loads come from a producer warpgroup whose registers setmaxnreg moves
//    to the consumers (three at Dh = 64: 192-query tiles; two at 128), with
//    128-key tiles.  At Dh 256 a consumer needs ~200 registers, above the
//    168 a thread of a 384-thread CTA can have: the CTA is the two consumer
//    warpgroups alone, thread 0 refills the 2-stage ring at the top of each
//    step, the key tiles are 64 keys (32 KB a K or V tile beside the 64 KB
//    Q tile), and O += P V is two m64n128k16 products.
//  * S = Q K^T is wgmma (m64n128k16, m64n64k16 at 64-key tiles) with both
//    operands in 128B-swizzled shared memory (K-major); O += P V is wgmma
//    with P in registers, cast to T straight from the S accumulator, and V
//    read MN-major through the transpose bit.  Each consumer warpgroup runs
//    its tile loop on its own, so one's softmax overlaps the others'
//    products.
//  * The wide body (Dh 512; above it, nc = Dh / 512 chunks): a CTA is two
//    consumer warpgroups of 64 query rows with no producer warpgroup (an O
//    of 64 rows x 256 columns is 128 registers a thread), and owns 256
//    output columns: grid axis x runs over (query tile, 256-column chunk
//    z), a tile's chunks neighbours in the launch order so that they share
//    Q, K and V in L2.  S is reduced over the head dim in 256-column halves
//    streamed through two slots (a Q half of 128 rows and a K half of 64
//    keys each; at Dh 512 the Q halves load with the first tile and stay,
//    above it Q streams beside K), and V's 256 columns of this chunk
//    through a third.  Every chunk's CTA issues the same wgmma sequence on
//    the same tiles from the same carried m and l, so all reach the same S,
//    m, l and P; only chunk 0 writes m_out and l_out.  Thread 0 refills a
//    slot once all 8 warps released it.  Every warpgroup runs every tile
//    (a tile hidden from its rows is masked to add nothing), and each chain
//    of products completes before its slot's release: the forward's wide
//    body skips hidden tiles under a branch on the warpgroup and keeps a
//    commit group in flight across a release, and ptxas serializes its
//    wgmma (C7518); the backward's wide bodies, built this way, are free of
//    it, and so is this one.
//  * The carry in: before its first wait, each consumer thread loads its
//    rows' o (float2 per 8-column block: the wgmma accumulator layout,
//    which is mma.sync's m16n8) straight into the accumulator registers,
//    and m and l into its row registers, so the loads overlap the first
//    TMA loads.  o makes one round trip through device memory per hop,
//    which is the least it can.
//  * m is the running max of the scaled scores, the softmax's own, so a
//    carried m goes in and out unconverted; alpha is exactly 1 while the
//    max holds, so a carry that no key outweighs comes out to f32 rounding.
//  * The carry out, un-normalised: no 1/l, no lse.  A skipped tile would
//    have left a row with a finite max unchanged and zeroed (alpha = 0) a
//    row whose max is -inf, so rows whose max is still -inf at the end
//    store m = -inf, l = 0 and o = 0: exactly what the TPU kernel stores
//    after folding every tile, with no NaN.  A hop hidden from every row of
//    a query tile visits no tile and returns its carry so.
//  * The mask on global positions (delta = q_off - k_off): the tile loop
//    ends at the last key any row of the tile can see (visible_tiles), only
//    tiles that cross the diagonal or the end of the keys are masked, and
//    an off-diagonal hop (k_off + C <= q_off) masks nothing and visits
//    every tile.  Where the query tile is taller than a key tile (the
//    narrow body at Dh 64 and 256), a consumer releases without compute
//    the trailing tiles wholly hidden from its 64 rows (and every tile when
//    its rows are past the end), after the tile's K has landed, so the
//    arrival counts for this use of the slot.
//  * The chunks are read through their strides by the TMA descriptors, so
//    q/k/v may be views; the descriptors bound L per batch and zero-fill,
//    the masks cover keys >= Lk, and rows >= Lq are neither loaded nor
//    stored.  GQA: query head h reads kv head h / (H / KVH).
//  * The forward keeps its own copy of the narrow loop: built from one
//    shared loop, the forward measured 2-4% slower (PERF.md).
//
// The f32 kernel is the forward's SIMT kernel (flash_fwd.cu::flash_fwd_simt,
// its tiling Simt in flash_common.cuh) with the carry: each thread starts
// its 4-row micro-tile of O from the carried o, the softmax threads their
// row's m and l, the mask takes the global offsets, and the tile loop ends
// at the last visible key tile.  Above 512 the 512-wide build runs per
// chunk of o's columns (grid axis z), each chunk's CTA summing S over every
// chunk in chunk order, so all run one softmax; chunk 0 writes m_out and
// l_out.
//
// Numerics kept from the TPU kernel: P is cast to v's dtype before PV
// (flash.py:271-273; the identity in f32), l sums the f32 p, and the
// running max is -inf-safe (flash.py:265-268), so a row that has seen no
// key adds zeros, never NaN.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16 and f16: the TMA + wgmma kernel
// ---------------------------------------------------------------------------

// The softmax step of one key tile (flash.py:258-273) on a consumer
// thread's fragment of S = Q K^T: sc holds its rows row_a and row_b at the
// NS / 4 8-key column blocks from key k0 (the wgmma accumulator layout,
// hopper.cuh).  Masks the keys past Lk and, causal, those that a row's
// global position does not reach (col > row + delta; only in a tile that
// crosses either; wq0 is the warp's first row), updates the running max m
// of the scaled scores and the denominator l, rescales the NP parts of the
// O accumulator, and packs p, cast to T (v's dtype), into pa: the A
// fragments of the 16-key slices of P V, straight from the score
// registers.  The forward's softmax_tile keeps the raw scores' max and
// alpha = 0 on a -inf max; here alpha is exactly 1 while the max holds.
template <typename T, int NS, int NP, int NO>
__device__ __forceinline__ void ring_softmax_tile(float (&sc)[NS], float (&o)[NP][NO],
                                                  uint32_t (&pa)[NS / 8][4], float& m_a,
                                                  float& m_b, float& l_a, float& l_b, int k0,
                                                  int Lk, int causal, int delta, int wq0,
                                                  int row_a, int row_b, int t4, float scale,
                                                  float sl2) {
  constexpr int NT = NS / 4, BK = NT * 8;
  if ((k0 + BK > Lk) || (causal && k0 + BK - 1 > wq0 + delta)) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
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
  // a row's scores are spread over the 4 lanes of its quad
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
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[p][4 * j] *= al_a;
      o[p][4 * j + 1] *= al_a;
      o[p][4 * j + 2] *= al_b;
      o[p][4 * j + 3] *= al_b;
    }
  // p cast to T (v's dtype, flash.py:271-273): the A fragments of the
  // 16-key slices, straight from the score registers
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// The carry of a consumer thread's rows row_a (in_a) and row_b (in_b) at
// the NP parts of NO / 4 8-column blocks from column col0 of rows of
// `width` f32: o into the accumulator fragments (zeros past the end), m and
// l into the row registers
template <int NP, int NO>
__device__ __forceinline__ void carry_in(const Carry& cy, float (&o)[NP][NO], float& m_a,
                                         float& m_b, float& l_a, float& l_b, int64_t oa,
                                         int64_t ob, int64_t ra, int64_t rb, bool in_a,
                                         bool in_b, int col0, int t4) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = col0 + p * (NO * 2) + j * 8 + 2 * t4;
      const float2 xa = in_a ? *reinterpret_cast<const float2*>(cy.o_in + oa + col)
                             : make_float2(0.f, 0.f);
      const float2 xb = in_b ? *reinterpret_cast<const float2*>(cy.o_in + ob + col)
                             : make_float2(0.f, 0.f);
      o[p][4 * j] = xa.x;
      o[p][4 * j + 1] = xa.y;
      o[p][4 * j + 2] = xb.x;
      o[p][4 * j + 3] = xb.y;
    }
  m_a = in_a ? cy.m_in[ra] : -INFINITY;
  m_b = in_b ? cy.m_in[rb] : -INFINITY;
  l_a = in_a ? cy.l_in[ra] : 0.f;
  l_b = in_b ? cy.l_in[rb] : 0.f;
}

// The carry out (flash.py:275-279), not normalised: a row that saw no key
// keeps m = -inf and stores l = 0, o = 0.  m and l only where `ml` (the
// first column chunk of a split head dim).
template <int NP, int NO>
__device__ __forceinline__ void carry_out(const Carry& cy, const float (&o)[NP][NO], float m_a,
                                          float m_b, float l_a, float l_b, int64_t oa,
                                          int64_t ob, int64_t ra, int64_t rb, bool in_a,
                                          bool in_b, int col0, int t4, bool ml) {
  const bool dead_a = m_a == -INFINITY, dead_b = m_b == -INFINITY;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = col0 + p * (NO * 2) + j * 8 + 2 * t4;
      if (in_a)
        *reinterpret_cast<float2*>(cy.o_out + oa + col) =
            dead_a ? make_float2(0.f, 0.f) : make_float2(o[p][4 * j], o[p][4 * j + 1]);
      if (in_b)
        *reinterpret_cast<float2*>(cy.o_out + ob + col) =
            dead_b ? make_float2(0.f, 0.f) : make_float2(o[p][4 * j + 2], o[p][4 * j + 3]);
    }
  if (ml && t4 == 0) {
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

template <int D>
struct Ring {
  // consumer warpgroups of 64 query rows each: three at Dh = 64, two at
  // Dh = 128 and 256, whose O accumulator leaves no registers for a third
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  // keys per K/V tile: 128, and 64 at Dh = 256, where a 128-key K or V
  // tile is 64 KB and beside the 64 KB Q tile not even two stages of them
  // would fit
  static constexpr int BK = D == 256 ? 64 : 128;
  // At Dh = 256 a consumer needs ~200 registers (O alone is 128), above the
  // 168 ptxas allows a thread of a 384-thread CTA whatever setmaxnreg
  // grants (hopper.cuh, regs_dec): the CTA is the two consumer warpgroups
  // alone, and thread 0 refills the ring inline.  Below it a producer
  // warpgroup gives its registers to the consumers: 128 x 24 + 384 x 160 =
  // 64512 = 512 x 126; 128 x 40 + 256 x 232 = 64512 = 384 x 168
  static constexpr bool INLINE_PRODUCER = D == 256;
  static constexpr int THREADS = 128 * (CONSUMERS + (INLINE_PRODUCER ? 0 : 1));
  static constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
  static constexpr int Q_BOX = BQ * 128;  // one 64-column box of the Q tile
  static constexpr int BOX = BK * 128;    // one 64-column box of a K or V tile
  static constexpr int Q_TILE = (D / BOX_COLS) * Q_BOX;
  static constexpr int TILE = (D / BOX_COLS) * BOX;  // one K or V tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  // O += P V as wgmma products of at most 128 output columns (m64n128k16):
  // one at Dh = 64 and 128, two (the first and last two V boxes) at 256
  static constexpr int PV_N = D > 128 ? 128 : D;
  static constexpr int PV_PARTS = D / PV_N;
  // a key tile can lie wholly hidden from a consumer's 64 rows only when
  // the query tile is taller than a key tile: then the consumer releases it
  // without compute
  static constexpr bool RELEASE = BQ > BK;
  // Q; K full, V full and empty per slot
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr size_t SMEM = size_t(Q_TILE) + size_t(TILE) * 2 * STAGES +
                                 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "ring tiles exceed a block's shared memory");
};

// flash_fwd.cu::fwd_narrow holds a second copy of this loop (the same
// roles, ring, barrier phases, masks and early tile release), kept apart
// because one shared loop made the forward 2-4% slower (PERF.md).  A fix to
// any of those here is made there too, and the other way round.  The
// copies differ on purpose only in the prologue and epilogue (carry in and
// out here; 1/l and lse there), the global offsets of the mask, and alpha,
// which here is exactly 1 while the max holds.
template <typename T, int D>
__device__ __forceinline__ void ring_narrow(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                            const CUtensorMap& v_map, const Carry& cy, int H,
                                            int KVH, int Lq, int Lk, int causal, int q_off,
                                            int k_off, float scale) {
  using F = Ring<D>;
  constexpr int S = F::STAGES, BK = F::BK;
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

  // the loads: Q once, and key tile t into slot t % S
  auto load_q = [&] {
    mbar_arrive_expect_tx(q_full, F::Q_TILE);
    for (int x = 0; x < D / BOX_COLS; ++x)
      tma_load(Qs + x * F::Q_BOX, &q_map, q_full, x * BOX_COLS, h, q0, b);
  };
  auto load_kv = [&](int t) {
    const int s = t % S;
    unsigned char* const Kt = ring + 2 * s * F::TILE;
    mbar_arrive_expect_tx(k_full + s, F::TILE);
    for (int x = 0; x < D / BOX_COLS; ++x)
      tma_load(Kt + x * F::BOX, &k_map, k_full + s, x * BOX_COLS, kvh, t * BK, b);
    mbar_arrive_expect_tx(v_full + s, F::TILE);
    for (int x = 0; x < D / BOX_COLS; ++x)
      tma_load(Kt + F::TILE + x * F::BOX, &v_map, v_full + s, x * BOX_COLS, kvh,
               t * BK, b);
  };

  if (!F::INLINE_PRODUCER && threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    regs_dec<F::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      load_q();
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= S) mbar_wait(empty + t % S, (t / S - 1) & 1);  // its last use is done
        load_kv(t);
      }
    }
  } else {
    // a consumer: 64 query rows, 16 per warp
    if constexpr (F::INLINE_PRODUCER) {
      // thread 0 fills the ring's first S slots, and refills slot (t - 1) % S
      // with tile t - 1 + S at the top of step t (below)
      if (threadIdx.x == 0) {
        load_q();
        for (int t = 0; t < min(S, n_tiles); ++t) load_kv(t);
      }
    } else {
      regs_inc<F::CONSUMER_REGS>();
    }
    constexpr int NT = BK / 8;         // 8-key column blocks of S
    constexpr int PT = F::PV_N / 8;    // 8-wide column blocks of one O part
    const int c = threadIdx.x / 128 - (F::INLINE_PRODUCER ? 0 : 1);
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
    const int wg0 = q0 + 64 * c;             // this warpgroup's first row
    const int wq0 = wg0 + 16 * w;            // this warp's first row
    const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
    const bool in_a = row_a < Lq, in_b = row_b < Lq;
    const float sl2 = scale * LOG2E;
    // the carry in, before the first wait so that its loads overlap the
    // first TMA loads: o straight into the accumulator fragments, the
    // running max of the scaled scores and the denominator into this
    // thread's two rows' registers
    const int64_t oa = ((int64_t(b) * Lq + row_a) * H + h) * D;
    const int64_t ob = ((int64_t(b) * Lq + row_b) * H + h) * D;
    const int64_t ra = int64_t(bh) * Lq + row_a, rb = int64_t(bh) * Lq + row_b;
    float o[F::PV_PARTS][PT * 4];
    float m_a, m_b, l_a, l_b;
    carry_in(cy, o, m_a, m_b, l_a, l_b, oa, ob, ra, rb, in_a, in_b, 0, t4);
    // A of S = Q K^T: this warpgroup's 64 rows of the Q tile
    const uint64_t q_desc = sw128_desc(Qs + 64 * c * 128, 16, ATOM_BYTES);
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      if constexpr (F::INLINE_PRODUCER) {
        // every warp is done with tile t - 1 once its slot's empty phase
        // completes (this warp is, being here)
        if (threadIdx.x == 0 && t >= 1 && t - 1 + S < n_tiles) {
          mbar_wait(empty + (t - 1) % S, ((t - 1) / S) & 1);
          load_kv(t - 1 + S);
        }
        __syncwarp();
      }
      const int s = t % S;
      const uint32_t ph = (t / S) & 1;
      const int k0 = t * BK;
      unsigned char* const Kt = ring + 2 * s * F::TILE;
      mbar_wait(k_full + s, ph);
      // rows past the end, or a tile wholly hidden from this warpgroup's
      // rows (the trailing tiles of its loop), add nothing: release the
      // slot, after the K wait so the arrival counts for this use of it
      if (F::RELEASE && (wg0 >= Lq || (causal && k0 > wg0 + 63 + delta))) {
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

      // the online softmax; p cast to T (v's dtype) as P V's A fragments
      uint32_t pa[BK / 16][4];
      ring_softmax_tile<T>(sc, o, pa, m_a, m_b, l_a, l_b, k0, Lk, causal, delta, wq0, row_a,
                           row_b, t4, scale, sl2);

      // O += P V, V MN-major: 16 keys (2048 bytes) per slice; part p of O
      // reads the V boxes of its PV_N columns
      mbar_wait(v_full + s, ph);
      const uint64_t v_desc = sw128_desc(Kt + F::TILE, F::BOX, ATOM_BYTES);
      wgmma_fence();  // o was rescaled and pa written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < F::PV_PARTS; ++p)
          wgmma_rs<T>(o[p], pa[kk],
                      desc_at(v_desc, p * (F::PV_N / BOX_COLS) * F::BOX + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < F::PV_PARTS; ++p) fence_regs(o[p]);
      if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the slot
    }

    carry_out(cy, o, m_a, m_b, l_a, l_b, oa, ob, ra, rb, in_a, in_b, 0, t4, true);
  }
}

template <>
struct Ring<512> {
  static constexpr int CONSUMERS = 2;        // warpgroups of 64 query rows
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int BK = 64;              // keys per tile
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int OW = 256;             // output columns per CTA
  static constexpr int HALF = 256;           // columns of one step of S's reduction
  static constexpr int BOXES = HALF / BOX_COLS;
  static constexpr int Q_BOX = BQ * 128;     // one 64-column box of a Q half
  static constexpr int BOX = BK * 128;       // one 64-column box of a K half or V tile
  static constexpr int Q_HALF = BOXES * Q_BOX;  // 64 KB
  static constexpr int K_HALF = BOXES * BOX;    // 32 KB
  static constexpr int V_TILE = (OW / BOX_COLS) * BOX;  // 32 KB
  // full and empty per half slot, V full and empty
  static constexpr int BARRIERS = 6;
  static constexpr size_t SMEM = 2 * (size_t(Q_HALF) + size_t(K_HALF)) + size_t(V_TILE) +
                                 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "wide ring tiles exceed a block's shared memory");
  static_assert(OW == 2 * 128, "O is two m64n128 products a warpgroup");
};

// The wide body at Dh 512 (nc = 1) and nc x 512 (flash_fwd.cu::fwd_wide's
// loads, slots and refills; every warpgroup runs every tile and each chain
// completes before its release, see the top of the file)
template <typename T>
__device__ __forceinline__ void ring_wide(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                          const CUtensorMap& v_map, const Carry& cy, int H,
                                          int KVH, int Lq, int Lk, int causal, int q_off,
                                          int k_off, float scale, int nc) {
  using F = Ring<512>;
  constexpr int BK = F::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const Qs = atom_aligned(smem_raw);  // half slot s: Q half
  unsigned char* const Ks = Qs + 2 * F::Q_HALF;     // half slot s: K half
  unsigned char* const Vs = Ks + 2 * F::K_HALF;     // this chunk's V columns
  uint64_t* const full = reinterpret_cast<uint64_t*>(Vs + F::V_TILE);
  uint64_t* const empty = full + 2;
  uint64_t* const v_full = empty + 2;
  uint64_t* const v_empty = v_full + 1;

  // NH 256-column halves of the head dim: the steps of S's reduction, and
  // the output chunks, one a CTA; a query tile's chunks are neighbours in
  // the launch order, and causal: the heavier (later) tiles launch first
  const int NH = 2 * nc;
  const int z = blockIdx.x % NH;
  const int n_qt = gridDim.x / NH, qt = blockIdx.x / NH;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (causal ? n_qt - 1 - qt : qt) * F::BQ;
  const int n_tiles = visible_tiles(Lk, BK, causal, q_off, k_off, min(q0 + F::BQ, Lq) - 1);
  const int delta = q_off - k_off;  // a key column is hidden when col > row + delta
  // half j of the stream is half j % NH of tile j / NH, in slot j & 1 (NH
  // is even, so a half keeps its slot from tile to tile)
  const int n_halves = n_tiles * NH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every warp releases a slot
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  // the loads: half j's K columns, with its Q columns where Q streams (nc >
  // 1) or is loaded for good (the first tile); V tile t's columns of this
  // chunk
  auto load_half = [&](int j) {
    const int t = j / NH, hh = j % NH, s = j & 1;
    const bool with_q = nc > 1 || t == 0;
    mbar_arrive_expect_tx(full + s, F::K_HALF + (with_q ? F::Q_HALF : 0));
    for (int x = 0; x < F::BOXES; ++x) {
      const int col = hh * F::HALF + x * BOX_COLS;
      if (with_q) tma_load(Qs + s * F::Q_HALF + x * F::Q_BOX, &q_map, full + s, col, h, q0, b);
      tma_load(Ks + s * F::K_HALF + x * F::BOX, &k_map, full + s, col, kvh, t * BK, b);
    }
  };
  auto load_v = [&](int t) {
    mbar_arrive_expect_tx(v_full, F::V_TILE);
    for (int x = 0; x < F::OW / BOX_COLS; ++x)
      tma_load(Vs + x * F::BOX, &v_map, v_full, z * F::OW + x * BOX_COLS, kvh, t * BK, b);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {  // a hidden hop loads nothing
    load_half(0);
    load_half(1);  // n_halves >= NH >= 2
    load_v(0);
  }

  const int c = threadIdx.x / 128;  // this warpgroup: rows 64 c .. 64 c + 63
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wq0 = q0 + 64 * c + 16 * w;
  const int row_a = wq0 + g, row_b = row_a + 8;
  const bool in_a = row_a < Lq, in_b = row_b < Lq;

  // this warp is done with half j (V tile t): release its slot; thread 0
  // refills it with half j + 2 (V tile t + 1) once all 8 warps have.  The
  // warps it waits for need only loads issued before (half j + 1 and V tile
  // t were issued at the releases of half j - 1 and V tile t - 1), so the
  // wait ends.
  auto release_half = [&](int j) {
    if (lane == 0) mbar_arrive(empty + (j & 1));
    if (threadIdx.x == 0 && j + 2 < n_halves) {
      mbar_wait(empty + (j & 1), (j >> 1) & 1);
      load_half(j + 2);
    }
    __syncwarp();
  };
  auto release_v = [&](int t) {
    if (lane == 0) mbar_arrive(v_empty);
    if (threadIdx.x == 0 && t + 1 < n_tiles) {
      mbar_wait(v_empty, t & 1);
      load_v(t + 1);
    }
    __syncwarp();
  };

  constexpr int NT = BK / 8;   // 8-key column blocks of S
  constexpr int PT = 128 / 8;  // 8-column blocks of one O part (m64n128)
  const float sl2 = scale * LOG2E;
  // the carry in: this chunk's 256 columns of o, before the first wait
  const int64_t width = int64_t(NH) * F::OW;
  const int64_t oa = ((int64_t(b) * Lq + row_a) * H + h) * width;
  const int64_t ob = ((int64_t(b) * Lq + row_b) * H + h) * width;
  const int64_t ra = int64_t(bh) * Lq + row_a, rb = int64_t(bh) * Lq + row_b;
  float o[2][PT * 4];
  float m_a, m_b, l_a, l_b;
  carry_in(cy, o, m_a, m_b, l_a, l_b, oa, ob, ra, rb, in_a, in_b, z * F::OW, t4);
  // A of S = Q K^T: this warpgroup's 64 rows of a Q half
  const uint64_t q_desc = sw128_desc(Qs + 64 * c * 128, 16, ATOM_BYTES);
  const uint64_t k_desc = sw128_desc(Ks, 16, ATOM_BYTES);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // S = Q K^T over the NH halves in order, each half's chain complete
    // before its slot is released
    float sc[NT * 4];
    for (int hh = 0; hh < NH; ++hh) {
      const int j = t * NH + hh, s = j & 1;
      mbar_wait(full + s, (j >> 1) & 1);
      const uint64_t a_desc = desc_at(opaque(q_desc), s * F::Q_HALF);
      const uint64_t b_desc = desc_at(k_desc, s * F::K_HALF);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::HALF / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(sc, desc_at(a_desc, (kk / 4) * F::Q_BOX + off),
                    desc_at(b_desc, (kk / 4) * F::BOX + off), hh | kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release_half(j);
    }

    // the online softmax; p cast to T (v's dtype) as P V's A fragments
    uint32_t pa[BK / 16][4];
    ring_softmax_tile<T>(sc, o, pa, m_a, m_b, l_a, l_b, k0, Lk, causal, delta, wq0, row_a,
                         row_b, t4, scale, sl2);

    // O += P V over this chunk's 256 columns, V MN-major: 16 keys (2048
    // bytes) per slice; part p reads the two V boxes of its 128 columns
    mbar_wait(v_full, t & 1);
    const uint64_t v_desc = sw128_desc(Vs, F::BOX, ATOM_BYTES);
    wgmma_fence();  // o was rescaled and pa written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        wgmma_rs<T>(o[p], pa[kk], desc_at(v_desc, p * 2 * F::BOX + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < 2; ++p) fence_regs(o[p]);
    release_v(t);
  }

  // the carry out: this chunk's columns of o; chunk 0 writes m and l
  carry_out(cy, o, m_a, m_b, l_a, l_b, oa, ob, ra, rb, in_a, in_b, z * F::OW, t4, z == 0);
}

// The 16-bit ring step: the narrow body at Dh 64, 128 and 256, the wide one
// at 512 (nc chunks of 512 columns: the head dim is 512 nc)
template <typename T, int D>
__global__ void __launch_bounds__(Ring<D>::THREADS, 1)
ring_step_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const Carry cy,
              int H, int KVH, int Lq, int Lk, int causal, int q_off,
              int k_off, float scale, int nc) {
  if constexpr (D == 512)
    ring_wide<T>(q_map, k_map, v_map, cy, H, KVH, Lq, Lk, causal, q_off, k_off, scale, nc);
  else
    ring_narrow<T, D>(q_map, k_map, v_map, cy, H, KVH, Lq, Lk, causal, q_off, k_off, scale);
}

template <typename T, int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v,
                       const Carry& cy, int B, int H, int KVH, int Lq, int Lk,
                       int causal, int q_off, int k_off, int nc, const int64_t* s,
                       float scale, cudaStream_t stream) {
  using F = Ring<D>;
  const int width = D * nc;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_tile_map<T>(&q_map, q, B, Lq, H, width, s[0], s[1], s[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, k, B, Lk, KVH, width, s[3], s[4], s[5], F::BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, v, B, Lk, KVH, width, s[6], s[7], s[8], F::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ring_step_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  // the wide body: one CTA a (query tile, 256-column chunk of o)
  const int chunks = D == 512 ? width / 256 : 1;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ * chunks, B * H);
  ring_step_tma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      q_map, k_map, v_map, cy, H, KVH, Lq, Lk, causal, q_off, k_off, scale, nc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the register-tiled SIMT kernel
// ---------------------------------------------------------------------------

// flash_fwd.cu::flash_fwd_simt with the carry (see the top of the file);
// the tiling is Simt (flash_common.cuh).  A fix to the loop there is made
// here too, and the other way round.
template <typename T, int D>
__global__ void __launch_bounds__(Simt<D>::THREADS, D >= 512 ? 1 : 2)
ring_step_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const Carry cy, int H, int KVH, int Lq, int Lk,
               int causal, int q_off, int k_off, int nc, int64_t q_sb, int64_t q_sl,
               int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
               int64_t v_sl, int64_t v_sh, float scale) {
  static_assert(std::is_same_v<T, float>, "the SIMT ring step is the f32 kernel");
  using F = Simt<D>;
  constexpr int BQ = F::BQ, BK = F::BK, G = F::G, LD = F::LD;
  extern __shared__ __align__(16) float smem_f[];
  float* const Qs = smem_f;
  float* const Ks = Qs + BQ * LD;
  float* const Vs = Ks + BK * LD;
  float* const Ss = Vs + BK * LD;
  float* const Pt = Ss + BQ * F::LDS;
  float* const alpha_s = Pt + BK * F::LDP;
  float* const m_s = alpha_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int z = blockIdx.z;  // this block's chunk of o's columns
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;
  const int n_tiles = visible_tiles(Lk, BK, causal, q_off, k_off, min(q0 + BQ, Lq) - 1);
  const int delta = q_off - k_off;  // a key column is hidden when col > row + delta

  // rows [row0, row0 + rows) of a [L, .] slice with row stride s_l, the
  // columns [col, col + D), into rows of LD floats (zeros past L)
  auto load_rows = [&](float* dst, const float* base, int64_t s_l, int row0,
                       int rows, int L, int col) {
    constexpr int CPR = D / 4;
    for (int i = tid; i < rows * CPR; i += F::THREADS) {
      const int r = i / CPR, c4 = (i % CPR) * 4;
      const bool ok = row0 + r < L;
      cp_async16(dst + r * LD + c4, base + (ok ? (row0 + r) * s_l : 0) + col + c4, ok);
    }
  };

  // S: this thread's rows rg + i NRG, keys kg + j NKG, split gs of G
  const int gs = lane % G;
  const int kg = (warp % F::NK_HI) * F::NK_LO + (lane / G) % F::NK_LO;
  const int rg = (warp / F::NK_HI) * F::NR_LO + lane / (G * F::NK_LO);
  // the softmax: row sr, keys lr + RT kk
  const int sr = tid / F::RT, lr = tid % F::RT;
  // O: rows orow .. orow + 3, column chunks ocg + NCG m
  const int orow = 4 * ((warp / F::NC_HI) * 4 + lane / 8);
  const int ocg = (warp % F::NC_HI) * 8 + lane % 8;

  // the carry in: this thread's rows and chunk of o (zeros past the end),
  // and row sr's running max of the scaled scores and denominator.  Its
  // offsets pass through opaque() (hopper.cuh), so that none is shared
  // with the epilogue's and held across the tile loop: up to D = 256 the
  // kernel has 128 registers a thread, and one more live value spills
  float4 o[4][F::CH];
  const int64_t o_row = ((int64_t(b) * Lq + q0 + orow) * H + h) * nc * D;
  const float* const o_src =
      cy.o_in + int64_t(opaque(uint64_t(o_row))) + z * D + 4 * ocg;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < F::CH; ++m)
      o[i][m] = q0 + orow + i < Lq
                    ? *reinterpret_cast<const float4*>(o_src + int64_t(i) * H * nc * D +
                                                       4 * F::NCG * m)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t ml_row = int64_t(opaque(uint64_t(int64_t(bh) * Lq + q0 + sr)));
  float m_i = q0 + sr < Lq ? cy.m_in[ml_row] : -INFINITY;
  float l_i = q0 + sr < Lq ? cy.l_in[ml_row] : 0.f;

  load_rows(Qs, qb, q_sl, q0, BQ, Lq, 0);
  load_rows(Ks, kb, k_sl, 0, BK, Lk, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // S = Q K^T, chunk by chunk of D columns in order (one chunk unless the
    // head dim is split), every chunk's block alike
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      cp_async_wait<0>();  // this chunk's K (and Q) tile
      __syncthreads();     // ... from every thread; and P V of tile t - 1 is done
      if (cc == 0) {       // so V's tile is free: tile t loads behind S
        load_rows(Vs, vb, v_sl, k0, BK, Lk, z * D);
        cp_async_commit();
      }
#pragma unroll(D >= 512 ? 4 : 1)
      for (int n = 0; n < D / (4 * G); ++n) {
        const int d = 4 * (gs + G * n);
        float4 a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qs + (rg + i * F::NRG) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kk[j] = *reinterpret_cast<const float4*>(Ks + (kg + j * F::NKG) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i].x, kk[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, kk[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, kk[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, kk[j].w, acc[i][j]);
          }
      }
      if (cc + 1 < nc) {
        __syncthreads();  // every thread is done with chunk cc's Q and K
        load_rows(Qs, qb, q_sl, q0, BQ, Lq, (cc + 1) * D);
        load_rows(Ks, kb, k_sl, k0, BK, Lk, (cc + 1) * D);
        cp_async_commit();
      }
    }
    // the G partial sums, by a butterfly: every lane ends with the same sum
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j % G == gs) Ss[(rg + i * F::NRG) * F::LDS + kg + j * F::NKG] = acc[i][j];
    __syncthreads();  // S is whole; K's tile is free: tile t + 1 loads behind the softmax and P V
    if (t + 1 < n_tiles) {
      if (nc > 1) load_rows(Qs, qb, q_sl, q0, BQ, Lq, 0);
      load_rows(Ks, kb, k_sl, k0 + BK, BK, Lk, 0);
      cp_async_commit();
    }

    // the online softmax of row sr (flash.py:258-270), on global positions
    {
      const int qrow = q0 + sr;
      float sv[BK / F::RT];
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < BK / F::RT; ++kk) {
        const int col = lr + F::RT * kk, j = k0 + col;
        const bool ok = j < Lk && (!causal || j <= qrow + delta);
        sv[kk] = ok ? Ss[sr * F::LDS + col] * scale : -INFINITY;
        mx = fmaxf(mx, sv[kk]);
      }
#pragma unroll
      for (int off = 1; off < F::RT; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / F::RT; ++kk) {
        const float p = expf(sv[kk] - m_safe);
        Pt[(lr + F::RT * kk) * F::LDP + sr] = p;  // f32 p: its cast to v's dtype is exact
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < F::RT; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // exactly 1 while the max holds (expf(0) = 1)
      const float alpha = m_i == -INFINITY ? 0.f : expf(m_i - m_safe);
      l_i = alpha * l_i + sum;
      m_i = m_new;
      if (lr == 0) alpha_s[sr] = alpha;
    }
    if (t + 1 < n_tiles)
      cp_async_wait<1>();  // V of tile t (tile t + 1's K may stay in flight)
    else
      cp_async_wait<0>();
    __syncthreads();  // V, P and alpha from every thread

    // O = alpha O + P V
    const float4 al = *reinterpret_cast<const float4*>(alpha_s + orow);
#pragma unroll
    for (int m = 0; m < F::CH; ++m) {
      o[0][m].x *= al.x; o[0][m].y *= al.x; o[0][m].z *= al.x; o[0][m].w *= al.x;
      o[1][m].x *= al.y; o[1][m].y *= al.y; o[1][m].z *= al.y; o[1][m].w *= al.y;
      o[2][m].x *= al.z; o[2][m].y *= al.z; o[2][m].z *= al.z; o[2][m].w *= al.z;
      o[3][m].x *= al.w; o[3][m].y *= al.w; o[3][m].z *= al.w; o[3][m].w *= al.w;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * F::LDP + orow);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int m = 0; m < F::CH; ++m) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * LD + 4 * (ocg + F::NCG * m));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][m].x = fmaf(pr[i], vv.x, o[i][m].x);
          o[i][m].y = fmaf(pr[i], vv.y, o[i][m].y);
          o[i][m].z = fmaf(pr[i], vv.z, o[i][m].z);
          o[i][m].w = fmaf(pr[i], vv.w, o[i][m].w);
        }
      }
    }
  }
  cp_async_wait<0>();  // (no tile at all: the prologue's loads)

  // the carry out (flash.py:275-279), not normalised: a row that saw no
  // key keeps m = -inf and stores l = 0, o = 0; chunk 0 writes m and l
  if (lr == 0) m_s[sr] = m_i;
  if (lr == 0 && z == 0 && q0 + sr < Lq) {
    cy.m_out[int64_t(bh) * Lq + q0 + sr] = m_i;
    cy.l_out[int64_t(bh) * Lq + q0 + sr] = m_i == -INFINITY ? 0.f : l_i;
  }
  __syncthreads();
  const int64_t width = int64_t(nc) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + orow + i;
    if (row >= Lq) continue;
    const bool dead = m_s[orow + i] == -INFINITY;
    float* dst = cy.o_out + ((int64_t(b) * Lq + row) * H + h) * width + z * D;
#pragma unroll
    for (int m = 0; m < F::CH; ++m)
      *reinterpret_cast<float4*>(dst + 4 * (ocg + F::NCG * m)) =
          dead ? make_float4(0.f, 0.f, 0.f, 0.f) : o[i][m];
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const Carry& cy,
                        int B, int H, int KVH, int Lq, int Lk, int causal, int q_off,
                        int k_off, int nc, const int64_t* s, float scale,
                        cudaStream_t stream) {
  using F = Simt<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ring_step_simt<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H, nc);
  ring_step_simt<float, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), cy, H, KVH, Lq, Lk, causal, q_off, k_off, nc, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Lq, H, D], k/v: [B, Lk, KVH, D] with element strides (batch,
// length, head) each and a contiguous head dim; the carry in and out:
// contiguous o [B, Lq, H, D] f32 and m, l [B, H, Lq] f32 (out must not alias
// in).  q_off/k_off: the chunks' global positions.  dtype: 0 = f32,
// 1 = bf16, 2 = f16 (the 16-bit types: TMA, so 16-byte aligned bases and
// strides).  D: 64, 128, 256, 512 or a multiple of 512 (the wrapper pads
// other head dims), a multiple of 512 running the 512-wide build split
// into D / 512 chunks of o's columns.  *route is set to the kernel
// launched (0 = ring_step_tma, 2 = ring_step_simt; 1 is retired).  Returns
// a cudaError_t (0 = launched).
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
#define TFS_RING_TMA(T, DD)                                                        \
  return *route = 0, int(launch_tma<T, DD>(q, k, v, carry, B, H, KVH, Lq, Lk, causal, \
                                           q_off, k_off, nc, strides, scale, st))
#define TFS_RING_SIMT(DD)                                                          \
  return *route = 2, int(launch_simt<DD>(q, k, v, carry, B, H, KVH, Lq, Lk, causal,   \
                                         q_off, k_off, nc, strides, scale, st))
  if (dtype == 1 && W == 64) TFS_RING_TMA(bf16, 64);
  if (dtype == 1 && W == 128) TFS_RING_TMA(bf16, 128);
  if (dtype == 1 && W == 256) TFS_RING_TMA(bf16, 256);
  if (dtype == 1 && W == 512) TFS_RING_TMA(bf16, 512);
  if (dtype == 2 && W == 64) TFS_RING_TMA(f16, 64);
  if (dtype == 2 && W == 128) TFS_RING_TMA(f16, 128);
  if (dtype == 2 && W == 256) TFS_RING_TMA(f16, 256);
  if (dtype == 2 && W == 512) TFS_RING_TMA(f16, 512);
  if (dtype == 0 && W == 64) TFS_RING_SIMT(64);
  if (dtype == 0 && W == 128) TFS_RING_SIMT(128);
  if (dtype == 0 && W == 256) TFS_RING_SIMT(256);
  if (dtype == 0 && W == 512) TFS_RING_SIMT(512);
#undef TFS_RING_TMA
#undef TFS_RING_SIMT
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
