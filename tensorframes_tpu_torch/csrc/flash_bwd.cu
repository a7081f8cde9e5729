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
// operations, i.e. by the tensor-core rate (which only wgmma reaches) and
// how well the loops keep the tensor cores fed.
//
// Two pairs of kernels, by element type:
//  * flash_bwd_dq_tma<T, D> and flash_bwd_dkv_tma<T, D>, bf16 and f16 at
//    every head dim, on TMA + wgmma: the narrow bodies (dq_narrow,
//    dkv_narrow) at D = 64, 128 and 256, the wide bodies (dq_wide,
//    dkv_wide) at D = 512 and every multiple of it;
//  * flash_bwd_dq_simt<float, D> and flash_bwd_dkv_simt<float, D>, f32 at
//    every head dim: register-tiled SIMT kernels of exact f32 FMAs (TF32
//    would lose precision the JAX reference keeps), flash_fwd.cu's
//    flash_fwd_simt carried over to the gradients (SimtBwd below).
// In all of them the TPU grid's sequential axis becomes a loop inside one
// CTA, so nothing carries between blocks and nothing needs atomics: the
// results are deterministic.
//
// The narrow bodies (building blocks in hopper.cuh):
//  * dQ: one CTA owns one (batch*head, query tile of 64 rows per consumer
//    warpgroup).  The producer warpgroup loads the Q and dO tiles once by
//    TMA, then
//    streams the 64-key K and V tiles of kv head h / (H / KVH), from key 0
//    to the diagonal, through a 4-slot ring of full/empty mbarriers;
//    setmaxnreg moves its registers to the consumer warpgroups of 64 query
//    rows (three at Dh = 64, two at Dh = 128), which load their rows' lse
//    and D before the first wait.  At Dh = 256 dQ alone takes 128 f32
//    registers a thread, over the 168 ptxas gives a thread of a 384-thread
//    CTA: there the CTA is the two consumer warpgroups (256 threads, 222
//    registers), thread 0 refills the ring inline, the 64-key K/V tiles
//    have a single stage beside the 128-row Q and dO tiles (193 KB in
//    all; three stages of 32-key tiles measured slower), and dQ += dS K
//    is two m64n128k16 products, one per half of dQ's columns.
//    Per tile a consumer computes S = Q K^T and dP = dO V^T (wgmma, both
//    operands K-major in shared memory),
//    P = exp2(S * scale * log2(e) - lse * log2(e)) and dS = P o (dP - D) in
//    registers, then dQ += dS K with dS as the register A operand (the
//    accumulator layout is the A fragment's) and K read MN-major through
//    the transpose bit: the same shared-memory tile S read, no second
//    load.  dQ stays in f32 registers to the end and is scaled and stored
//    once.  S and dP of 64 x 128 beside dQ spilled at Dh = 64, so the key
//    tiles are 64 wide, and at that width a third consumer fits (160
//    registers) and was faster; the designs tried and their times are in
//    PERF.md (chip_smoke.py --dq-variants).  A consumer releases without
//    compute the trailing tiles wholly above its rows.  The heavier query
//    tiles launch first, and the tiles of one head side by side so their
//    K/V stay in L2.
//  * dK/dV: one CTA of three warpgroups (two at Dh = 256, see Dkv) owns
//    one (batch*kv head, 128-key tile).
//    The producer warpgroup loads K and V once by TMA, then streams the
//    (Q, dO) tiles of 64 query rows (32 at Dh = 128 and 256) of every
//    (query head of the group, query tile) pair from the diagonal on
//    through a 4-slot ring (3 at Dh = 256) of full/empty mbarriers; one
//    of its warps stages the pairs' lse * log2(e) and D rows beside them.
//    setmaxnreg moves its registers to the two consumer warpgroups of 64
//    keys each.  Per pair a consumer computes
//    S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in shared
//    memory), P^T = exp2(S^T * scale * log2(e) - lse) and
//    dS^T = P^T o (dP^T - D) in registers, then dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T as register A operands (the accumulator
//    layout is the A fragment's) and dO and Q read MN-major through the
//    transpose bit.  dK and dV stay in f32 registers across the whole group
//    (the TPU kernel's VMEM accumulation, flash.py:537-541).  A query tile
//    wholly before a consumer's 64 keys (one per head, two at Dh = 128, when
//    the other consumer's keys reach into it) is masked to 0 rather than
//    skipped, so both consumers walk the same ring.  At Dh = 128, dK and dV
//    of 64 keys would take 128 f32 registers a thread beside the scores,
//    over a consumer's budget: the consumers walk the pairs twice, dV in the
//    first pass and dK in the second, recomputing S^T (a quarter more
//    products) to hold one accumulator.  Dh = 256 keeps that scheme with
//    one accumulator of 128 registers a thread, each product into it two
//    m64n128k16 (one per half of the columns); K and V of the CTA's 128
//    keys take 128 KB and a slot of Q and dO 32 KB, so the ring has 3 slots
//    (226 KB in all).
//    Tried and slower on the H100 at the flagship shape, so not kept:
//    issuing pair n + 1's S^T and dP^T behind pair n's gradient products
//    inside a warpgroup (it also spills), and ping-pong between the two
//    consumers.
//
// The wide bodies (Dh 512, and nc = Dh / 512 chunks above it), the
// forward's wide body (flash_fwd.cu::fwd_wide) carried over to the
// gradients, designed against what a CTA holds:
//  * Registers.  A gradient accumulator of 64 rows x 256 columns is 128 f32
//    registers a thread, over the 168 ptxas gives a thread of a 384-thread
//    CTA: so each CTA is Dh 256's two consumer warpgroups (64 query rows
//    each for dQ, 64 keys each for dK/dV) and no producer warpgroup, and it
//    owns one 256-column chunk z of its output (grid axis x over (tile,
//    chunk), a tile's chunks neighbours in the launch order so that they
//    share their tiles in L2).  dK/dV keeps the two-pass scheme (dV, then
//    dK), so a consumer holds one accumulator beside the 64 x 64 scores
//    (S and dP: 32 + 32 registers).
//  * Shared memory (232,448 bytes a block).  At Dh 512 the Q and dO of 128
//    query rows take 256 KB, and so do the K and V of 128 keys: neither
//    pair fits whole, so nothing stays resident.  S = Q K^T and dP = dO V^T
//    are reduced over Dh in 256-column halves, each a chain of 16 wgmma
//    m64n64k16, from a stream of items through two slots: item 2 hh of a
//    tile is half hh of the row tile and of the streamed tile for S (Q and
//    K for dQ; K and Q for dK/dV, where S^T = K Q^T), item 2 hh + 1 the same
//    half for dP (dO and V; V and dO), so slot 0 always feeds S and slot 1
//    dP.  A slot holds a 128-row half (64 KB) and a 64-row half (32 KB); a
//    third buffer (32 KB) holds the gradient product's own operand: this
//    chunk's 256 columns of K (dQ += dS K_z), or of dO (dV += P^T dO_z,
//    the first pass) and Q (dK += dS^T Q_z, the second).  224 KB in all
//    (plus the lse/D rows of dK/dV's pairs), static_assert'ed.  The dV pass
//    streams only S's items.  dQ's tiles are 128 query rows x 64 keys,
//    dK/dV's 128 keys x 64 query rows.  Above 512 the halves of every
//    512-column chunk stream in chunk order, summing S and dP over all of
//    them.
//  * One softmax across chunks.  Nothing before the gradient product
//    depends on the chunk index: every chunk's CTA issues the same wgmma
//    sequence on the same tiles and gets bit-identical P and dS, rounded
//    at the points the narrow bodies round them.
//  * The ring without a producer warp: thread 0 refills a slot once all 8
//    warps released it (at the point where its own warp releases it), and
//    every load the others wait on was issued before, so its waits end.
//    Every warpgroup runs every item, a tile that the causal mask or an
//    end of the sequences empties for its rows too (the mask zeroes P), and
//    an item's products complete before its release.  A first build that
//    skipped such tiles per warpgroup (the products under a branch on the
//    thread) and kept one commit group in flight across the release had
//    ptxas serialize every wgmma of both kernels (C7518).
//  * What it costs: each chunk recomputes S and dP.  dQ runs 1.67x the
//    least products at Dh 512 (2 x (4 x 512 + 2 x 256) against 6 x 512 per
//    (query, key) pair), dK/dV 2.0x with its two passes; at 1024 3.0x and
//    3.5x.  Every tile step reloads its halves from L2 (Q and dO every key
//    tile for dQ), so the loads, not the products, are the likelier bound.
//
//  * Loads read [B, L, H, Dh] through its strides (no transpose copy; head
//    dims other than 64, 128, 256 and 512 arrive zero-padded to the next of
//    them, or above 512 to a multiple of 512, from the wrapper, which
//    leaves S, dP and D unchanged); ragged tails are zero-filled (by the
//    TMA descriptors, which bound L per batch, or by the copy) and masked
//    here.
// Numerics kept from flash.py: P is cast to dO's dtype before P^T dO (:482)
// and dS to q/k's dtype before its products (:443, :489); the scale is
// applied in f32; a row whose lse is -inf takes lse 0 under the mask and
// never computes exp(finite - (-inf)) (:409-412); the causal mask is
// top-left (q >= k) when Lq != Lk.
// The f32 kernels follow the same numerics (P and dS in f32, the identity
// cast); their design is at SimtBwd below.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tfs_flash;
using namespace tfs_hopper;

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
// bf16 and f16: tensor-core kernels (one template each, T = the element type)
// ---------------------------------------------------------------------------

// dQ: warp-specialised TMA + wgmma kernel
// 128 x 40 + 256 x 232 = 64512 = 384 x 168, the registers the CTA starts with
// (dK/dV's split too)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D>
struct Dq {
  // consumer warpgroups of 64 query rows: three at Dh = 64 (a third fewer
  // K/V reads per query, and measured faster than two), two at Dh = 128
  // and 256
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  // keys per K/V tile: S and dP (64 x BK) and dQ (64 x D) stay in a
  // consumer's f32 registers, BK / 2 + BK / 2 + D / 2 a thread (128 keys
  // spilled at Dh = 64 with two consumers; 222 registers at Dh = 256)
  static constexpr int BK = 64;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  // The producer: a warpgroup before the consumers, whose registers
  // setmaxnreg moves to them.  ptxas allocates a thread no more than its
  // sub-partition's share (168 at 384 threads) whatever setmaxnreg grants,
  // and at Dh = 256 a consumer needs more (dQ alone is 128).  There the CTA
  // is the two consumer warpgroups alone (up to 255 registers a thread),
  // and thread 0 refills the ring inline, as Fwd<256> and Dkv<256> do.
  static constexpr bool INLINE_PRODUCER = D == 256;
  static constexpr int THREADS = 128 * (CONSUMERS + (INLINE_PRODUCER ? 0 : 1));
  // 128 x 24 + 384 x 160 = 64512 with three consumers
  static constexpr int P_REGS = CONSUMERS == 3 ? 24 : PRODUCER_REGS;
  static constexpr int C_REGS = CONSUMERS == 3 ? 160 : CONSUMER_REGS;
  // At Dh = 256 Q and dO take 128 KB, and beside them one 64-key K and V
  // pair (64 KB): a single stage, so each tile's loads wait for the last
  // tile's products.  Three stages of 32-key tiles fit too, and were
  // 13-18% slower on the H100 at the wide-head shape (PERF.md,
  // tools/dq_tile_variant.py)
  static constexpr int STAGES = D == 256 ? 1 : 4;
  // dQ += dS K as wgmma products of at most 128 output columns
  // (m64n128k16): one at Dh = 64 and 128, two at 256
  static constexpr int GN = D > 128 ? 128 : D;
  static constexpr int GP = D / GN;
  static constexpr int Q_BOX = BQ * 128;  // one 64-column box of Q or dO
  static constexpr int Q_TILE = (D / BOX_COLS) * Q_BOX;
  static constexpr int BOX = BK * 128;  // one 64-column box of a K or V tile
  static constexpr int TILE = (D / BOX_COLS) * BOX;
  // Q and dO; K full, V full and empty per slot
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr size_t SMEM = size_t(2) * Q_TILE + size_t(TILE) * 2 * STAGES +
                                 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "dQ tiles exceed a block's shared memory");
};

// dQ at Dh 64, 128 and 256: the narrow body of flash_bwd_dq_tma
template <typename T, int D>
__device__ __forceinline__ void dq_narrow(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                          const CUtensorMap& v_map, const CUtensorMap& o_map,
                                          const Problem& p, T* __restrict__ dq) {
  using F = Dq<D>;
  constexpr int S = F::STAGES, BK = F::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const Qs = atom_aligned(smem_raw);
  unsigned char* const Os = Qs + F::Q_TILE;    // dO
  unsigned char* const ring = Os + F::Q_TILE;  // slot s: K tile, then V tile
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(ring + 2 * S * F::TILE);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + S;
  uint64_t* const empty = v_full + S;

  const int H = p.H, Lq = p.Lq, Lk = p.Lk;
  // the query tiles of one head are neighbours in the launch order, so the
  // CTAs in flight share their heads' K and V in L2; causal: the heavier
  // (later) tiles of a head launch first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / p.KVH);
  const int q0 = int(p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * F::BQ;
  int n_tiles = (Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + F::BQ, Lq) - 1) / BK + 1);

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

  // the loads: Q and dO once, and key tile t into slot t % S
  auto load_q = [&] {
    mbar_arrive_expect_tx(q_full, 2 * F::Q_TILE);
    for (int x = 0; x < D / BOX_COLS; ++x) {
      tma_load(Qs + x * F::Q_BOX, &q_map, q_full, x * BOX_COLS, h, q0, b);
      tma_load(Os + x * F::Q_BOX, &o_map, q_full, x * BOX_COLS, h, q0, b);
    }
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
    // the producer: one thread loads Q and dO once, then keeps the ring of
    // K/V tiles full
    regs_dec<F::P_REGS>();
    if (threadIdx.x == 0) {
      load_q();
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= S) mbar_wait(empty + t % S, (t / S - 1) & 1);  // its last use is done
        load_kv(t);
      }
    }
  } else {
    // a consumer: 64 query rows, 16 per warp; dQ stays in f32 registers
    // across the key tiles (the TPU kernel's VMEM accumulator)
    if constexpr (F::INLINE_PRODUCER) {
      // thread 0 fills the ring's first S slots, and refills slot (t - 1) % S
      // with tile t - 1 + S at the top of step t (below)
      if (threadIdx.x == 0) {
        load_q();
        for (int t = 0; t < min(S, n_tiles); ++t) load_kv(t);
      }
    } else {
      regs_inc<F::C_REGS>();
    }
    constexpr int NT = BK / 8;      // 8-key column blocks of S and dP
    constexpr int GT = F::GN / 8;   // 8-wide column blocks of one part of dQ
    const int c = threadIdx.x / 128 - (F::INLINE_PRODUCER ? 0 : 1);
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
    const int wg0 = q0 + 64 * c;             // this warpgroup's first row
    const int wq0 = wg0 + 16 * w;            // this warp's first row
    const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
    // lse * log2(e) and D of the two rows, loaded before the first wait
    const int64_t r0 = int64_t(bh) * Lq;
    const float la_a = safe_lse(p.lse, r0 + row_a, row_a < Lq) * LOG2E;
    const float la_b = safe_lse(p.lse, r0 + row_b, row_b < Lq) * LOG2E;
    const float dd_a = row_a < Lq ? p.delta[r0 + row_a] : 0.f;
    const float dd_b = row_b < Lq ? p.delta[r0 + row_b] : 0.f;
    const float sl2 = p.scale * LOG2E;
    float acc[F::GP][GT * 4];
#pragma unroll
    for (int gp = 0; gp < F::GP; ++gp)
#pragma unroll
      for (int i = 0; i < GT * 4; ++i) acc[gp][i] = 0.f;
    // A of S = Q K^T and of dP = dO V^T: this warpgroup's 64 rows
    const uint64_t q_desc = sw128_desc(Qs + 64 * c * 128, 16, ATOM_BYTES);
    const uint64_t o_desc = sw128_desc(Os + 64 * c * 128, 16, ATOM_BYTES);
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
      // rows past the end, or a tile wholly above this warpgroup's rows,
      // add nothing: release the slot (after the K wait, so the arrival
      // counts for this use of the slot)
      if (wg0 >= Lq || (p.causal && k0 > wg0 + 63)) {
        if (lane == 0) mbar_arrive(empty + s);
        continue;
      }
      // S = Q K^T and dP = dO V^T, one batch once V has landed; the
      // reduction over Dh in 16-wide slices, every operand K-major
      mbar_wait(v_full + s, ph);
      float sc[NT * 4], dp[NT * 4];
      const uint64_t qa = opaque(q_desc), oa = opaque(o_desc);
      const uint64_t k_desc = sw128_desc(Kt, 16, ATOM_BYTES);
      const uint64_t v_desc = sw128_desc(Kt + F::TILE, 16, ATOM_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(sc, desc_at(qa, (kk / 4) * F::Q_BOX + off),
                 desc_at(k_desc, (kk / 4) * F::BOX + off), kk);
        wgmma_ss<T>(dp, desc_at(oa, (kk / 4) * F::Q_BOX + off),
                 desc_at(v_desc, (kk / 4) * F::BOX + off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(S * scale - lse), masked where the tile crosses the
      // diagonal or an end of the sequences; then dS = P o (dP - D) in place
      const bool need_mask =
          k0 + BK > Lk || wq0 + 16 > Lq || (p.causal && k0 + BK - 1 > wq0);
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {
        const bool b_row = i & 2;
        float pr = exp2_ftz(fmaf(sc[i], sl2, -(b_row ? la_b : la_a)));
        if (need_mask) {
          const int row = b_row ? row_b : row_a;
          const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          if (col >= Lk || row >= Lq || (p.causal && row < col)) pr = 0.f;
        }
        sc[i] = pr * (dp[i] - (b_row ? dd_b : dd_a));
      }
      // dS cast to T (k's dtype, flash.py:443): the A fragments of the
      // 16-key slices, straight from the registers
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // dQ += dS K, K MN-major through the transpose bit (the tile S read
      // K-major): 16 keys (2048 bytes) per slice; part gp of dQ reads the
      // K boxes of its GN columns
      const uint64_t k_mn = sw128_desc(Kt, F::BOX, ATOM_BYTES);
      wgmma_fence();  // da was written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int gp = 0; gp < F::GP; ++gp)
          wgmma_rs<T>(acc[gp], da[kk],
                      desc_at(k_mn, gp * (F::GN / BOX_COLS) * F::BOX + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int gp = 0; gp < F::GP; ++gp) fence_regs(acc[gp]);
      if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the slot
    }

    // dQ (contiguous [B, Lq, H, D]) = scale * acc, in q's dtype, once
    const float scale = p.scale;
#pragma unroll
    for (int gp = 0; gp < F::GP; ++gp)
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        const int col = gp * F::GN + j * 8 + 2 * t4;
        if (row_a < Lq)
          *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_a) * H + h) * D + col) =
              pack2<T>(acc[gp][4 * j] * scale, acc[gp][4 * j + 1] * scale);
        if (row_b < Lq)
          *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_b) * H + h) * D + col) =
              pack2<T>(acc[gp][4 * j + 2] * scale, acc[gp][4 * j + 3] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 dQ at Dh 512 and its multiples: the wide body of
// flash_bwd_dq_tma
// ---------------------------------------------------------------------------

template <>
struct Dq<512> {
  static constexpr int CONSUMERS = 2;        // warpgroups of 64 query rows
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int BK = 64;              // keys per tile
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int OW = 256;    // dQ columns per CTA
  static constexpr int HALF = 256;  // columns of one step of S's and dP's reduction
  static constexpr int BOXES = HALF / BOX_COLS;
  static constexpr int A_BOX = BQ * 128;        // one 64-column box of a Q or dO half
  static constexpr int B_BOX = BK * 128;        // one 64-column box of a K or V half
  static constexpr int A_HALF = BOXES * A_BOX;  // 64 KB
  static constexpr int B_HALF = BOXES * B_BOX;  // 32 KB
  static constexpr int SLOT = A_HALF + B_HALF;  // an item: a Q (dO) half and a K (V) half
  static constexpr int G_TILE = (OW / BOX_COLS) * B_BOX;  // this chunk's K columns, 32 KB
  // full and empty per slot, the same pair for the K chunk
  static constexpr int BARRIERS = 6;
  static constexpr size_t SMEM =
      2 * size_t(SLOT) + size_t(G_TILE) + 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "wide dQ tiles exceed a block's shared memory");
  static_assert(OW == 2 * 128, "dQ is two m64n128 products a warpgroup");
};

template <typename T>
__device__ __forceinline__ void dq_wide(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                        const CUtensorMap& v_map, const CUtensorMap& o_map,
                                        const Problem& p, int nc, T* __restrict__ dq) {
  using F = Dq<512>;
  constexpr int BK = F::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const slots = atom_aligned(smem_raw);  // slot s: A half, then B half
  unsigned char* const Gs = slots + 2 * F::SLOT;        // this chunk's columns of K
  uint64_t* const full = reinterpret_cast<uint64_t*>(Gs + F::G_TILE);
  uint64_t* const empty = full + 2;
  uint64_t* const g_full = empty + 2;
  uint64_t* const g_empty = g_full + 1;

  // NH 256-column halves of the head dim: the steps of the reduction, and
  // the output chunks, one a CTA; a query tile's chunks are neighbours in
  // the launch order, and causal: the heavier (later) tiles launch first
  const int NH = 2 * nc;
  const int z = blockIdx.x % NH;
  const int n_qt = gridDim.x / NH, qt = blockIdx.x / NH;
  const int H = p.H, Lq = p.Lq, Lk = p.Lk;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / p.KVH);
  const int q0 = (p.causal ? n_qt - 1 - qt : qt) * F::BQ;
  int n_tiles = (Lk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + F::BQ, Lq) - 1) / BK + 1);
  // item j: step u = j % per_tile of key tile j / per_tile, half u / 2 of
  // Q and K (u even: S) or of dO and V (u odd: dP), in slot j & 1 = u & 1
  const int per_tile = 2 * NH;
  const int n_items = n_tiles * per_tile;  // >= 4: n_tiles >= 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every warp releases a slot
    }
    mbar_init(g_full, 1);
    mbar_init(g_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_item = [&](int j) {
    const int t = j / per_tile, u = j % per_tile, s = j & 1;
    unsigned char* const A = slots + s * F::SLOT;
    unsigned char* const Bt = A + F::A_HALF;
    mbar_arrive_expect_tx(full + s, F::SLOT);
    for (int x = 0; x < F::BOXES; ++x) {
      const int col = (u >> 1) * F::HALF + x * BOX_COLS;
      if (u & 1) {
        tma_load(A + x * F::A_BOX, &o_map, full + s, col, h, q0, b);
        tma_load(Bt + x * F::B_BOX, &v_map, full + s, col, kvh, t * BK, b);
      } else {
        tma_load(A + x * F::A_BOX, &q_map, full + s, col, h, q0, b);
        tma_load(Bt + x * F::B_BOX, &k_map, full + s, col, kvh, t * BK, b);
      }
    }
  };
  // key tile t's 256 columns of this chunk, dS K's operand
  auto load_g = [&](int t) {
    mbar_arrive_expect_tx(g_full, F::G_TILE);
    for (int x = 0; x < F::OW / BOX_COLS; ++x)
      tma_load(Gs + x * F::B_BOX, &k_map, g_full, z * F::OW + x * BOX_COLS, kvh, t * BK, b);
  };
  if (threadIdx.x == 0) {
    load_item(0);
    load_item(1);
    load_g(0);
  }

  const int c = threadIdx.x / 128;  // this warpgroup: rows 64 c .. 64 c + 63
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wg0 = q0 + 64 * c;
  const int wq0 = wg0 + 16 * w;
  const int row_a = wq0 + g, row_b = row_a + 8;
  // lse * log2(e) and D of the two rows, loaded before the first wait
  const int64_t r0 = int64_t(bh) * Lq;
  const float la_a = safe_lse(p.lse, r0 + row_a, row_a < Lq) * LOG2E;
  const float la_b = safe_lse(p.lse, r0 + row_b, row_b < Lq) * LOG2E;
  const float dd_a = row_a < Lq ? p.delta[r0 + row_a] : 0.f;
  const float dd_b = row_b < Lq ? p.delta[r0 + row_b] : 0.f;
  const float sl2 = p.scale * LOG2E;

  // this warp is done with item j (K chunk t): release its slot; thread 0
  // refills it with item j + 2 (K chunk t + 1) once all 8 warps have.  The
  // warps it waits for need only loads issued before, so the wait ends.
  auto release_item = [&](int j) {
    if (lane == 0) mbar_arrive(empty + (j & 1));
    if (threadIdx.x == 0 && j + 2 < n_items) {
      mbar_wait(empty + (j & 1), (j >> 1) & 1);
      load_item(j + 2);
    }
    __syncwarp();
  };
  auto release_g = [&](int t) {
    if (lane == 0) mbar_arrive(g_empty);
    if (threadIdx.x == 0 && t + 1 < n_tiles) {
      mbar_wait(g_empty, t & 1);
      load_g(t + 1);
    }
    __syncwarp();
  };

  constexpr int NT = BK / 8;   // 8-key column blocks of S and dP
  constexpr int GT = 128 / 8;  // 8-column blocks of one part of dQ (m64n128)
  float acc[2][GT * 4];
#pragma unroll
  for (int gp = 0; gp < 2; ++gp)
#pragma unroll
    for (int i = 0; i < GT * 4; ++i) acc[gp][i] = 0.f;
  // A: this warpgroup's 64 rows of a slot's Q or dO half; B: its K or V half
  const uint64_t a_desc = sw128_desc(slots + 64 * c * 128, 16, ATOM_BYTES);
  const uint64_t b_desc = sw128_desc(slots + F::A_HALF, 16, ATOM_BYTES);
  // item j's half hh of S (slot 0) or dP (slot 1) into d once it has
  // landed, the reduction over the half's 256 columns in 16-wide slices,
  // every operand K-major; then its slot is released.  Every warpgroup runs
  // every item, and no product is in flight across a release (thread 0's
  // refill is a divergent path; see the top of the file, C7518).  The loads
  // stay ahead: item j + 1 is in flight while item j's products run.
  auto half_item = [&](float (&d)[NT * 4], int j, int hh) {
    const int s = j & 1;
    mbar_wait(full + s, (j >> 1) & 1);
    const uint64_t a = desc_at(opaque(a_desc), s * F::SLOT);
    const uint64_t bb = desc_at(b_desc, s * F::SLOT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::HALF / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T>(d, desc_at(a, (kk / 4) * F::A_BOX + off),
                  desc_at(bb, (kk / 4) * F::B_BOX + off), hh | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    release_item(j);
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // S and dP over the NH halves in order: item 2 hh of the tile is half
    // hh of S, item 2 hh + 1 half hh of dP.  A tile wholly above this
    // warpgroup's rows, or rows past the end, runs too: the mask zeroes P
    float sc[NT * 4], dp[NT * 4];
    for (int hh = 0; hh < NH; ++hh) {
      half_item(sc, t * per_tile + 2 * hh, hh);
      half_item(dp, t * per_tile + 2 * hh + 1, hh);
    }
    mbar_wait(g_full, t & 1);
    // P = exp(S * scale - lse), masked where the tile crosses the
    // diagonal or an end of the sequences; then dS = P o (dP - D) in place
    const bool need_mask =
        k0 + BK > Lk || wq0 + 16 > Lq || (p.causal && k0 + BK - 1 > wq0);
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      const bool b_row = i & 2;
      float pr = exp2_ftz(fmaf(sc[i], sl2, -(b_row ? la_b : la_a)));
      if (need_mask) {
        const int row = b_row ? row_b : row_a;
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        if (col >= Lk || row >= Lq || (p.causal && row < col)) pr = 0.f;
      }
      sc[i] = pr * (dp[i] - (b_row ? dd_b : dd_a));
    }
    // dS cast to T (k's dtype, flash.py:443): the A fragments of the
    // 16-key slices, straight from the registers
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    // dQ_z += dS K_z, K_z MN-major: 16 keys (2048 bytes) per slice; part
    // gp reads the two boxes of its 128 columns
    const uint64_t k_mn = sw128_desc(Gs, F::B_BOX, ATOM_BYTES);
    wgmma_fence();  // da was written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
        wgmma_rs<T>(acc[gp], da[kk], desc_at(k_mn, gp * 2 * F::B_BOX + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int gp = 0; gp < 2; ++gp) fence_regs(acc[gp]);
    release_g(t);
  }

  // this chunk's columns of dQ (contiguous [B, Lq, H, 512 nc]) = scale *
  // acc, in q's dtype, once
  const int64_t width = int64_t(NH) * F::OW;
  const float scale = p.scale;
#pragma unroll
  for (int gp = 0; gp < 2; ++gp)
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      const int col = z * F::OW + gp * 128 + j * 8 + 2 * t4;
      if (row_a < Lq)
        *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_a) * H + h) * width + col) =
            pack2<T>(acc[gp][4 * j] * scale, acc[gp][4 * j + 1] * scale);
      if (row_b < Lq)
        *reinterpret_cast<uint32_t*>(dq + ((int64_t(b) * Lq + row_b) * H + h) * width + col) =
            pack2<T>(acc[gp][4 * j + 2] * scale, acc[gp][4 * j + 3] * scale);
    }
}

// The 16-bit dQ: the narrow body at Dh 64, 128 and 256, the wide one at 512
// (nc chunks of 512 columns: the head dim is 512 nc)
template <typename T, int D>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_tma(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, Problem p, int nc,
                 T* __restrict__ dq) {
  if constexpr (D == 512)
    dq_wide<T>(q_map, k_map, v_map, o_map, p, nc, dq);
  else
    dq_narrow<T, D>(q_map, k_map, v_map, o_map, p, dq);
}

template <typename T, int D>
cudaError_t launch_dq(const Problem& p, int B, int nc, void* dq, cudaStream_t stream) {
  using F = Dq<D>;
  const int width = D * nc;
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err = make_tile_map<T>(&q_map, p.q, B, p.Lq, p.H, width, p.s.q[0],
                                  p.s.q[1], p.s.q[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&o_map, p.dout, B, p.Lq, p.H, width, p.s.d[0], p.s.d[1],
                        p.s.d[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, p.k, B, p.Lk, p.KVH, width, p.s.k[0], p.s.k[1],
                        p.s.k[2], F::BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, p.v, B, p.Lk, p.KVH, width, p.s.v[0], p.s.v[1],
                        p.s.v[2], F::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  // the wide body: a CTA per (query tile, 256-column chunk of dQ)
  const int chunks = D == 512 ? width / Dq<512>::OW : 1;
  const dim3 grid((p.Lq + F::BQ - 1) / F::BQ * chunks, B * p.H);
  flash_bwd_dq_tma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      q_map, k_map, v_map, o_map, p, nc, static_cast<T*>(dq));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16/f16 dK/dV: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int DKV_BK = 128;  // keys per CTA, 64 per consumer warpgroup

template <int D>
struct Dkv {
  // query rows per (Q, dO) tile: S^T and dP^T are 64 x BQ, 16 + 16 f32
  // registers a thread at 32 rows
  static constexpr int BQ = D >= 128 ? 32 : 64;
  // From Dh = 128 on, dK and dV of 64 keys would hold 2 x D / 2 accumulator
  // registers a thread beside the scores: more than a consumer's budget.
  // The kernel then walks the pairs twice, dV in the first pass and dK in
  // the second, recomputing S^T (a quarter more products at Dh = 128) to
  // keep one accumulator (128 registers at Dh = 256).
  static constexpr int PASSES = D >= 128 ? 2 : 1;
  // at Dh = 256 K and V take 128 KB and a slot 32 KB: three slots fit
  static constexpr int STAGES = D == 256 ? 3 : 4;
  // dV += P^T dO and dK += dS^T Q as wgmma products of at most 128 output
  // columns (m64n128k16): one at Dh = 64 and 128, two at 256
  static constexpr int GN = D > 128 ? 128 : D;
  static constexpr int GP = D / GN;
  // The producer: a warpgroup before the two consumers, whose registers
  // setmaxnreg moves to them.  ptxas allocates a thread no more than its
  // sub-partition's share (168 at 384 threads: 16384 registers over three
  // warps) whatever setmaxnreg grants, and at Dh = 256 a consumer needs
  // more (its accumulator alone is 128).  There the CTA is the two
  // consumer warpgroups alone (up to 255 registers a thread), and warp 0
  // refills the ring inline: lane 0 issues the TMA loads, each lane stages
  // one lse and D row of the 32.
  static constexpr bool INLINE_PRODUCER = D == 256;
  static constexpr int THREADS = INLINE_PRODUCER ? 256 : 384;
  static_assert(!INLINE_PRODUCER || BQ == 32, "one lse/D row per lane of warp 0");
  static constexpr int KV_BOX = DKV_BK * 128;  // one 64-column box of K or V
  static constexpr int KV_TILE = (D / BOX_COLS) * KV_BOX;
  static constexpr int Q_BOX = BQ * 128;       // one 64-column box of Q or dO
  static constexpr int Q_TILE = (D / BOX_COLS) * Q_BOX;
  static constexpr int SLOT = 2 * Q_TILE;      // a slot: the Q tile, then dO's
  static constexpr int ROWS = 2 * BQ;          // a slot's lse * log2(e), then D
  // K and V; full and empty per slot
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr size_t SMEM = size_t(2) * KV_TILE +
                                 size_t(STAGES) * (SLOT + ROWS * sizeof(float)) +
                                 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "dK/dV tiles exceed a block's shared memory");
};

// dK/dV at Dh 64, 128 and 256: the narrow body of flash_bwd_dkv_tma
template <typename T, int D>
__device__ __forceinline__ void dkv_narrow(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                           const CUtensorMap& v_map, const CUtensorMap& o_map,
                                           const Problem& p, T* __restrict__ dk,
                                           T* __restrict__ dv) {
  using F = Dkv<D>;
  constexpr int S = F::STAGES, BQ2 = F::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const Ks = atom_aligned(smem_raw);
  unsigned char* const Vs = Ks + F::KV_TILE;
  unsigned char* const ring = Vs + F::KV_TILE;
  float* const rows = reinterpret_cast<float*>(ring + S * F::SLOT);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(rows + S * F::ROWS);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + S;

  const int H = p.H, KVH = p.KVH, Lq = p.Lq, Lk = p.Lk, grp = H / KVH;
  // the key tiles of one kv head are neighbours in the launch order, so
  // the CTAs in flight share their heads' Q and dO in L2; causal: key tile
  // 0, the heaviest, launches first
  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int k0 = blockIdx.x * DKV_BK;
  const int nq = (Lq + BQ2 - 1) / BQ2;
  // causal: query tiles that end before k0 see none of these keys
  const int qt0 = p.causal ? min(k0 / BQ2, nq) : 0;
  const int nqe = nq - qt0;
  const int n_iter = grp * nqe;  // (query head of the group, query tile)
  const int n_load = F::PASSES * n_iter;  // the ring's fills: every pass's pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1 + 32);    // the TMA thread and the lse/D warp
      mbar_init(empty + s, 2 * 128);  // every consumer thread releases a slot
    }
    mbar_fence_init();
  }
  __syncthreads();

  // ring fill n, pair n % n_iter into slot n % S: its (Q, dO) tile by TMA
  // from one thread, and its lse * log2(e) and D rows staged by a warp
  // (lane r: rows r, r + 32, ...), each lane arriving on the slot's barrier
  auto fill_tma = [&](int n) {
    const int s = n % S, it = n % n_iter;
    const int h = kvh * grp + it / nqe, qq0 = (qt0 + it % nqe) * BQ2;
    unsigned char* const Qt = ring + s * F::SLOT;
    mbar_arrive_expect_tx(full + s, F::SLOT);
    for (int x = 0; x < D / BOX_COLS; ++x) {
      tma_load(Qt + x * F::Q_BOX, &q_map, full + s, x * BOX_COLS, h, qq0, b);
      tma_load(Qt + F::Q_TILE + x * F::Q_BOX, &o_map, full + s, x * BOX_COLS, h,
               qq0, b);
    }
  };
  auto fill_rows = [&](int n, int lane) {
    const int s = n % S, it = n % n_iter;
    const int h = kvh * grp + it / nqe, qq0 = (qt0 + it % nqe) * BQ2;
    float* const Lt = rows + s * F::ROWS;
    for (int r = lane; r < BQ2; r += 32) {
      const int row = qq0 + r;
      const int64_t i = (int64_t(b) * H + h) * Lq + row;
      Lt[r] = safe_lse(p.lse, i, row < Lq) * LOG2E;
      Lt[BQ2 + r] = row < Lq ? p.delta[i] : 0.f;
    }
    mbar_arrive(full + s);
  };
  auto load_kv = [&] {
    mbar_arrive_expect_tx(kv_full, 2 * F::KV_TILE);
    for (int x = 0; x < D / BOX_COLS; ++x) {
      tma_load(Ks + x * F::KV_BOX, &k_map, kv_full, x * BOX_COLS, kvh, k0, b);
      tma_load(Vs + x * F::KV_BOX, &v_map, kv_full, x * BOX_COLS, kvh, k0, b);
    }
  };

  if (!F::INLINE_PRODUCER && threadIdx.x < 128) {
    // the producer: thread 0 issues TMA, warp 1 stages the lse and D rows
    regs_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      load_kv();
      for (int n = 0; n < n_load; ++n) {
        if (n >= S) mbar_wait(empty + n % S, (n / S - 1) & 1);  // its last use is done
        fill_tma(n);
      }
    } else if (warp == 1) {
      for (int n = 0; n < n_load; ++n) {
        if (n >= S) mbar_wait(empty + n % S, (n / S - 1) & 1);
        fill_rows(n, lane);
      }
    }
  } else {
    // a consumer: 64 keys, 16 per warp; dK and dV stay in registers across
    // the whole group (the TPU kernel's VMEM accumulation, flash.py:537-541)
    if constexpr (F::INLINE_PRODUCER) {
      // warp 0 fills the ring's first S slots, and refills slot (n - 1) % S
      // with fill n - 1 + S at the top of pair n (below)
      if (threadIdx.x < 32) {
        if (threadIdx.x == 0) load_kv();
        for (int n = 0; n < min(S, n_load); ++n) {
          if (threadIdx.x == 0) fill_tma(n);
          fill_rows(n, threadIdx.x);
        }
      }
    } else {
      regs_inc<CONSUMER_REGS>();
    }
    constexpr int NT = BQ2 / 8;      // 8-query column blocks of S^T
    constexpr int GT = F::GN / 8;    // 8-wide column blocks of one part of dK, dV
    const int c = threadIdx.x / 128 - (F::INLINE_PRODUCER ? 0 : 1);
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wk0 = k0 + 64 * c + 16 * w;          // this warp's first key
    const int key_a = wk0 + g, key_b = key_a + 8;  // this thread's two keys
    const float sl2 = p.scale * LOG2E;
    float adk[F::GP][GT * 4], adv[F::GP][GT * 4];
    float st[NT * 4], dpt[NT * 4];              // S^T and dP^T, then P^T and dS^T
    uint32_t ap[BQ2 / 16][4], as[BQ2 / 16][4];  // P^T and dS^T as A fragments of T
    // A of S^T = K Q^T and of dP^T = V dO^T: this warpgroup's 64 keys
    const uint64_t k_desc = sw128_desc(Ks + 64 * c * 128, 16, ATOM_BYTES);
    const uint64_t v_desc = sw128_desc(Vs + 64 * c * 128, 16, ATOM_BYTES);
    auto slot = [&](int n) { return ring + (n % S) * F::SLOT; };

    // S^T = K Q^T (and dP^T = V dO^T) of ring fill n, the reduction over Dh
    auto issue_scores = [&](int n, bool with_dp) {
      mbar_wait(full + n % S, (n / S) & 1);
      const uint64_t q_desc = sw128_desc(slot(n), 16, ATOM_BYTES);
      const uint64_t o_desc = sw128_desc(slot(n) + F::Q_TILE, 16, ATOM_BYTES);
      const uint64_t ka = opaque(k_desc), va = opaque(v_desc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * F::KV_BOX + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * F::Q_BOX + (kk % 4) * 32;
        wgmma_ss<T>(st, desc_at(ka, a_off), desc_at(q_desc, b_off), kk);
        if (with_dp) wgmma_ss<T>(dpt, desc_at(va, a_off), desc_at(o_desc, b_off), kk);
      }
      wgmma_commit();
    };
    // dV += P^T dO (P cast to dO's dtype, flash.py:482) and dK += dS^T Q
    // (dS cast to q's, :489): A from registers, dO and Q MN-major (16 query
    // rows, 2048 bytes, per slice); part p of dK and dV reads the boxes of
    // its GN columns
    auto issue_grads = [&](int n, bool dv_on, bool dk_on) {
      const uint64_t q_mn = sw128_desc(slot(n), F::Q_BOX, ATOM_BYTES);
      const uint64_t o_mn = sw128_desc(slot(n) + F::Q_TILE, F::Q_BOX, ATOM_BYTES);
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
        for (int gp = 0; gp < F::GP; ++gp) {
          const uint32_t off = gp * (F::GN / BOX_COLS) * F::Q_BOX + kk * 16 * 128;
          if (dv_on) wgmma_rs<T>(adv[gp], ap[kk], desc_at(o_mn, off));
          if (dk_on) wgmma_rs<T>(adk[gp], as[kk], desc_at(q_mn, off));
        }
      wgmma_commit();
    };
    // P^T = exp(S^T * scale - lse), masked where the tile crosses the
    // diagonal or an end of the sequences (a query tile wholly before these
    // keys masks to 0); dS^T = P^T o (dP^T - D); both packed to T
    auto grads_of_scores = [&](int n, bool with_ds) {
      const int qq0 = (qt0 + (n % n_iter) % nqe) * BQ2;
      const float* const Lt = rows + (n % S) * F::ROWS;
      const float* const Dt = Lt + BQ2;
      const bool need_mask =
          qq0 + BQ2 > Lq || wk0 + 16 > Lk || (p.causal && qq0 < wk0 + 15);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t4);
        const float2 dd = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qq0 + 8 * j + 2 * t4 + (e & 1);  // the query
          const int key = e < 2 ? key_a : key_b;
          float pr = exp2_ftz(fmaf(st[4 * j + e], sl2, -((e & 1) ? lq.y : lq.x)));
          if (need_mask && (col >= Lq || key >= Lk || (p.causal && col < key)))
            pr = 0.f;
          st[4 * j + e] = pr;
          if (with_ds) dpt[4 * j + e] = pr * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ap[kk][r] = pack2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          if (with_ds) as[kk][r] = pack2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
    };
    // one ring fill: the products of a pair and its release
    auto pair = [&](int n, bool dv_on, bool dk_on) {
      if constexpr (F::INLINE_PRODUCER) {
        // every thread is done with fill n - 1 once its slot's empty phase
        // completes (this warp is, being here)
        if (threadIdx.x < 32 && n >= 1 && n - 1 + S < n_load) {
          mbar_wait(empty + (n - 1) % S, ((n - 1) / S) & 1);
          if (threadIdx.x == 0) fill_tma(n - 1 + S);
          fill_rows(n - 1 + S, threadIdx.x);
        }
        __syncwarp();
      }
      wgmma_fence();
      issue_scores(n, dk_on);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grads_of_scores(n, dk_on);
      wgmma_fence();  // ap and as were written by ordinary instructions
      issue_grads(n, dv_on, dk_on);
      wgmma_wait<0>();
#pragma unroll
      for (int gp = 0; gp < F::GP; ++gp) {
        fence_regs(adv[gp]);
        fence_regs(adk[gp]);
      }
      mbar_arrive(empty + n % S);  // this thread is done with the slot
    };
    auto zero = [&](float (&acc)[F::GP][GT * 4]) {
#pragma unroll
      for (int gp = 0; gp < F::GP; ++gp)
#pragma unroll
        for (int i = 0; i < GT * 4; ++i) acc[gp][i] = 0.f;
    };
    // dK = scale * acc, dV (contiguous [B, Lk, KVH, D]) in k/v's dtype
    auto store = [&](T* dst, const float (&acc)[F::GP][GT * 4], float sc) {
#pragma unroll
      for (int gp = 0; gp < F::GP; ++gp)
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          const int col = gp * F::GN + j * 8 + 2 * t4;
          if (key_a < Lk)
            *reinterpret_cast<uint32_t*>(dst + ((int64_t(b) * Lk + key_a) * KVH + kvh) * D + col) =
                pack2<T>(acc[gp][4 * j] * sc, acc[gp][4 * j + 1] * sc);
          if (key_b < Lk)
            *reinterpret_cast<uint32_t*>(dst + ((int64_t(b) * Lk + key_b) * KVH + kvh) * D + col) =
                pack2<T>(acc[gp][4 * j + 2] * sc, acc[gp][4 * j + 3] * sc);
        }
    };

    mbar_wait(kv_full, 0);
    if constexpr (F::PASSES == 1) {
      zero(adk);
      zero(adv);
      for (int n = 0; n < n_iter; ++n) pair(n, true, true);
      store(dk, adk, p.scale);
      store(dv, adv, 1.f);
    } else {
      zero(adv);
      for (int n = 0; n < n_iter; ++n) pair(n, true, false);
      store(dv, adv, 1.f);
      zero(adk);
      for (int n = n_iter; n < 2 * n_iter; ++n) pair(n, false, true);
      store(dk, adk, p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 dK/dV at Dh 512 and its multiples: the wide body of
// flash_bwd_dkv_tma
// ---------------------------------------------------------------------------

template <>
struct Dkv<512> {
  static constexpr int BQ = 64;  // query rows per (Q, dO) tile
  static constexpr int THREADS = 256;  // two consumer warpgroups of 64 keys
  static constexpr int OW = 256;    // dK and dV columns per CTA
  static constexpr int HALF = 256;  // columns of one step of S's and dP's reduction
  static constexpr int BOXES = HALF / BOX_COLS;
  static constexpr int A_BOX = DKV_BK * 128;    // one 64-column box of a K or V half
  static constexpr int B_BOX = BQ * 128;        // one 64-column box of a Q or dO half
  static constexpr int A_HALF = BOXES * A_BOX;  // 64 KB
  static constexpr int B_HALF = BOXES * B_BOX;  // 32 KB
  static constexpr int SLOT = A_HALF + B_HALF;  // an item: a K (V) half and a Q (dO) half
  static constexpr int G_TILE = (OW / BOX_COLS) * B_BOX;  // this chunk's dO or Q, 32 KB
  static constexpr int ROWS = 2 * BQ;  // the gradient tile's lse * log2(e), then D
  // full and empty per slot, the same pair for the gradient tile
  static constexpr int BARRIERS = 6;
  static constexpr size_t SMEM = 2 * size_t(SLOT) + size_t(G_TILE) +
                                 ROWS * sizeof(float) + 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "wide dK/dV tiles exceed a block's shared memory");
  static_assert(OW == 2 * 128, "dK and dV are two m64n128 products a warpgroup");
};

template <typename T>
__device__ __forceinline__ void dkv_wide(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, const CUtensorMap& o_map,
                                         const Problem& p, int nc, T* __restrict__ dk,
                                         T* __restrict__ dv) {
  using F = Dkv<512>;
  constexpr int BQ2 = F::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const slots = atom_aligned(smem_raw);  // slot s: A half, then B half
  unsigned char* const Gs = slots + 2 * F::SLOT;        // this chunk's columns of dO or Q
  float* const rows = reinterpret_cast<float*>(Gs + F::G_TILE);
  uint64_t* const full = reinterpret_cast<uint64_t*>(rows + F::ROWS);
  uint64_t* const empty = full + 2;
  uint64_t* const g_full = empty + 2;
  uint64_t* const g_empty = g_full + 1;

  // NH 256-column halves of the head dim: the steps of the reduction, and
  // the output chunks, one a CTA; a key tile's chunks are neighbours in the
  // launch order, and causal: key tile 0, the heaviest, launches first
  const int NH = 2 * nc;
  const int z = blockIdx.x % NH;
  const int k0 = (blockIdx.x / NH) * DKV_BK;
  const int H = p.H, KVH = p.KVH, Lq = p.Lq, Lk = p.Lk, grp = H / KVH;
  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int nq = (Lq + BQ2 - 1) / BQ2;
  // causal: query tiles that end before k0 see none of these keys
  const int qt0 = p.causal ? min(k0 / BQ2, nq) : 0;
  const int nqe = nq - qt0;
  const int n_pairs = grp * nqe;  // (query head of the group, query tile)
  // The item stream, item j in slot j & 1: the dV pass's NH items a pair
  // (half hh of K and Q, for S^T), then the dK pass's 2 NH a pair (half hh
  // of K and Q, then of V and dO, for dP^T); NH is even, so in the dK pass
  // slot 0 feeds S^T and slot 1 dP^T.  The gradient tiles: pair n's dO
  // columns (fill n), then its Q columns (fill n_pairs + n).
  const int n_items1 = n_pairs * NH;
  const int n_items = 3 * n_items1;
  const int n_fills = 2 * n_pairs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every warp releases a slot
    }
    mbar_init(g_full, 1 + 32);  // the TMA thread and warp 0's lse/D rows
    mbar_init(g_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_item = [&](int j) {
    int n, hh;
    bool dp_item;
    if (j < n_items1) {
      n = j / NH, hh = j % NH, dp_item = false;
    } else {
      const int i = j - n_items1;
      n = i / (2 * NH), hh = (i % (2 * NH)) >> 1, dp_item = i & 1;
    }
    const int h = kvh * grp + n / nqe, qq0 = (qt0 + n % nqe) * BQ2;
    const int s = j & 1;
    unsigned char* const A = slots + s * F::SLOT;
    unsigned char* const Bt = A + F::A_HALF;
    mbar_arrive_expect_tx(full + s, F::SLOT);
    for (int x = 0; x < F::BOXES; ++x) {
      const int col = hh * F::HALF + x * BOX_COLS;
      if (dp_item) {
        tma_load(A + x * F::A_BOX, &v_map, full + s, col, kvh, k0, b);
        tma_load(Bt + x * F::B_BOX, &o_map, full + s, col, h, qq0, b);
      } else {
        tma_load(A + x * F::A_BOX, &k_map, full + s, col, kvh, k0, b);
        tma_load(Bt + x * F::B_BOX, &q_map, full + s, col, h, qq0, b);
      }
    }
  };
  // gradient fill m by warp 0: lane 0 loads the tile's 256 columns of this
  // chunk by TMA, each lane stages two of its rows' lse * log2(e) and D
  auto fill_g = [&](int m, int lane) {
    const int n = m < n_pairs ? m : m - n_pairs;
    const int h = kvh * grp + n / nqe, qq0 = (qt0 + n % nqe) * BQ2;
    if (lane == 0) {
      mbar_arrive_expect_tx(g_full, F::G_TILE);
      for (int x = 0; x < F::OW / BOX_COLS; ++x) {
        const int col = z * F::OW + x * BOX_COLS;
        if (m < n_pairs)
          tma_load(Gs + x * F::B_BOX, &o_map, g_full, col, h, qq0, b);
        else
          tma_load(Gs + x * F::B_BOX, &q_map, g_full, col, h, qq0, b);
      }
    }
    for (int r = lane; r < BQ2; r += 32) {
      const int row = qq0 + r;
      const int64_t i = (int64_t(b) * H + h) * Lq + row;
      rows[r] = safe_lse(p.lse, i, row < Lq) * LOG2E;
      rows[BQ2 + r] = row < Lq ? p.delta[i] : 0.f;
    }
    mbar_arrive(g_full);
  };
  if (n_pairs > 0 && threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      load_item(0);
      load_item(1);  // n_items >= 3 NH >= 6
    }
    fill_g(0, threadIdx.x);
  }

  const int c = threadIdx.x / 128;  // this warpgroup: keys 64 c .. 64 c + 63
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * c;                   // this warpgroup's first key
  const int wk0 = kw0 + 16 * w;                  // this warp's first key
  const int key_a = wk0 + g, key_b = key_a + 8;  // this thread's two keys
  const float sl2 = p.scale * LOG2E;

  // this warp is done with item j (gradient fill m): release it; thread 0
  // (warp 0) refills it with item j + 2 (fill m + 1) once all 8 warps have
  auto release_item = [&](int j) {
    if (lane == 0) mbar_arrive(empty + (j & 1));
    if (threadIdx.x == 0 && j + 2 < n_items) {
      mbar_wait(empty + (j & 1), (j >> 1) & 1);
      load_item(j + 2);
    }
    __syncwarp();
  };
  auto release_g = [&](int m) {
    if (lane == 0) mbar_arrive(g_empty);
    if (threadIdx.x < 32 && m + 1 < n_fills) {
      mbar_wait(g_empty, m & 1);
      fill_g(m + 1, threadIdx.x);
    }
    __syncwarp();
  };

  constexpr int NT = BQ2 / 8;  // 8-query column blocks of S^T and dP^T
  constexpr int GT = 128 / 8;  // 8-column blocks of one part of dK or dV (m64n128)
  float acc[2][GT * 4];        // dV in the first pass, dK in the second
  // A: this warpgroup's 64 keys of a slot's K or V half; B: its Q or dO half
  const uint64_t a_desc = sw128_desc(slots + 64 * c * 128, 16, ATOM_BYTES);
  const uint64_t b_desc = sw128_desc(slots + F::A_HALF, 16, ATOM_BYTES);
  // item j's half hh of S^T or dP^T into d, then its release (as dq_wide's
  // half_item: no product in flight across a release)
  auto half_item = [&](float (&d)[NT * 4], int j, int hh) {
    const int s = j & 1;
    mbar_wait(full + s, (j >> 1) & 1);
    const uint64_t a = desc_at(opaque(a_desc), s * F::SLOT);
    const uint64_t bb = desc_at(b_desc, s * F::SLOT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::HALF / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T>(d, desc_at(a, (kk / 4) * F::A_BOX + off),
                  desc_at(bb, (kk / 4) * F::B_BOX + off), hh | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    release_item(j);
  };
  // P^T = exp(S^T * scale - lse) of the pair whose query tile starts at
  // qq0, masked where the tile crosses the diagonal or an end of the
  // sequences; with_ds: dS^T = P^T o (dP^T - D) in dpt's place
  auto probs = [&](float (&st)[NT * 4], float (&dpt)[NT * 4], int qq0, bool with_ds) {
    const float* const Dt = rows + BQ2;
    const bool need_mask =
        qq0 + BQ2 > Lq || wk0 + 16 > Lk || (p.causal && qq0 < wk0 + 15);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
      const float2 dd = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = qq0 + 8 * j + 2 * t4 + (e & 1);  // the query
        const int key = e < 2 ? key_a : key_b;
        float pr = exp2_ftz(fmaf(st[4 * j + e], sl2, -((e & 1) ? lq.y : lq.x)));
        if (need_mask && (col >= Lq || key >= Lk || (p.causal && col < key))) pr = 0.f;
        st[4 * j + e] = pr;
        if (with_ds) dpt[4 * j + e] = pr * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
    }
  };
  // acc += X^T G_z with X^T (P^T or dS^T, rounded to T: P to dO's dtype,
  // flash.py:482, dS to q's, :489) as register A fragments and the
  // gradient tile MN-major: 16 query rows (2048 bytes) per slice; part gp
  // reads the two boxes of its 128 columns
  auto grad_product = [&](const float (&x)[NT * 4]) {
    uint32_t xa[BQ2 / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) xa[kk][r] = pack2<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    const uint64_t g_mn = sw128_desc(Gs, F::B_BOX, ATOM_BYTES);
    wgmma_fence();  // xa was written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
        wgmma_rs<T>(acc[gp], xa[kk], desc_at(g_mn, gp * 2 * F::B_BOX + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int gp = 0; gp < 2; ++gp) fence_regs(acc[gp]);
  };
  auto zero = [&] {
#pragma unroll
    for (int gp = 0; gp < 2; ++gp)
#pragma unroll
      for (int i = 0; i < GT * 4; ++i) acc[gp][i] = 0.f;
  };
  // this chunk's columns of dK = scale * acc or dV (contiguous [B, Lk, KVH,
  // 512 nc]) in k/v's dtype
  auto store = [&](T* dst, float sc) {
    const int64_t width = int64_t(NH) * F::OW;
#pragma unroll
    for (int gp = 0; gp < 2; ++gp)
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        const int col = z * F::OW + gp * 128 + j * 8 + 2 * t4;
        if (key_a < Lk)
          *reinterpret_cast<uint32_t*>(dst + ((int64_t(b) * Lk + key_a) * KVH + kvh) * width + col) =
              pack2<T>(acc[gp][4 * j] * sc, acc[gp][4 * j + 1] * sc);
        if (key_b < Lk)
          *reinterpret_cast<uint32_t*>(dst + ((int64_t(b) * Lk + key_b) * KVH + kvh) * width + col) =
              pack2<T>(acc[gp][4 * j + 2] * sc, acc[gp][4 * j + 3] * sc);
      }
  };
  // A query tile wholly before this warpgroup's keys (causal), or keys past
  // the end, run too: the mask zeroes P^T and dS^T.
  // The dV pass: S^T over the NH halves in order, then dV_z += P^T dO_z.
  zero();
  for (int n = 0; n < n_pairs; ++n) {
    const int qq0 = (qt0 + n % nqe) * BQ2;
    float st[NT * 4];
    for (int hh = 0; hh < NH; ++hh) half_item(st, n * NH + hh, hh);
    mbar_wait(g_full, n & 1);
    probs(st, st, qq0, false);
    grad_product(st);
    release_g(n);
  }
  store(dv, 1.f);

  // the dK pass: S^T (items of slot 0) and dP^T (slot 1) over the halves,
  // then dK_z += dS^T Q_z
  zero();
  for (int n = 0; n < n_pairs; ++n) {
    const int qq0 = (qt0 + n % nqe) * BQ2;
    float st[NT * 4], dpt[NT * 4];
    for (int hh = 0; hh < NH; ++hh) {
      const int j = n_items1 + n * 2 * NH + 2 * hh;
      half_item(st, j, hh);
      half_item(dpt, j + 1, hh);
    }
    const int m = n_pairs + n;
    mbar_wait(g_full, m & 1);
    probs(st, dpt, qq0, true);
    grad_product(dpt);
    release_g(m);
  }
  store(dk, p.scale);
}

// The 16-bit dK/dV: the narrow body at Dh 64, 128 and 256, the wide one at
// 512 (nc chunks of 512 columns: the head dim is 512 nc)
template <typename T, int D>
__global__ void __launch_bounds__(Dkv<D>::THREADS, 1)
flash_bwd_dkv_tma(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap o_map, Problem p, int nc,
                  T* __restrict__ dk, T* __restrict__ dv) {
  if constexpr (D == 512)
    dkv_wide<T>(q_map, k_map, v_map, o_map, p, nc, dk, dv);
  else
    dkv_narrow<T, D>(q_map, k_map, v_map, o_map, p, dk, dv);
}

template <typename T, int D>
cudaError_t launch_dkv(const Problem& p, int B, int nc, void* dk, void* dv,
                       cudaStream_t stream) {
  using F = Dkv<D>;
  const int width = D * nc;
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err = make_tile_map<T>(&q_map, p.q, B, p.Lq, p.H, width, p.s.q[0],
                                  p.s.q[1], p.s.q[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&o_map, p.dout, B, p.Lq, p.H, width, p.s.d[0], p.s.d[1],
                        p.s.d[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, p.k, B, p.Lk, p.KVH, width, p.s.k[0], p.s.k[1],
                        p.s.k[2], DKV_BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, p.v, B, p.Lk, p.KVH, width, p.s.v[0], p.s.v[1],
                        p.s.v[2], DKV_BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  // the wide body: a CTA per (key tile, 256-column chunk of dK and dV)
  const int chunks = D == 512 ? width / Dkv<512>::OW : 1;
  const dim3 grid((p.Lk + DKV_BK - 1) / DKV_BK * chunks, B * p.KVH);
  flash_bwd_dkv_tma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      q_map, k_map, v_map, o_map, p, nc, static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the register-tiled SIMT kernels, at every head dim
// ---------------------------------------------------------------------------

// flash_fwd.cu's Simt carried over to the gradients.  Both kernels form a
// score tile of R resident rows by C streamed rows, on 256 threads:
//  * dQ: S = Q K^T and dP = dO V^T over R query rows of one head (Q, dO,
//    their lse and D resident) by C keys of its kv head (K and V streamed,
//    from key 0 to the diagonal);
//  * dK/dV: S^T = K Q^T and dP^T = V dO^T over R keys of one kv head (K and
//    V resident) by C query rows (Q, dO, their lse and D streamed, every
//    query head of the group in turn, each from the diagonal on).
// Per streamed tile:
//  * S and dP together: a thread forms a 4 x 4 micro-tile of both for the
//    same pairs, rows sr + i NRG and columns sc + j NSG, from float4 loads
//    along Dh; G lanes (neighbours) split the reduction over Dh by 16-byte
//    chunk (chunk gs + G n), and a butterfly of shuffles sums their
//    partials.  A warp holds NR_LO row groups x NS_LO column groups x G
//    splits, so its loads touch few rows (broadcasts).
//  * P = exp(S scale - lse) and dS = P o (dP - D) of the thread's pairs in
//    registers (expf, as the forward; the mask, top-left causal), stored
//    transposed, [column][row] in rows of LDM = R + 4: dS (dQ), or P and dS
//    (dK/dV).
//  * The gradient products as the forward's O += P V: a thread holds 4
//    consecutive rows x CH float4 chunks of columns (chunk ocg + NCG m) of
//    its R x D accumulators, dQ (dQ += dS K) or dV and dK (dV += P^T dO,
//    dK += dS^T Q); per streamed row one float4 of dS (or of P and of dS)
//    and CH float4s of K (or of dO and of Q) feed 16 CH FMAs each.
//  * Shared memory: the resident tiles and ST stages of the streamed ones in
//    rows of LD = D + 4 G floats (LD / 4 = G mod 8: the chunks a warp loads
//    fall in distinct banks), copied by cp.async (ST = 2: the next tile's
//    copy overlaps this one's work); the transposed P / dS; lse and D of
//    the rows.
//  * Registers: dK and dV of R keys x 512 columns would take 128 f32
//    registers a thread at R = 32, so dK/dV runs 16 keys at Dh 512 (64).
//    Two CTAs an SM where they fit and were faster (dQ at Dh 64, dK/dV at
//    64 and 128; tools/bwd_simt_variant.py times one CTA against two):
//    launch bounds hold a thread to 128 registers, so S and dP run as two
//    rolled loops, one product's operands live at a time (one loop over
//    both spilled 12-64 bytes, and dQ at 128 spills 120 even so: one CTA
//    there, as fast); one CTA with two stages elsewhere below 512.
// What bounds them on the H100: the FMA pipe (67 TFLOP/s f32), at 6 Dh
// (dQ) and 8 Dh (dK/dV) FLOP per (query, key) pair; every FMA is exact f32
// (TF32 would lose precision the JAX reference keeps).  A head dim above
// 512 runs the 512 build split into chunks of 512 columns, one per
// blockIdx.z: every chunk's block sums S and dP over all the chunks in chunk
// order, streaming the resident and the streamed chunks through the tiles
// (so every chunk computes the same P and dS), and accumulates only its own
// chunk (dS K_z; P^T dO_z and dS^T Q_z).
template <int R_, int C_, int D, bool DKV, int ST_, int CTAS_>
struct SimtBwd {
  static constexpr int R = R_, C = C_, ST = ST_, CTAS = CTAS_;
  static constexpr int THREADS = 256;
  static constexpr int NRG = R / 4, NSG = C / 4;
  static constexpr int G = THREADS / (NRG * NSG);
  static constexpr int NS_LO = G == 1 ? 8 : 4;
  static constexpr int NR_LO = 32 / (G * NS_LO);
  static constexpr int NS_HI = NSG / NS_LO;
  static constexpr int NCG = THREADS / NRG;
  static constexpr int CH = D / 4 / NCG;
  static constexpr int NC_HI = NCG / 8;
  static constexpr int LD = D + 4 * G;
  static constexpr int LDM = R + 4;
  static constexpr int NT = DKV ? 2 : 1;                  // dS; or P and dS
  static constexpr int NROW = DKV ? 2 * ST * C : 2 * R;  // lse and D values
  static constexpr size_t SMEM = (size_t(2 * R + 2 * ST * C) * LD + size_t(NT) * C * LDM +
                                  NROW) * sizeof(float);
  static_assert(NRG * NSG * G == THREADS && NR_LO * NS_LO * G == 32, "S's lanes");
  static_assert(NSG % NS_LO == 0 && (NRG / NR_LO) * NS_HI == THREADS / 32, "S's warps");
  static_assert(CH * NCG * 4 == D && (NRG / 4) * NC_HI == THREADS / 32, "the products' lanes");
  static_assert((D / 4) % G == 0 && (LD / 4 - G) % 8 == 0 && LDM % 4 == 0, "strides");
  static_assert(ST == 1 || D < SPLIT, "a split head dim streams its chunks through one stage");
  static_assert(SMEM <= 232448 && CTAS * (SMEM + 1024) <= 233472,
                "f32 backward tiles exceed the shared memory of their CTAs");
};

// the CTAs an SM, by head dim and kernel, and the stages of the streamed
// tiles: two where one CTA holds the SM, below the split width
constexpr int simt_ctas(int D, bool dkv) { return D <= (dkv ? 128 : 64) ? 2 : 1; }
constexpr int simt_stages(int D, bool dkv) { return simt_ctas(D, dkv) == 1 && D < SPLIT ? 2 : 1; }

// dQ: 64 query rows x 64 keys at Dh 64, x 32 keys at 128; 32 x 32 at 256;
// 32 x 16 at 512 (Q, dO, K and V of 32 rows would take 278 KB).  dK/dV:
// 64 keys x 64 query rows at 64; 32 x 32 at 128 and 256; 16 x 32 at 512.
// Shared memory: dQ 86 (two CTAs), 145 and 209 (two stages) and 207 KB;
// dK/dV 103 and 81 (two CTAs), 214 (two stages) and 209 KB.
template <int D>
using DqSimt = SimtBwd<D >= 256 ? 32 : 64, D >= 512 ? 16 : D >= 128 ? 32 : 64, D, false,
                       simt_stages(D, false), simt_ctas(D, false)>;
template <int D>
using DkvSimt = SimtBwd<D >= 512 ? 16 : D >= 128 ? 32 : 64, D >= 128 ? 32 : 64, D, true,
                        simt_stages(D, true), simt_ctas(D, true)>;

// acc[i][j] += the dot product of a's row sr + i NRG and b's row sc + j NSG
// over the 4 columns from d
template <typename F>
__device__ __forceinline__ void fma_4x4(const float* a, const float* b, int sr, int sc,
                                        int d, float (&acc)[4][4]) {
  float4 x[4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const float4*>(a + (sr + i * F::NRG) * F::LD + d);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = *reinterpret_cast<const float4*>(b + (sc + j * F::NSG) * F::LD + d);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
      acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
      acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
      acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
    }
}

// The body of both kernels: dQ (DKV false: out = dq) or dK and dV (DKV
// true: out = dk, out2 = dv) of one CTA's R rows, chunk blockIdx.z of their
// columns
template <int D, bool DKV>
__device__ __forceinline__ void bwd_simt(const Problem& p, int nc, float* __restrict__ out,
                                         float* __restrict__ out2) {
  using F = std::conditional_t<DKV, DkvSimt<D>, DqSimt<D>>;
  constexpr int R = F::R, C = F::C, G = F::G, LD = F::LD, LDM = F::LDM, CH = F::CH;
  extern __shared__ __align__(16) float smem_f[];
  float* const A1 = smem_f;                   // Q, or K: R rows
  float* const A2 = A1 + R * LD;              // dO, or V
  float* const Bs = A2 + R * LD;              // ST stages of (K, V), or (Q, dO): C rows each
  float* const Tt = Bs + 2 * F::ST * C * LD;  // dS, or P then dS: [column][row]
  float* const rows = Tt + F::NT * C * LDM;   // lse, then D: of the R rows, or of each stage's C

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, KVH = p.KVH, grp = H / KVH, Lq = p.Lq, Lk = p.Lk;
  const int causal = p.causal;
  const int z = blockIdx.z;  // this block's chunk of the output columns
  const float* const q = static_cast<const float*>(p.q);
  const float* const k = static_cast<const float*>(p.k);
  const float* const v = static_cast<const float*>(p.v);
  const float* const dout = static_cast<const float*>(p.dout);

  // the resident rows [r0, r0 + R) and the steps over streamed tiles: key
  // tiles to the diagonal (dQ); (group head, query tile from the diagonal
  // on) pairs (dK/dV)
  int b, h, kvh, r0, n_steps, per = 1, qt0 = 0;
  if constexpr (DKV) {
    b = blockIdx.y / KVH;
    kvh = blockIdx.y % KVH;
    h = kvh * grp;
    r0 = blockIdx.x * R;  // key tile 0, the heaviest under the causal mask, first
    const int nq = (Lq + C - 1) / C;
    qt0 = causal ? min(r0 / C, nq) : 0;
    per = nq - qt0;
    n_steps = grp * per;
  } else {
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    kvh = h / grp;
    r0 = int(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * R;  // heavier tiles first
    n_steps = (Lk + C - 1) / C;
    if (causal) n_steps = min(n_steps, (min(r0 + R, Lq) - 1) / C + 1);
  }
  const float* const kb = k + b * p.s.k[0] + kvh * p.s.k[2];
  const float* const vb = v + b * p.s.v[0] + kvh * p.s.v[2];
  const float* const a1b = DKV ? kb : q + b * p.s.q[0] + h * p.s.q[2];
  const float* const a2b = DKV ? vb : dout + b * p.s.d[0] + h * p.s.d[2];
  const int64_t a1s = DKV ? p.s.k[1] : p.s.q[1];
  const int64_t a2s = DKV ? p.s.v[1] : p.s.d[1];
  const int La = DKV ? Lk : Lq;

  // rows [row0, row0 + n) of a [L, .] slice with row stride s_l, the
  // columns [col, col + D), into rows of LD floats (zeros past L)
  auto load_rows = [&](float* dst, const float* base, int64_t s_l, int row0, int n, int L,
                       int col) {
    constexpr int CPR = D / 4;
    for (int i = tid; i < n * CPR; i += F::THREADS) {
      const int r = i / CPR, c4 = (i % CPR) * 4;
      const bool ok = row0 + r < L;
      cp_async16(dst + r * LD + c4, base + (ok ? (row0 + r) * s_l : 0) + col + c4, ok);
    }
  };
  // the (safe) lse, then D, of query rows [row0, row0 + n) of head hd
  auto load_lse_d = [&](float* dst, int hd, int row0, int n) {
    if (tid < n) {
      const int row = row0 + tid;
      const int64_t i = (int64_t(b) * H + hd) * Lq + row;
      dst[tid] = safe_lse(p.lse, i, row < Lq);
      dst[n + tid] = row < Lq ? p.delta[i] : 0.f;
    }
  };
  // step s: the head and first row of its streamed tile
  auto step_head = [&](int s) { return DKV ? kvh * grp + s / per : h; };
  auto step_row0 = [&](int s) { return DKV ? (qt0 + s % per) * C : s * C; };
  // step s's streamed tiles, the columns [col, col + D), into stage st:
  // only the first (K, or Q) unless `both`
  // (and with `first`, dK/dV's lse and D of its query rows)
  auto load_step = [&](int s, int st, int col, bool both, bool first) {
    float* const buf = Bs + st * 2 * C * LD;
    const int c0 = step_row0(s);
    if constexpr (DKV) {
      const int hs = step_head(s);
      load_rows(buf, q + b * p.s.q[0] + hs * p.s.q[2], p.s.q[1], c0, C, Lq, col);
      if (both)
        load_rows(buf + C * LD, dout + b * p.s.d[0] + hs * p.s.d[2], p.s.d[1], c0, C, Lq, col);
      if (first) load_lse_d(rows + st * 2 * C, hs, c0, C);
    } else {
      load_rows(buf, kb, p.s.k[1], c0, C, Lk, col);
      if (both) load_rows(buf + C * LD, vb, p.s.v[1], c0, C, Lk, col);
    }
  };

  // S and dP: rows sr + i NRG, columns sc + j NSG, split gs of G
  const int gs = lane % G;
  const int sc = (warp % F::NS_HI) * F::NS_LO + (lane / G) % F::NS_LO;
  const int sr = (warp / F::NS_HI) * F::NR_LO + lane / (G * F::NS_LO);
  // the products: rows orow .. orow + 3, column chunks ocg + NCG m
  const int orow = 4 * ((warp / F::NC_HI) * 4 + lane / 8);
  const int ocg = (warp % F::NC_HI) * 8 + lane % 8;

  // dQ, or dV; and dK
  float4 acc[4][CH], acc2[4][DKV ? CH : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      acc[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (DKV) acc2[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  if constexpr (!DKV) load_lse_d(rows, h, r0, R);
  load_rows(A1, a1b, a1s, r0, R, La, 0);
  load_rows(A2, a2b, a2s, r0, R, La, 0);
  if (n_steps > 0) load_step(0, 0, 0, true, true);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    const int st = F::ST == 1 ? 0 : s & 1;
    const float* const B1 = Bs + st * 2 * C * LD;
    const float* const B2 = B1 + C * LD;
    const int c0 = step_row0(s);
    float sacc[4][4], dacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = dacc[i][j] = 0.f;
    // S and dP, chunk by chunk of D columns in order (one chunk unless the
    // head dim is split), every chunk's block alike
    for (int cc = 0; cc < nc; ++cc) {
      cp_async_wait<0>();  // this chunk's tiles
      __syncthreads();     // ... from every thread; and step s - 1 is done
      if (F::ST == 2 && cc == 0 && s + 1 < n_steps) {  // its stage is free: step s + 1
        // loads behind this one
        load_step(s + 1, st ^ 1, 0, true, true);
        cp_async_commit();
      }
      if constexpr (F::CTAS == 2) {  // 128 registers: one product's operands at a time
#pragma unroll 1
        for (int n = 0; n < D / (4 * G); ++n) fma_4x4<F>(A1, B1, sr, sc, 4 * (gs + G * n), sacc);
#pragma unroll 1
        for (int n = 0; n < D / (4 * G); ++n) fma_4x4<F>(A2, B2, sr, sc, 4 * (gs + G * n), dacc);
      } else {  // both products' loads in flight together
#pragma unroll 2
        for (int n = 0; n < D / (4 * G); ++n) {
          const int d = 4 * (gs + G * n);
          fma_4x4<F>(A1, B1, sr, sc, d, sacc);
          fma_4x4<F>(A2, B2, sr, sc, d, dacc);
        }
      }
      if (cc + 1 < nc) {
        __syncthreads();  // every thread is done with chunk cc
        load_rows(A1, a1b, a1s, r0, R, La, (cc + 1) * D);
        load_rows(A2, a2b, a2s, r0, R, La, (cc + 1) * D);
        load_step(s, st, (cc + 1) * D, true, false);
        cp_async_commit();
      }
    }
    if (nc > 1 && z != nc - 1) {  // the products take this block's own chunk
      __syncthreads();
      load_step(s, st, z * D, DKV, false);  // K; or Q and dO
      cp_async_commit();
    }
    // the G partial sums, by a butterfly: every lane ends with the same sums
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sacc[i][j] += __shfl_xor_sync(0xffffffffu, sacc[i][j], off);
          dacc[i][j] += __shfl_xor_sync(0xffffffffu, dacc[i][j], off);
        }
    // P and dS of the pairs (flash.py:406-412, :443, :489), stored transposed
    // (Tt was last read by step s - 1's products, done before the sync above)
    const float* const lr = DKV ? rows + st * 2 * C : rows;  // lse; D at + C (or + R)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j % G != gs) continue;
      const int cl = sc + j * F::NSG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = sr + i * F::NRG;
        const int qi = DKV ? c0 + cl : r0 + rl, kj = DKV ? r0 + rl : c0 + cl;
        const float lse = DKV ? lr[cl] : lr[rl];
        const float dd = DKV ? lr[C + cl] : lr[R + rl];
        const bool ok = qi < Lq && kj < Lk && (!causal || qi >= kj);  // top-left causal
        const float pr = ok ? expf(sacc[i][j] * p.scale - lse) : 0.f;
        const float ds = pr * (dacc[i][j] - dd);
        if constexpr (DKV) {
          Tt[cl * LDM + rl] = pr;
          Tt[(C + cl) * LDM + rl] = ds;
        } else {
          Tt[cl * LDM + rl] = ds;
        }
      }
    }
    if (nc > 1) cp_async_wait<0>();  // this block's chunk (ST 2 keeps step s + 1's in flight)
    __syncthreads();                  // P and dS from every thread

    // dQ += dS K; or dV += P^T dO and dK += dS^T Q
#pragma unroll(F::CTAS == 2 ? 2 : 4)
    for (int c = 0; c < C; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(Tt + c * LDM + orow);
      const float tr[4] = {t.x, t.y, t.z, t.w};
      float ur[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (DKV) {
        const float4 u = *reinterpret_cast<const float4*>(Tt + (C + c) * LDM + orow);
        ur[0] = u.x; ur[1] = u.y; ur[2] = u.z; ur[3] = u.w;
      }
#pragma unroll
      for (int m = 0; m < CH; ++m) {
        const int col = 4 * (ocg + F::NCG * m);
        const float4 x = *reinterpret_cast<const float4*>((DKV ? B2 : B1) + c * LD + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][m].x = fmaf(tr[i], x.x, acc[i][m].x);
          acc[i][m].y = fmaf(tr[i], x.y, acc[i][m].y);
          acc[i][m].z = fmaf(tr[i], x.z, acc[i][m].z);
          acc[i][m].w = fmaf(tr[i], x.w, acc[i][m].w);
        }
        if constexpr (DKV) {
          const float4 y = *reinterpret_cast<const float4*>(B1 + c * LD + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc2[i][m].x = fmaf(ur[i], y.x, acc2[i][m].x);
            acc2[i][m].y = fmaf(ur[i], y.y, acc2[i][m].y);
            acc2[i][m].z = fmaf(ur[i], y.z, acc2[i][m].z);
            acc2[i][m].w = fmaf(ur[i], y.w, acc2[i][m].w);
          }
        }
      }
    }
    if (s + 1 < n_steps && (F::ST == 1 || nc > 1)) {
      __syncthreads();  // every thread is done with this step's tiles
      if (nc > 1) {     // chunk 0 of the resident rows again
        load_rows(A1, a1b, a1s, r0, R, La, 0);
        load_rows(A2, a2b, a2s, r0, R, La, 0);
      }
      load_step(s + 1, 0, 0, true, true);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // (no step at all: the prologue's loads)

  // this chunk's columns: dQ, or dK and dV, of the rows (scale in f32)
  const int64_t width = int64_t(nc) * D;
  const float scale = p.scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + orow + i;
    if (row >= La) continue;
    const int64_t o = DKV ? ((int64_t(b) * Lk + row) * KVH + kvh) * width + z * D
                          : ((int64_t(b) * Lq + row) * H + h) * width + z * D;
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const int col = 4 * (ocg + F::NCG * m);
      const float4 a = acc[i][m];
      if constexpr (DKV) {
        const float4 a2 = acc2[i][m];
        *reinterpret_cast<float4*>(out + o + col) =
            make_float4(a2.x * scale, a2.y * scale, a2.z * scale, a2.w * scale);
        *reinterpret_cast<float4*>(out2 + o + col) = a;
      } else {
        *reinterpret_cast<float4*>(out + o + col) =
            make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqSimt<D>::THREADS, DqSimt<D>::CTAS)
flash_bwd_dq_simt(Problem p, int nc, T* __restrict__ dq) {
  static_assert(std::is_same_v<T, float>, "the SIMT backward is the f32 kernel");
  bwd_simt<D, false>(p, nc, dq, nullptr);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvSimt<D>::THREADS, DkvSimt<D>::CTAS)
flash_bwd_dkv_simt(Problem p, int nc, T* __restrict__ dk, T* __restrict__ dv) {
  static_assert(std::is_same_v<T, float>, "the SIMT backward is the f32 kernel");
  bwd_simt<D, true>(p, nc, dk, dv);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename... Out>
cudaError_t run(void (*kernel)(Problem, int, Out...), dim3 grid, int threads,
                size_t bytes, cudaStream_t stream, const Problem& p, int nc,
                Out... out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  // all of an SM's 228 KB as shared memory, so that two CTAs fit where
  // their tiles allow
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p, nc, out...);
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

// the SIMT kernels: one CTA per (R-row tile, batch x head or kv head, chunk)
template <int D>
cudaError_t launch_dq_simt(const Problem& p, int B, int nc, void* dq, cudaStream_t st) {
  using F = DqSimt<D>;
  return run(flash_bwd_dq_simt<float, D>, dim3((p.Lq + F::R - 1) / F::R, B * p.H, nc),
             F::THREADS, F::SMEM, st, p, nc, static_cast<float*>(dq));
}

template <int D>
cudaError_t launch_dkv_simt(const Problem& p, int B, int nc, void* dk, void* dv,
                            cudaStream_t st) {
  using F = DkvSimt<D>;
  return run(flash_bwd_dkv_simt<float, D>, dim3((p.Lk + F::R - 1) / F::R, B * p.KVH, nc),
             F::THREADS, F::SMEM, st, p, nc, static_cast<float*>(dk), static_cast<float*>(dv));
}

}  // namespace

// q, dout: [B, Lq, H, D]; k, v: [B, Lk, KVH, D], with element strides
// (batch, length, head) of q, k, v, dout in `strides` (12 values) and a
// contiguous head dim.  lse, delta: contiguous [B, H, Lq] f32.  dq:
// contiguous [B, Lq, H, D] in the input dtype.  dtype: 0 = f32, 1 = bf16,
// 2 = f16.  D: 64, 128, 256, 512 or a multiple of 512 (the wrapper pads
// other head dims); bf16 and f16 take the TMA kernel at every D, f32 the
// SIMT kernel; a multiple of 512 runs the 512-wide build with D / 512
// chunks (the TMA kernel a CTA per 256 columns of dQ, the SIMT kernel a
// block per 512).
// *route is set to the kernel launched (0 = flash_bwd_dq_tma,
// 2 = flash_bwd_dq_simt; 1 is retired).
// Returns a cudaError_t (0 = launched).
extern "C" int tfs_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int H,
                                int KVH, int Lq, int Lk, int D, int dtype,
                                int causal, const int64_t* strides,
                                float scale, void* stream, int* route) {
  if (!valid(B, H, H, KVH, Lq, Lk)) return int(cudaErrorInvalidValue);
  const Problem p = problem(q, k, v, dout, lse, delta, H, KVH, Lq, Lk, causal,
                            strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc;
  const int W = chunk_width(D, &nc);
#define TFS_DQ_TMA(TY, DD)                             \
  do {                                                 \
    *route = 0;                                        \
    return int(launch_dq<TY, DD>(p, B, nc, dq, st));   \
  } while (0)
#define TFS_DQ_SIMT(DD)                               \
  do {                                                \
    *route = 2;                                       \
    return int(launch_dq_simt<DD>(p, B, nc, dq, st)); \
  } while (0)
  if (dtype == 1 && W == 64) TFS_DQ_TMA(bf16, 64);
  if (dtype == 1 && W == 128) TFS_DQ_TMA(bf16, 128);
  if (dtype == 1 && W == 256) TFS_DQ_TMA(bf16, 256);
  if (dtype == 1 && W == 512) TFS_DQ_TMA(bf16, 512);
  if (dtype == 2 && W == 64) TFS_DQ_TMA(f16, 64);
  if (dtype == 2 && W == 128) TFS_DQ_TMA(f16, 128);
  if (dtype == 2 && W == 256) TFS_DQ_TMA(f16, 256);
  if (dtype == 2 && W == 512) TFS_DQ_TMA(f16, 512);
  if (dtype == 0 && W == 64) TFS_DQ_SIMT(64);
  if (dtype == 0 && W == 128) TFS_DQ_SIMT(128);
  if (dtype == 0 && W == 256) TFS_DQ_SIMT(256);
  if (dtype == 0 && W == 512) TFS_DQ_SIMT(512);
#undef TFS_DQ_TMA
#undef TFS_DQ_SIMT
  return int(cudaErrorInvalidValue);
}

// The same inputs; dk, dv: contiguous [B, Lk, KVH, D] in the input dtype.
// bf16 and f16 take the TMA kernel at every D (16-byte aligned bases and
// strides), f32 the SIMT kernel; a multiple of 512 runs the 512-wide
// build with D / 512 chunks of dK's and dV's columns.  *route is set to
// the kernel launched (0 = flash_bwd_dkv_tma, 2 = flash_bwd_dkv_simt).
extern "C" int tfs_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv, int B,
                                 int H, int KVH, int Lq, int Lk, int D,
                                 int dtype, int causal, const int64_t* strides,
                                 float scale, void* stream, int* route) {
  if (!valid(B, KVH, H, KVH, Lq, Lk)) return int(cudaErrorInvalidValue);
  const Problem p = problem(q, k, v, dout, lse, delta, H, KVH, Lq, Lk, causal,
                            strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc;
  const int W = chunk_width(D, &nc);
#define TFS_DKV_TMA(TY, DD)                                   \
  do {                                                        \
    *route = 0;                                               \
    return int(launch_dkv<TY, DD>(p, B, nc, dk, dv, st));     \
  } while (0)
#define TFS_DKV_SIMT(DD)                                    \
  do {                                                      \
    *route = 2;                                             \
    return int(launch_dkv_simt<DD>(p, B, nc, dk, dv, st));  \
  } while (0)
  if (dtype == 1 && W == 64) TFS_DKV_TMA(bf16, 64);
  if (dtype == 1 && W == 128) TFS_DKV_TMA(bf16, 128);
  if (dtype == 1 && W == 256) TFS_DKV_TMA(bf16, 256);
  if (dtype == 1 && W == 512) TFS_DKV_TMA(bf16, 512);
  if (dtype == 2 && W == 64) TFS_DKV_TMA(f16, 64);
  if (dtype == 2 && W == 128) TFS_DKV_TMA(f16, 128);
  if (dtype == 2 && W == 256) TFS_DKV_TMA(f16, 256);
  if (dtype == 2 && W == 512) TFS_DKV_TMA(f16, 512);
  if (dtype == 0 && W == 64) TFS_DKV_SIMT(64);
  if (dtype == 0 && W == 128) TFS_DKV_SIMT(128);
  if (dtype == 0 && W == 256) TFS_DKV_SIMT(256);
  if (dtype == 0 && W == 512) TFS_DKV_SIMT(512);
#undef TFS_DKV_TMA
#undef TFS_DKV_SIMT
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
