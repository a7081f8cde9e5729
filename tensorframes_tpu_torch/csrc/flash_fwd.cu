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
// ridge, so it is bound by operations: the tensor-core rate, which only
// wgmma reaches, and how well the loop keeps the tensor cores fed.
//
// What the design does about it (the 16-bit kernel flash_fwd_tma, the main
// path, one template instantiated for bf16 and f16 at Dh = 64, 128 and 256;
// the building blocks are in hopper.cuh):
//  * Warp roles.  One CTA owns one (batch*head, query tile).  Warpgroup 0
//    is the producer: one thread issues the TMA loads, Q once, then 128-key
//    (64 at Dh = 256) K and V tiles into a ring of STAGES slots guarded by
//    full and empty mbarriers.  setmaxnreg moves its registers to the
//    consumer warpgroups of 64 query rows each: three at Dh = 64
//    (192-query tiles: a third fewer K/V reads than 128-query tiles, and a
//    third warpgroup to overlap; measured faster), two at Dh = 128 and 256,
//    whose O accumulator leaves no registers for a third.  At Dh = 256 a
//    consumer needs ~200 registers, above the 168 ptxas allows a thread of
//    a 384-thread CTA whatever setmaxnreg grants: there the CTA is the two
//    consumer warpgroups alone (up to 255 registers a thread), and thread 0
//    refills the ring at the top of each step, once both consumers have
//    released the slot.
//  * S = Q K^T is wgmma m64n128k16 (m64n64k16 at Dh = 256) with both
//    operands in 128B-swizzled shared memory (K-major; Dh is the
//    reduction).  O += P V is wgmma m64nDk16 (two m64n128k16 at Dh = 256,
//    one per half of V's columns) with P in registers, cast to T straight
//    from the S accumulator (its layout is the A fragment's), and V read
//    MN-major through the transpose bit.  No thread loads an operand, so the per-warp
//    ldmatrix re-reads of Q, K and V of the earlier mma.sync design (~128 KB
//    of shared-memory reads per 64-key tile) are gone, and loads overlap the
//    products with no __syncthreads in the loop.
//  * Each consumer warpgroup runs its tile loop on its own (S, softmax,
//    P V), so one's softmax overlaps the others' products; the softmax is
//    one FMA per score into exp2 (the scale is folded in).
//  * The TPU kernel's sequential grid axis over K/V blocks (m, l and the
//    accumulator carried in VMEM scratch between grid steps) is the loop
//    over key tiles inside the CTA: GPU blocks run in no order, so nothing
//    carries between them.  m, l and O stay in registers.
//  * Causal: the tile loop ends at the diagonal, only tiles that cross it
//    (or the end of the keys) are masked, and the heavier (later) query
//    tiles of a head launch first.  Where a query tile is taller than a
//    key tile (Dh = 64 and 256), a consumer releases without compute the
//    trailing tiles wholly above its 64 rows (and every tile when its rows
//    are past the end).  The tiles of one
//    head are neighbours in the launch order, so the CTAs in flight share
//    a few heads' K and V in L2 (ordered the other way, by head first,
//    every tile came from device memory and the kernel was bound by it).
//  * Ragged ends: the descriptors bound L per batch and zero-fill, the
//    masks cover keys >= Lk, and rows >= Lq are not stored.
//  * GQA: query head h reads kv head h / (H / KVH), flash.py:_kv_head_map.
//  * Dh = 128 is two 64-column boxes per tile, and the ring has 2 stages
//    (Q 32 KB + 2 x 64 KB of shared memory); Dh = 64 has 4 (24 + 4 x 32 KB).
//    Dh = 256 is four boxes: the K and V tiles are 64 keys (32 KB each),
//    two stages beside a 128-row Q tile (64 KB + 2 x 64 KB), and the
//    consumers hold O as 128 f32 registers a thread beside S's 32.  Other head dims (1..256) reach the kernel
//    zero-padded to the next of the three by the wrapper
//    (parallel/flash.py): zero columns of Q and K leave Q K^T as it is, zero
//    columns of V give zero output columns.
// Numerics kept from the TPU kernel: P is cast to v's dtype before PV
// (flash.py:107-108), l sums the f32 p, the running max is -inf-safe
// (m_safe, alpha: flash.py:101-105), the causal mask is top-left (q >= k)
// when Lq != Lk, a row that sees no key outputs 0, and lse = m + log(l).
// Tried and slower on the H100 at the flagship shape, so not kept: issuing
// tile t + 1's scores behind tile t's P V inside a warpgroup (FA3's
// intra-warpgroup overlap; it also spills at Dh = 128), and ordering two
// consumers' products with named barriers (FA3's ping-pong).  What bounds
// the kernel now is each tile's chain of S, softmax and P V (PERF.md).
// f32 inputs take a plain FMA kernel (TF32 would lose precision the JAX
// reference keeps), and so do bf16 and f16 at Dh = 512 (head dims 257..512,
// padded): one template on the element type, tiles widened to f32 in shared
// memory, P rounded to the element type before P V as above.  A head dim
// above 512 (padded to a multiple of it) runs the 512-wide build split into
// chunks of 512 output columns, one grid axis over them.  Both are off the
// main path.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tfs_flash;
using namespace tfs_hopper;

// ---------------------------------------------------------------------------
// bf16 and f16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  // consumer warpgroups of 64 query rows each: three at Dh = 64 (a third
  // fewer K/V reads per query and one more warpgroup to overlap), two at
  // Dh = 128 and 256, whose O accumulator leaves no registers for a third
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  // keys per K/V tile: 128, and 64 at Dh = 256, where a 128-key K or V
  // tile is 64 KB and beside the 64 KB Q tile not even two stages of them
  // would fit; the S accumulator is then 32 registers beside O's 128
  static constexpr int BK = D == 256 ? 64 : 128;
  // The producer: a warpgroup before the consumers, whose registers
  // setmaxnreg moves to them (128 x 24 + 384 x 160 = 64512 = 512 x 126;
  // 128 x 40 + 256 x 232 = 64512 = 384 x 168).  ptxas allocates a thread
  // no more than its sub-partition's share, 16384 registers over the most
  // warps one of the SM's four holds (128 at 512 threads, 168 at 384),
  // whatever setmaxnreg grants; at Dh = 256 a consumer needs ~200 (O alone is 128).  There the
  // CTA is the two consumer warpgroups alone (two warps a sub-partition:
  // up to 255 registers a thread), and warp 0 refills the ring inline.
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
  // a key tile can lie wholly above a consumer's 64 rows only when the
  // query tile is taller than a key tile: then the consumer releases it
  // without compute (at Dh = 128 the test alone slowed the kernel by ~4%)
  static constexpr bool RELEASE = BQ > BK;
  // Q; K full, V full and empty per slot
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr size_t SMEM = size_t(Q_TILE) + size_t(TILE) * 2 * STAGES +
                                 8 * BARRIERS + ATOM_BYTES;
  static_assert(SMEM <= 232448, "forward tiles exceed a block's shared memory");
};

// flash_ring.cu::ring_step_tma holds a second copy of this loop (the
// same roles, ring, barrier phases, masks and early tile release) at
// Dh = 64 and 128, kept apart because one shared loop made this kernel
// 2-4% slower (PERF.md).  A fix to any of those here is made there too, and
// the other way round.  Only this copy is built at Dh = 256 (64-key tiles,
// O in two 128-column products): the ring step takes its FMA kernel there.
// The copies differ on purpose only in the prologue and epilogue (carry in
// and out there; 1/l and lse here), the global offsets of the mask, and
// alpha, which there is exactly 1 while the max holds.
template <typename T, int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              T* __restrict__ out, float* __restrict__ lse, int H, int KVH,
              int Lq, int Lk, int causal, float scale) {
  using F = Fwd<D>;
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
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + F::BQ, Lq) - 1) / BK + 1);

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
    constexpr int NT = BK / 8;          // 8-key column blocks of S
    constexpr int PT = F::PV_N / 8;     // 8-wide column blocks of one O part
    const int c = threadIdx.x / 128 - (F::INLINE_PRODUCER ? 0 : 1);
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
    const int wg0 = q0 + 64 * c;             // this warpgroup's first row
    const int wq0 = wg0 + 16 * w;            // this warp's first row
    const int row_a = wq0 + g, row_b = row_a + 8;  // this thread's two rows
    const float sl2 = scale * LOG2E;
    float o[F::PV_PARTS][PT * 4];
#pragma unroll
    for (int p = 0; p < F::PV_PARTS; ++p)
#pragma unroll
      for (int i = 0; i < PT * 4; ++i) o[p][i] = 0.f;
    // the running max of the raw scores (times scale: the softmax's max)
    // and the denominator of this thread's two rows
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
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
      // rows past the end, or a tile wholly above this warpgroup's rows
      // (the trailing tiles of its loop), add nothing: release the slot.
      // After the K wait, so the arrival counts for this use of the slot.
      if (F::RELEASE && (wg0 >= Lq || (causal && k0 > wg0 + 63))) {
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
      if ((k0 + BK > Lk) || (causal && k0 + BK - 1 > wq0)) {
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) {
          const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (col >= Lk || (causal && row < col)) sc[i] = -INFINITY;
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
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // -inf-safe: a row with no unmasked key yet keeps m = -inf and adds
      // zeros, never NaNs (flash.py:101-105); p = exp((s - m) * scale) as
      // one FMA into exp2
      const float ms_a = mn_a == -INFINITY ? 0.f : mn_a * sl2;
      const float ms_b = mn_b == -INFINITY ? 0.f : mn_b * sl2;
      const float al_a = m_a == -INFINITY ? 0.f : exp2_ftz(fmaf(m_a, sl2, -ms_a));
      const float al_b = m_b == -INFINITY ? 0.f : exp2_ftz(fmaf(m_b, sl2, -ms_b));
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
      l_a = al_a * l_a + sum_a;  // the f32 p, before its cast (flash.py:106)
      l_b = al_b * l_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int p = 0; p < F::PV_PARTS; ++p)
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          o[p][4 * j] *= al_a;
          o[p][4 * j + 1] *= al_a;
          o[p][4 * j + 2] *= al_b;
          o[p][4 * j + 3] *= al_b;
        }
      // p cast to T (v's dtype, flash.py:107-108): the A fragments of
      // the 16-key slices, straight from the score registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

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

    // finish (flash.py:115-122): out in T, lse = m + log(l)
    const float den_a = l_a == 0.f ? 1.f : l_a;
    const float den_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
    for (int p = 0; p < F::PV_PARTS; ++p)
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int col = p * F::PV_N + j * 8 + 2 * t4;
        if (row_a < Lq)
          *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_a) * H + h) * D + col) =
              pack2<T>(o[p][4 * j] / den_a, o[p][4 * j + 1] / den_a);
        if (row_b < Lq)
          *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_b) * H + h) * D + col) =
              pack2<T>(o[p][4 * j + 2] / den_b, o[p][4 * j + 3] / den_b);
      }
    if (t4 == 0) {
      if (row_a < Lq) lse[int64_t(bh) * Lq + row_a] = m_a * scale + logf(den_a);
      if (row_b < Lq) lse[int64_t(bh) * Lq + row_b] = m_b * scale + logf(den_b);
    }
  }
}

template <typename T, int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KVH, int Lq, int Lk,
                       int causal, const int64_t* s, float scale,
                       cudaStream_t stream) {
  using F = Fwd<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_tile_map<T>(&q_map, q, B, Lq, H, D, s[0], s[1], s[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, k, B, Lk, KVH, D, s[3], s[4], s[5], F::BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, v, B, Lk, KVH, D, s[6], s[7], s[8], F::BK);
  if (err != cudaSuccess) return err;
  const size_t bytes = F::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H);
  flash_fwd_tma<T, D><<<grid, F::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), lse, H, KVH, Lq, Lk,
      causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA kernel: f32 at every head dim, bf16 and f16 at Dh = 512 (two lanes
// per query row, tiles in shared memory as f32; FmaTiles in
// flash_common.cuh).  A head dim of nc * D (nc > 1: above the widest build,
// padded to a multiple of it) is split into nc chunks of D columns, one per
// blockIdx.z: every chunk's block forms S = sum_c Q_c K_c^T in chunk order,
// streaming the Q and K chunks through the shared tiles (so all of them
// run the same online softmax), and accumulates only its own chunk of O
// (P V_c); chunk 0 writes lse.  S is thus recomputed nc times.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(FmaTiles<D>::THREADS, 1)
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int H, int KVH, int Lq, int Lk,
              int causal, int nc, int64_t q_sb, int64_t q_sl, int64_t q_sh,
              int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
              int64_t v_sl, int64_t v_sh, float scale) {
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
  const int ch = blockIdx.z;  // this block's chunk of the output columns
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  if (nc == 1) load_tile_fma<T, D>(Qs, qb, q_sl, q0, BQ, Lq, tid, F::THREADS);
  for (int i = tid; i < BQ * O_LD; i += F::THREADS) Os[i] = 0.f;

  // lane pair (2r, 2r+1) owns row r of its warp: half the keys, half of Dh
  const int r = lane >> 1, half = lane & 1;
  const int wrow = warp * 16 + r;
  const int qrow = q0 + wrow;
  float* srow = Ss + wrow * S_LD + half * HK;
  float* orow = Os + wrow * O_LD + half * HALF;
  float m_i = -INFINITY, l_i = 0.f;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Lq) - 1) / BK + 1);

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
      srow[c] = round_to<T>(p);  // p cast to v's dtype (flash.py:107-108)
      sum += p;                  // l sums the f32 p (flash.py:106)
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
  __syncthreads();  // with no tile at all, Os holds only the zero fill

  if (qrow < Lq) {
    const float denom = l_i == 0.f ? 1.f : l_i;
    T* dst = out + ((int64_t(b) * Lq + qrow) * H + h) * (int64_t(nc) * D) + ch * D +
             half * HALF;
#pragma unroll 8
    for (int dd = 0; dd < HALF; ++dd) dst[dd] = from_f32<T>(orow[dd] / denom);
    if (half == 0 && ch == 0) lse[int64_t(bh) * Lq + qrow] = m_i + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KVH, int Lq, int Lk,
                       int causal, int nc, const int64_t* s, float scale,
                       cudaStream_t stream) {
  using F = FmaTiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H, nc);
  flash_fwd_fma<T, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KVH, Lq, Lk,
      causal, nc, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Lq, H, D], k/v: [B, Lk, KVH, D] with element strides
// (batch, length, head) each and a contiguous head dim; out: contiguous
// [B, Lq, H, D] in the input dtype; lse: contiguous [B, H, Lq] f32.
// dtype: 0 = f32, 1 = bf16, 2 = f16 (the 16-bit types take TMA up to
// D = 256: 16-byte aligned bases and strides, Lk > 0).  D: 64, 128, 256,
// 512 or a multiple of 512 (the wrapper pads other head dims); bf16 and
// f16 at 512, and f32 at every D, take the FMA kernel, and a multiple of
// 512 runs its 512-wide build split into D / 512 chunks of the output's
// columns.  *route is set to the kernel launched (0 = flash_fwd_tma,
// 1 = flash_fwd_fma).  Returns a cudaError_t (0 = launched).
extern "C" int tfs_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int H, int KVH,
                             int Lq, int Lk, int D, int dtype, int causal,
                             int64_t q_sb, int64_t q_sl, int64_t q_sh,
                             int64_t k_sb, int64_t k_sl, int64_t k_sh,
                             int64_t v_sb, int64_t v_sl, int64_t v_sh,
                             float scale, void* stream, int* route) {
  if (B * H > 65535 || KVH <= 0 || H % KVH != 0 || Lq <= 0 || Lk < 0)
    return int(cudaErrorInvalidValue);
  const int64_t s[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc;
  const int W = chunk_width(D, &nc);
#define TFS_FWD_TMA(TY, DD) \
  return *route = 0,        \
         int(launch_tma<TY, DD>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, s, scale, st))
#define TFS_FWD_FMA(TY, DD) \
  return *route = 1,        \
         int(launch_fma<TY, DD>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, nc, s, scale, st))
  if (dtype == 1 || dtype == 2) {
    if (Lk == 0) return int(cudaErrorInvalidValue);
    if (dtype == 1 && W == 64) TFS_FWD_TMA(bf16, 64);
    if (dtype == 1 && W == 128) TFS_FWD_TMA(bf16, 128);
    if (dtype == 1 && W == 256) TFS_FWD_TMA(bf16, 256);
    if (dtype == 1 && W == 512) TFS_FWD_FMA(bf16, 512);
    if (dtype == 2 && W == 64) TFS_FWD_TMA(f16, 64);
    if (dtype == 2 && W == 128) TFS_FWD_TMA(f16, 128);
    if (dtype == 2 && W == 256) TFS_FWD_TMA(f16, 256);
    if (dtype == 2 && W == 512) TFS_FWD_FMA(f16, 512);
  }
  if (dtype == 0 && W == 64) TFS_FWD_FMA(float, 64);
  if (dtype == 0 && W == 128) TFS_FWD_FMA(float, 128);
  if (dtype == 0 && W == 256) TFS_FWD_FMA(float, 256);
  if (dtype == 0 && W == 512) TFS_FWD_FMA(float, 512);
#undef TFS_FWD_TMA
#undef TFS_FWD_FMA
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

