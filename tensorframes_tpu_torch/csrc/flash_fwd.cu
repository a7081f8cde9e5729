// Flash-attention forward for Hopper (sm_90a).
//
// Replaces tensorframes_tpu/parallel/flash.py::_flash_kernel, the Pallas TPU
// kernel launched by _flash_fwd_impl (pallas_call at flash.py:177) and exposed
// as flash_attention.  It computes out = softmax(Q K^T * scale) V and the
// per-row logsumexp, with the online-softmax recurrence, so the [Lq, Lk]
// scores never reach device memory.  Two kernels, by element type:
//  * flash_fwd_tma<T, D>, bf16 and f16 at every head dim, on TMA + wgmma:
//    the narrow body (fwd_narrow) at D = 64, 128 and 256, the wide body
//    (fwd_wide) at D = 512 and every multiple of it;
//  * flash_fwd_simt<float, D>, f32 at every head dim: exact f32 FMAs on
//    register tiles (TF32 would lose precision the JAX reference keeps).
// Other head dims reach the kernels zero-padded by the wrapper
// (parallel/flash.py) to the next of 64, 128, 256 and 512, or above 512 to a
// multiple of 512: zero columns of Q and K leave Q K^T as it is, zero
// columns of V give zero output columns.
//
// What bounds them on the H100: at the flagship shape (B=8, L=2048, H=16,
// Dh=64, causal, bf16) the work is ~69 GFLOP against ~17 MB of inputs and
// outputs, about 4000 FLOP per byte -- far above the card's ~295 FLOP/byte
// ridge -- so every build is bound by operations: in 16 bits the
// tensor-core rate, which only wgmma reaches, and how well the loop keeps
// the tensor cores fed; in f32 the FMA pipe (67 TFLOP/s), and how many FMAs
// each shared-memory load feeds.
//
// The narrow body (the building blocks are in hopper.cuh):
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
//    MN-major through the transpose bit.  No thread loads an operand, and
//    loads overlap the products with no __syncthreads in the loop.
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
//    are past the end).  The tiles of one head are neighbours in the launch
//    order, so the CTAs in flight share a few heads' K and V in L2.
//  * Ragged ends: the descriptors bound L per batch and zero-fill, the
//    masks cover keys >= Lk, and rows >= Lq are not stored.
//  * GQA: query head h reads kv head h / (H / KVH), flash.py:_kv_head_map.
//  * Dh = 128 is two 64-column boxes per tile, and the ring has 2 stages
//    (Q 32 KB + 2 x 64 KB of shared memory); Dh = 64 has 4 (24 + 4 x 32 KB).
//    Dh = 256 is four boxes: the K and V tiles are 64 keys (32 KB each),
//    two stages beside a 128-row Q tile (64 KB + 2 x 64 KB).
//  Tried and slower on the H100 at the flagship shape, so not kept: issuing
//  tile t + 1's scores behind tile t's P V inside a warpgroup (FA3's
//  intra-warpgroup overlap; it also spills at Dh = 128), and ordering two
//  consumers' products with named barriers (FA3's ping-pong).
//
// The wide body (Dh 512, and nc = Dh / 512 chunks above it), designed
// against what a CTA holds:
//  * Registers.  An O accumulator of 64 rows x 256 columns is 128 f32
//    registers a thread, and ptxas gives a thread of a 384-thread CTA only
//    168 (hopper.cuh, regs_dec): so the CTA is Dh 256's, two consumer
//    warpgroups of 64 query rows (128-row query tiles) and no producer
//    warpgroup, each holding O for 256 output columns beside S's 32
//    registers (64-key tiles) and P's 16.  The output columns are split
//    over CTAs: grid axis x runs over (query tile, 256-column chunk z),
//    the chunks of one tile neighbours in the launch order, so they share
//    Q, K and V in L2.
//  * Products.  Every chunk's CTA forms the whole S = Q K^T (reduced over
//    all Dh columns) and its own 256 columns of P V.  The chunks' CTAs run
//    the same code on the same rows with nothing depending on z before the
//    P V product: the same wgmma sequence over the same shared tiles gives
//    the same S, so every chunk runs one softmax (the same m, l and P) by
//    construction.  The cost is S recomputed per chunk: 1.5x the least
//    products at Dh 512 (2 x 512 + 512 against 2 x 512 per (query, key)
//    and 256 columns), 2.5x at 1024, 3.5x at 1536.  Sharing one S between
//    warpgroups through shared memory would avoid it, at a shared-memory
//    round trip and a cross-warpgroup barrier per tile.
//  * Shared memory (232,448 bytes a block).  The reduction over Dh runs in
//    256-column halves (four 64-column boxes), each a wgmma m64n64k16 chain
//    of 16 steps.  Two half slots each hold a Q half (128 rows, 64 KB) and
//    a K half (64 keys, 32 KB), and one V slot this chunk's 256 columns of
//    64 keys (32 KB): 224 KB, static_assert'ed.  At Dh 512 (nc = 1) the Q
//    halves load with the first tile and stay; the K halves stream through
//    their slots, so K(t + 1) loads while tile t's softmax and P V run, and
//    V(t + 1) while tile t + 1's S runs.  Above 512 a 128-row Q tile (256
//    KB at 1024) does not fit: Q streams through the half slots beside K,
//    reloaded from L2 every key tile.
//  * Barriers: per half slot a full barrier (its TMA bytes) and an empty
//    one (8 warp arrivals), the same pair for V.  Thread 0 refills a slot
//    once all 8 warps released it, at the point where its own warp released
//    it; a warpgroup waits on a slot's full barrier before releasing it
//    even when it skips the tile, so every arrival counts for its use.
//
// The f32 kernel: the shape of a SIMT GEMM.  Each thread computes a 4 x 4
// micro-tile of S (4 query rows x 4 keys) from float4 loads of Q and K rows,
// so one 16-byte load feeds 8 FMAs, and a 4-row x 4*CH-column micro-tile of
// O from a float4 of P and CH float4s of V (8-13 FMAs a load; the FMA kernel
// it replaces made one load per FMA).  Rows of Q, K and V are padded so that
// a warp's loads hit distinct banks.  The K tile of the next step loads by
// cp.async while this tile's softmax and P V run, and the V tile while this
// tile's S runs.  Above 512 the 512-wide build runs per chunk of output
// columns (grid axis z), each chunk's CTA summing S over every chunk in
// chunk order, so all run one softmax.
//
// Numerics kept from the TPU kernel: P is cast to v's dtype before PV
// (flash.py:107-108), l sums the f32 p, the running max is -inf-safe
// (m_safe, alpha: flash.py:101-105), the causal mask is top-left (q >= k)
// when Lq != Lk, a row that sees no key outputs 0, lse = m + log(l), and
// only one chunk of a split head dim writes lse.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tfs_flash;
using namespace tfs_hopper;

// ---------------------------------------------------------------------------
// bf16 and f16: one key tile's online softmax, shared by both bodies
// ---------------------------------------------------------------------------

// The softmax step of one key tile (flash.py:94-108) on a consumer thread's
// fragment of S = Q K^T: sc holds its rows row_a and row_b at the NS / 4
// 8-key column blocks from key k0 (the wgmma accumulator layout,
// hopper.cuh).  Masks the keys past Lk and, causal, above the diagonal
// (only in a tile that crosses either; wq0 is the warp's first row),
// updates the running max m of the raw scores and the denominator l,
// rescales the NP parts of the O accumulator, and packs p, cast to T (v's
// dtype, flash.py:107-108), into pa: the A fragments of the 16-key slices
// of P V, straight from the score registers.
template <typename T, int NS, int NP, int NO>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&o)[NP][NO],
                                             uint32_t (&pa)[NS / 8][4], float& m_a,
                                             float& m_b, float& l_a, float& l_b, int k0,
                                             int Lk, int causal, int wq0, int row_a,
                                             int row_b, int t4, float sl2) {
  constexpr int NT = NS / 4, BK = NT * 8;
  if ((k0 + BK > Lk) || (causal && k0 + BK - 1 > wq0)) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
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
  // zeros, never NaNs (flash.py:101-105); p = exp((s - m) * scale) as one
  // FMA into exp2
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
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[p][4 * j] *= al_a;
      o[p][4 * j + 1] *= al_a;
      o[p][4 * j + 2] *= al_b;
      o[p][4 * j + 3] *= al_b;
    }
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// bf16 and f16 at Dh 64, 128 and 256: the narrow body of flash_fwd_tma
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  // consumer warpgroups of 64 query rows each: three at Dh = 64 (a third
  // fewer K/V reads per query and one more warpgroup to overlap), two at
  // Dh = 128 and 256, whose O accumulator leaves no registers for a third
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int OW = D;  // output columns per CTA
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
__device__ __forceinline__ void fwd_narrow(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                           const CUtensorMap& v_map, T* __restrict__ out,
                                           float* __restrict__ lse, int H, int KVH, int Lq,
                                           int Lk, int causal, float scale) {
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

      // the online softmax; p cast to T (v's dtype) as P V's A fragments
      uint32_t pa[BK / 16][4];
      softmax_tile<T>(sc, o, pa, m_a, m_b, l_a, l_b, k0, Lk, causal, wq0, row_a, row_b, t4,
                      sl2);

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

// ---------------------------------------------------------------------------
// bf16 and f16 at Dh 512 and its multiples: the wide body of flash_fwd_tma
// ---------------------------------------------------------------------------

template <>
struct Fwd<512> {
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
  static_assert(SMEM <= 232448, "wide forward tiles exceed a block's shared memory");
  static_assert(OW == 2 * 128, "O is two m64n128 products a warpgroup");
};

template <typename T>
__device__ __forceinline__ void fwd_wide(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, T* __restrict__ out,
                                         float* __restrict__ lse, int H, int KVH, int Lq,
                                         int Lk, int causal, float scale, int nc) {
  using F = Fwd<512>;
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
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + F::BQ, Lq) - 1) / BK + 1);
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
  if (threadIdx.x == 0) {
    load_half(0);
    load_half(1);  // n_halves >= NH >= 2
    load_v(0);
  }

  const int c = threadIdx.x / 128;  // this warpgroup: rows 64 c .. 64 c + 63
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int wg0 = q0 + 64 * c;
  const int wq0 = wg0 + 16 * w;
  const int row_a = wq0 + g, row_b = row_a + 8;

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

  constexpr int NT = BK / 8;  // 8-key column blocks of S
  constexpr int PT = 128 / 8;  // 8-column blocks of one O part (m64n128)
  const float sl2 = scale * LOG2E;
  float o[2][PT * 4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < PT * 4; ++i) o[p][i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  // A of S = Q K^T: this warpgroup's 64 rows of a Q half
  const uint64_t q_desc = sw128_desc(Qs + 64 * c * 128, 16, ATOM_BYTES);
  const uint64_t k_desc = sw128_desc(Ks, 16, ATOM_BYTES);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // rows past the end, or a tile wholly above this warpgroup's rows:
    // nothing to add, only the tile's slots to release
    const bool idle = wg0 >= Lq || (causal && k0 > wg0 + 63);
    // S = Q K^T over the NH halves in order; half hh's products run while
    // half hh + 1 arrives, and half hh - 1's slot is released once its
    // products are done (one commit group stays in flight)
    float sc[NT * 4];
    for (int hh = 0; hh < NH; ++hh) {
      const int j = t * NH + hh, s = j & 1;
      mbar_wait(full + s, (j >> 1) & 1);
      if (!idle) {
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
      }
      if (hh > 0) {
        if (!idle) wgmma_wait<1>();
        release_half(j - 1);
      }
    }
    if (!idle) {
      wgmma_wait<0>();
      fence_regs(sc);
    }
    release_half(t * NH + NH - 1);
    if (idle) {
      mbar_wait(v_full, t & 1);
      release_v(t);
      continue;
    }

    // the online softmax; p cast to T (v's dtype) as P V's A fragments
    uint32_t pa[BK / 16][4];
    softmax_tile<T>(sc, o, pa, m_a, m_b, l_a, l_b, k0, Lk, causal, wq0, row_a, row_b, t4, sl2);

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

  // finish (flash.py:115-122): this chunk's columns of out in T; chunk 0
  // writes lse = m + log(l)
  const int64_t width = int64_t(NH) * F::OW;
  const float den_a = l_a == 0.f ? 1.f : l_a;
  const float den_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int col = z * F::OW + p * 128 + j * 8 + 2 * t4;
      if (row_a < Lq)
        *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_a) * H + h) * width + col) =
            pack2<T>(o[p][4 * j] / den_a, o[p][4 * j + 1] / den_a);
      if (row_b < Lq)
        *reinterpret_cast<uint32_t*>(out + ((int64_t(b) * Lq + row_b) * H + h) * width + col) =
            pack2<T>(o[p][4 * j + 2] / den_b, o[p][4 * j + 3] / den_b);
    }
  if (z == 0 && t4 == 0) {
    if (row_a < Lq) lse[int64_t(bh) * Lq + row_a] = m_a * scale + logf(den_a);
    if (row_b < Lq) lse[int64_t(bh) * Lq + row_b] = m_b * scale + logf(den_b);
  }
}

// The 16-bit forward: the narrow body at Dh 64, 128 and 256, the wide one
// at 512 (nc chunks of 512 columns: the head dim is 512 nc)
template <typename T, int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              T* __restrict__ out, float* __restrict__ lse, int H, int KVH,
              int Lq, int Lk, int causal, float scale, int nc) {
  if constexpr (D == 512)
    fwd_wide<T>(q_map, k_map, v_map, out, lse, H, KVH, Lq, Lk, causal, scale, nc);
  else
    fwd_narrow<T, D>(q_map, k_map, v_map, out, lse, H, KVH, Lq, Lk, causal, scale);
}

template <typename T, int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KVH, int Lq, int Lk,
                       int causal, int nc, const int64_t* s, float scale,
                       cudaStream_t stream) {
  using F = Fwd<D>;
  const int width = D * nc;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_tile_map<T>(&q_map, q, B, Lq, H, width, s[0], s[1], s[2], F::BQ);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&k_map, k, B, Lk, KVH, width, s[3], s[4], s[5], F::BK);
  if (err == cudaSuccess)
    err = make_tile_map<T>(&v_map, v, B, Lk, KVH, width, s[6], s[7], s[8], F::BK);
  if (err != cudaSuccess) return err;
  const size_t bytes = F::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_tma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ * (width / F::OW), B * H);
  flash_fwd_tma<T, D><<<grid, F::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), lse, H, KVH, Lq, Lk,
      causal, scale, nc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the register-tiled SIMT kernel
// ---------------------------------------------------------------------------

// The tiling at head dim D (each chunk of a wider one), 256 threads:
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
  static_assert(SMEM <= 232448, "f32 forward tiles exceed a block's shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(Simt<D>::THREADS, D >= 512 ? 1 : 2)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int H, int KVH, int Lq, int Lk,
               int causal, int nc, int64_t q_sb, int64_t q_sl, int64_t q_sh,
               int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
               int64_t v_sl, int64_t v_sh, float scale) {
  static_assert(std::is_same_v<T, float>, "the SIMT forward is the f32 kernel");
  using F = Simt<D>;
  constexpr int BQ = F::BQ, BK = F::BK, G = F::G, LD = F::LD;
  extern __shared__ __align__(16) float smem_f[];
  float* const Qs = smem_f;
  float* const Ks = Qs + BQ * LD;
  float* const Vs = Ks + BK * LD;
  float* const Ss = Vs + BK * LD;
  float* const Pt = Ss + BQ * F::LDS;
  float* const alpha_s = Pt + BK * F::LDP;
  float* const l_s = alpha_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = int(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int z = blockIdx.z;  // this block's chunk of the output columns
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Lq) - 1) / BK + 1);

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

  float4 o[4][F::CH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < F::CH; ++m) o[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_i = -INFINITY, l_i = 0.f;  // row sr's running max (scaled) and sum

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

    // the online softmax of row sr (flash.py:94-108)
    {
      const int qrow = q0 + sr;
      float sv[BK / F::RT];
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < BK / F::RT; ++kk) {
        const int col = lr + F::RT * kk, j = k0 + col;
        const bool ok = j < Lk && (!causal || qrow >= j);  // top-left causal
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

  // finish (flash.py:115-122): this chunk's columns of out; chunk 0
  // writes lse = m + log(l)
  const float den = l_i == 0.f ? 1.f : l_i;
  if (lr == 0) l_s[sr] = den;
  if (lr == 0 && z == 0 && q0 + sr < Lq) lse[int64_t(bh) * Lq + q0 + sr] = m_i + logf(den);
  __syncthreads();
  const int64_t width = int64_t(nc) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + orow + i;
    if (row >= Lq) continue;
    const float d = l_s[orow + i];
    float* dst = out + ((int64_t(b) * Lq + row) * H + h) * width + z * D;
#pragma unroll
    for (int m = 0; m < F::CH; ++m) {
      const float4 r = o[i][m];
      *reinterpret_cast<float4*>(dst + 4 * (ocg + F::NCG * m)) =
          make_float4(r.x / d, r.y / d, r.z / d, r.w / d);
    }
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int H, int KVH, int Lq, int Lk,
                        int causal, int nc, const int64_t* s, float scale,
                        cudaStream_t stream) {
  using F = Simt<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + F::BQ - 1) / F::BQ, B * H, nc);
  flash_fwd_simt<float, D><<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, KVH, Lq, Lk,
      causal, nc, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Lq, H, D], k/v: [B, Lk, KVH, D] with element strides
// (batch, length, head) each, a contiguous head dim and 16-byte aligned
// rows; out: contiguous [B, Lq, H, D] in the input dtype; lse: contiguous
// [B, H, Lq] f32.  dtype: 0 = f32, 1 = bf16, 2 = f16 (the 16-bit types:
// TMA, so 16-byte aligned bases and strides, Lk > 0).  D: 64, 128, 256, 512
// or a multiple of 512 (the wrapper pads other head dims), a multiple of
// 512 running the 512-wide build with D / 512 chunks.  *route is set to the
// kernel launched (0 = flash_fwd_tma, 2 = flash_fwd_simt; 1, the ring
// step's FMA route, is not taken here).  Returns a cudaError_t (0 =
// launched).
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
         int(launch_tma<TY, DD>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, nc, s, scale, st))
#define TFS_FWD_SIMT(DD) \
  return *route = 2,     \
         int(launch_simt<DD>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, nc, s, scale, st))
  if (dtype == 1 || dtype == 2) {
    if (Lk == 0) return int(cudaErrorInvalidValue);
    if (dtype == 1 && W == 64) TFS_FWD_TMA(bf16, 64);
    if (dtype == 1 && W == 128) TFS_FWD_TMA(bf16, 128);
    if (dtype == 1 && W == 256) TFS_FWD_TMA(bf16, 256);
    if (dtype == 1 && W == 512) TFS_FWD_TMA(bf16, 512);
    if (dtype == 2 && W == 64) TFS_FWD_TMA(f16, 64);
    if (dtype == 2 && W == 128) TFS_FWD_TMA(f16, 128);
    if (dtype == 2 && W == 256) TFS_FWD_TMA(f16, 256);
    if (dtype == 2 && W == 512) TFS_FWD_TMA(f16, 512);
  }
  if (dtype == 0 && W == 64) TFS_FWD_SIMT(64);
  if (dtype == 0 && W == 128) TFS_FWD_SIMT(128);
  if (dtype == 0 && W == 256) TFS_FWD_SIMT(256);
  if (dtype == 0 && W == 512) TFS_FWD_SIMT(512);
#undef TFS_FWD_TMA
#undef TFS_FWD_SIMT
  return int(cudaErrorInvalidValue);
}

extern "C" const char* tfs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
