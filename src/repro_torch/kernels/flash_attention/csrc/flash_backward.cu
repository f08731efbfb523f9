// K7b flash_attention_bwd: the gradient of K7's forward (dq, dk, dv from
// q, k, v and dO), exactly the function whose gradient autograd takes
// through ref.attention_ref: the same masks (kv_pos < skv; with causal
// kv_pos <= q_pos; with a window kv_pos > q_pos - window), GQA with H %
// K == 0, the scale after the dot, f32 accumulation, each gradient in
// its input's dtype (bf16 or f32).  A row whose keys are all masked (only
// a window past skv makes one) behaves as attention_ref's autograd does:
// its softmax is uniform over the skv keys, so dv takes 1 / skv of its dO
// and dq and dk take nothing (the mask's where blocks them).
//
// It replaces no TPU kernel: repro/kernels/flash_attention/kernel.py:35
// (_flash_kernel) has no VJP, and the JAX package trains through XLA's
// gradient of models/attention.chunked_attention.  The port's training
// path runs K7 forward, so it needs K7's backward; a plain-PyTorch one
// would hold [B, H, S, S] scores per layer.
//
// Bound.  Five products of 2 * D operations per live (q, kv) pair per head
// (S = Q K^T recomputed, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ +=
// dS K), over 989 TFLOP/s for bf16 or 67 TFLOP/s for f32; or the bytes of
// q, k, v, dO read once and dq, dk, dv written once over 3.35 TB/s.  At
// the training shapes the operations bind.
//
// Three passes, as three launches, no atomics: each output element has
// one writer and sums in a fixed order, so repeated calls are bit for bit
// the same.  A fused dQ would need atomics (run-to-run order) or a split
// reduction (a workspace of hundreds of MB at the training shapes).
//   1. stats, one block per (64-row q tile, q head, batch): K7's online
//      softmax over the live key tiles, O recomputed in f32, then per
//      row lse = m + log(l) and delta = sum_d dO * O (the f32 O: the
//      rounded output would put its rounding into delta); +inf and 0 for
//      a fully masked row (and, in bf16, for the rows that pad lse and
//      delta to a whole tile), so that their p below is 0.
//   2. dK/dV, one block per (64-key tile, kv head, batch): for each q
//      head of the group and each q tile that can see the keys, P =
//      exp(s - lse) and dS = P * (dP - delta) recomputed, dV += P^T dO and
//      dK += dS^T Q; dK scaled once at the end.  The group is summed
//      inside the block, so no two blocks write one key.
//   3. dQ, one block per (64-row q tile, q head, batch): dQ += dS K over
//      the live key tiles, scaled once at the end.
// Whole tiles outside the masks are skipped by bounding the loops with
// the forward's predicates (key_tiles; the q-tile range of pass 2), the
// element masks are skipped for a tile wholly inside them, and ragged
// rows are zero-filled and masked.  The grids run every head's heaviest
// tiles first (under a causal mask the last q tiles, the first key
// tiles): the tile index is the grid's z, the slowest, so the short
// blocks fill the card's tail.
//
// bf16 (fa_bwd_{stats,dkdv,dq}_wgmma_kernel<D>): every product on
// Hopper's tensor cores, wgmma m64nNk16 with bf16 in and f32 accumulate,
// one warpgroup (128 threads) a block, two blocks an SM.
//   S = Q K^T (S^T = K Q^T in pass 2) and dP = dO V^T (dP^T = V dO^T)
//   take both bf16 operands K-major from shared memory.  The
//   accumulating products (O += P V in pass 1, dV += P^T dO, dK += dS^T
//   Q, dQ += dS K) take P and dS as A fragments in registers straight
//   from the score accumulators (their layout is the fragment's), split
//   as K7's prefill splits P: x_hi = bf16(x) and x_lo = bf16(x - x_hi),
//   two products into one f32 accumulator, within about 2^-16 of the
//   f32 product; V, dO, Q and K are the B operand from shared memory,
//   transposed by wgmma's MN-major flag.
//   Tiles arrive by TMA: one thread asks for a 64-row tile as boxes of
//   min(D, 64) columns (a tensor map per operand, rows past the end read
//   as zeros), which land in the swizzled layout the descriptors read
//   (flash_wgmma.cuh) and complete on an mbarrier; pass 2's lse and delta
//   rows come by bulk copies on the same barrier.  The streamed operand
//   (K and V in passes 1 and 3; Q, dO, lse and delta in pass 2) has two
//   stages: tile t + 1 is asked for right after tile t's score products
//   are issued, in their shadow.  Per-thread cp.async copies cost the
//   warpgroup more issue time than the products they fed.
//   The exponentials are exp2f of a score scaled by scale * log2(e)
//   (one FMA and the special-function unit), the element masks touch only
//   tiles not wholly inside them, and in pass 2 dV's products run while
//   dS is formed.  Registers: pass 2 holds dK and dV (64 x D f32 each)
//   and the S^T and dP^T tiles (64 x 64 f32 each), about 250 a thread at
//   D = 128: __launch_bounds__(128, 1) allows 255, without a spill.
//   The scores sum on the tensor cores, whose k-step sums are coarser
//   than f32 (flash_prefill.cu's header): at the training shapes (QK-norm
//   keeps the scores small) that stays within K7_TOL; chip_smoke.py
//   reports, and does not gate, an input whose scores spread near 360.
//
// f32 (fa_bwd_{stats,dkdv,dq}_kernel<float, D>): every product an f32 FMA
// chain on the CUDA cores (TF32 is off in the port, and the f32 instance
// runs in the gradient checks only), 256-thread blocks, tiles staged in
// f32 with their 16-byte chunks XOR-swizzled by row so that both product
// shapes read free of bank conflicts.  Scores are thread-tiled 4 x 4
// (rows 4 ty + i, columns tx + 16 j), each one FMA chain over d in
// ascending order as in K7's kernels; the accumulating products give
// each thread RPT rows by 4 * CPT columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"
#include "rt_types.h"
#include "tma_map.h"

namespace {

constexpr int BT = FA_BWD_TILE;   // rows of every tile (q rows or keys)

__device__ __forceinline__ bool live(const FlashArgs& a, int q_pos,
                                     int kv_pos) {
  bool ok = kv_pos < a.skv;
  if (a.causal) ok = ok && kv_pos <= q_pos;
  if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
  return ok;
}

// every key of the row at q_pos is masked: only a window past skv does it
__device__ __forceinline__ bool fully_masked(const FlashArgs& a, int q_pos) {
  return a.window > 0 && q_pos >= a.skv + a.window - 1;
}

// the key tiles [t0, t1) some row of q rows [row0, row0 + 64) may attend
__device__ __forceinline__ void key_tiles(const FlashArgs& a, int row0,
                                          int& t0, int& t1) {
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + BT) - 1;
  t0 = a.window > 0 ? max(q_lo - a.window + 1, 0) / BT : 0;
  t1 = ((a.causal ? min(a.skv, q_hi + 1) : a.skv) + BT - 1) / BT;
}

// the q tiles [qt0, qt1) with a row that may see a key of the tile at key0
__device__ __forceinline__ void q_tiles(const FlashArgs& a, int key0,
                                        int& qt0, int& qt1) {
  const int k_hi = min(key0 + BT, a.skv) - 1;
  const int r_lo = a.causal ? max(key0 - a.q_offset, 0) : 0;
  const int r_hi = a.window > 0
                       ? min(a.Sq - 1, k_hi + a.window - 1 - a.q_offset)
                       : a.Sq - 1;
  qt0 = r_lo / BT;
  qt1 = r_lo <= r_hi ? r_hi / BT + 1 : qt0;
}

// the first fully masked row (Sq: none); every later row is one too
__device__ __forceinline__ int first_masked_row(const FlashArgs& a) {
  return a.window > 0
             ? min(max(a.skv + a.window - 1 - a.q_offset, 0), a.Sq)
             : a.Sq;
}

// lse and delta are [B, H, stat_rows]: Sq padded to whole tiles
__device__ __forceinline__ int stat_rows(const FlashArgs& a) {
  return (a.Sq + BT - 1) / BT * BT;
}

// every key of the tile at k_lo is live for every q row of [q_lo, q_hi]
__device__ __forceinline__ bool tile_inside(const FlashArgs& a, int q_lo,
                                            int q_hi, int k_lo) {
  return k_lo + BT <= a.skv && (!a.causal || k_lo + BT - 1 <= q_lo) &&
         (a.window == 0 || k_lo > q_hi - a.window);
}

// ============================================================== bf16

using bf16 = __nv_bfloat16;
using fa::Tile;

constexpr int WG = 128;           // threads of a bf16 block: one warpgroup
constexpr float L2E = 1.4426950408889634f;  // log2(e)

// mbarrier of a tile copy: initialised for one arrival, which also sets
// the bytes the copies will bring; waited on by parity
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one TMA box of a [B, S, heads, D] operand's map: columns c0 .. c0 +
// min(D, 64) of rows row0 .. row0 + 63 of head h, batch b (rows past S
// read as zeros), swizzled as the map says, completing on bar
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int h, int row0, int b,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(h),
      "r"(row0), "r"(b)
      : "memory");
}

// a 64-row tile (Tile<D>'s layout: one box a column block), by one thread
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                          int h, int row0, int b,
                                          uint32_t bar) {
  constexpr int C = D < 64 ? D : 64;
#pragma unroll
  for (int c = 0; c < D / C; ++c)
    tma_box(dst + c * 64 * Tile<D>::RB, map, c * C, h, row0, b, bar);
}

// bytes contiguous bytes (a multiple of 16, 16-byte aligned) completing on
// bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// barriers initialised -> visible to the copies and the other threads
__device__ __forceinline__ void bars_ready() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
}

// the element masks on a 64 x 64 accumulator (wgmma's layout) whose rows
// are q positions r0 + row and columns key positions c0 + column (with
// KEY_ROWS the other way round): a masked entry becomes fill.  Called
// only for a tile not wholly inside the masks.
template <bool KEY_ROWS>
__device__ __forceinline__ void mask_tile(float* acc, const FlashArgs& a,
                                          int r0, int c0, int rA, int tq,
                                          float fill) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + rA + 8 * hr, c = c0 + 8 * j + 2 * tq + e;
        if (!(KEY_ROWS ? live(a, c, r) : live(a, r, c)))
          acc[4 * j + 2 * hr + e] = fill;
      }
}

// acc (64 x 64) = A B^T: A and B 64-row tiles read K-major
template <int D>
__device__ __forceinline__ void wg_dots(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    fa::wgmma_ss_m64n64(acc, fa::desc_k<D>(a, kk), fa::desc_k<D>(b, kk),
                        kk > 0);
}

// acc (64 x D) += (A_hi + A_lo) X: A 64 x 64 as fragments, X the 64-row
// tile at x read MN-major
template <int D>
__device__ __forceinline__ void wg_acc(float* acc, const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4],
                                       uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = fa::desc_mn<D>(x, kk);
    fa::wgmma_pv<D>(acc, hi[kk], d);
    fa::wgmma_pv<D>(acc, lo[kk], d);
  }
}

// shared memory of a block, from a 1,024-byte aligned base: bf16 64-row
// tiles (Tile<D>::BYTES each), then pass 2's lse and delta stages; the
// tiles' mbarriers are static shared memory
template <int D>
struct WgSmem {
  static constexpr uint32_t TB = Tile<D>::BYTES;
  static constexpr uint32_t STATS_ROWS = 2 * BT * sizeof(float);  // a stage
  // stats: Q, then K and V in two stages each
  static constexpr size_t STATS = 5 * TB + 1024;
  // dK/dV: K, V, then Q and dO in two stages, then lse and delta
  static constexpr size_t DKDV = 6 * TB + 2 * STATS_ROWS + 1024;
  // dQ: Q, dO, then K and V in two stages each
  static constexpr size_t DQ = 6 * TB + 1024;
};

// pass 1: lse and delta of every q row
template <int D>
__global__ void __launch_bounds__(WG)
    fa_bwd_stats_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const bf16* __restrict__ dout,
                              float* __restrict__ lse,
                              float* __restrict__ delta, FlashArgs a) {
  constexpr uint32_t TB = WgSmem<D>::TB;
  constexpr int NS = BT / 8;               // n8 column groups of S
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // the two stages, Q
  const uint32_t base = (fa::smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t Qs = base, Ks = base + TB, Vs = base + 3 * TB;
  const uint32_t full = fa::smem_u32(bars), qbar = full + 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = lane & 3;
  const int rA = (tid >> 5) * 16 + (lane >> 2);  // accumulator row; + 8
  // every head's last q tiles first (the grid's z is slowest): under a
  // causal mask they hold the most key tiles, so the short ones fill the
  // card's tail
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t q_at = (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + BT) - 1;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  // K_t and V_t into stage s, by thread 0
  auto load_kv = [&](int t, int s) {
    const uint32_t bar = full + 8 * s;
    bar_expect(bar, 2 * TB);
    tma_tile<D>(Ks + s * TB, &mk, kvh, t * BT, b, bar);
    tma_tile<D>(Vs + s * TB, &mv, kvh, t * BT, b, bar);
  };
  if (tid == 0) {
    bar_init(full);
    bar_init(full + 8);
    bar_init(qbar);
  }
  bars_ready();
  if (tid == 0) {
    bar_expect(qbar, TB);
    tma_tile<D>(Qs, &mq, h, row0, b, qbar);
    if (t0 < t1) load_kv(t0, 0);
  }
  bar_wait(qbar, 0);

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {fa::NEG_INF, fa::NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    bar_wait(full + 8 * s, ((t - t0) >> 1) & 1);  // K_t and V_t landed
    __syncthreads();                     // and tile t - 1's stage is free
    float sacc[BT / 2];
    fa::wg_fence();
    wg_dots<D>(sacc, Qs, Ks + s * TB);
    fa::wg_commit();
    // the next tile's copies, issued in the product's shadow
    if (tid == 0 && t + 1 < t1) load_kv(t + 1, s ^ 1);
    fa::wg_wait0();
    fa::reg_fence<BT / 2>(sacc);

    // the scale, the masks and the online softmax, as K7's prefill
    const int k_lo = t * BT;
#pragma unroll
    for (int x = 0; x < BT / 2; ++x) sacc[x] *= a.scale;
    if (!tile_inside(a, q_lo, q_hi, k_lo))
      mask_tile<false>(sacc, a, q_lo, k_lo, rA, tq, fa::NEG_INF);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * hr], sacc[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = exp2f((m[hr] - m_new) * L2E);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f((sacc[4 * j + 2 * hr + e] - m_new) * L2E);
          sacc[4 * j + 2 * hr + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 2 * hr] *= alpha;
        oacc[4 * j + 2 * hr + 1] *= alpha;
      }
    }

    // O += P_hi V + P_lo V
    uint32_t ph[4][4], pl[4][4];
    fa::split_a64(sacc, ph, pl);
    fa::reg_fence<D / 2>(oacc);
    fa::wg_fence();
    wg_acc<D>(oacc, ph, pl, Vs + s * TB);
    fa::wg_commit();
    fa::wg_wait0();
    fa::reg_fence<D / 2>(oacc);
  }

  const size_t st_at = ((size_t)b * a.H + h) * stat_rows(a);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + rA + 8 * hr;
    const float den = fmaxf(l[hr], 1e-30f);
    float part = 0.f;
    if (r < a.Sq) {
      const bf16* orow = dout + q_at + (size_t)r * q_rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * j + 2 * tq));
        part = fmaf(g.x, oacc[4 * j + 2 * hr] / den, part);
        part = fmaf(g.y, oacc[4 * j + 2 * hr + 1] / den, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (tq == 0) {                         // every row of the tile: the
      const bool dead = r >= a.Sq ||       // padding is +inf and 0 too
                        fully_masked(a, a.q_offset + r);
      lse[st_at + r] = dead ? INFINITY : m[hr] + logf(l[hr]);
      delta[st_at + r] = dead ? 0.f : part;
    }
  }
}

// pass 2: dk and dv of one 64-key tile of one kv head, the group summed
template <int D>
__global__ void __launch_bounds__(WG, 1)
    fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mo,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             FlashArgs a) {
  using L = WgSmem<D>;
  constexpr uint32_t TB = L::TB;
  constexpr int NS = BT / 8;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // the two stages, K and V
  const uint32_t base = (fa::smem_u32(wg_smem) + 1023u) & ~1023u;
  const unsigned char* smem = wg_smem + (base - fa::smem_u32(wg_smem));
  // K, V; stage s: Q at QO + 2 s TB, dO one tile on; lse, delta at SO
  const uint32_t Ks = base, Vs = base + TB, QO = base + 2 * TB;
  const uint32_t SO = 6 * TB;
  const uint32_t full = fa::smem_u32(bars), kbar = full + 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = lane & 3;
  const int rA = (tid >> 5) * 16 + (lane >> 2);  // accumulator key; + 8
  // every head's first key tiles first (the grid's z is slowest): under
  // a causal mask the most q tiles see them
  const int key0 = blockIdx.z * BT;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.K;
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const size_t kv_at = (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const int SqP = stat_rows(a);
  const float sl2 = a.scale * L2E;

  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;

  if (key0 < a.skv) {
    int qt0, qt1;
    q_tiles(a, key0, qt0, qt1);
    const int nq = qt1 - qt0;
    const int n = G * nq;                  // (q head, q tile) steps
    // step i's Q, dO, lse and delta into stage s, by thread 0
    auto load = [&](int i, int s) {
      const int h = kvh * G + i / nq;
      const int row0 = (qt0 + i % nq) * BT;
      const uint32_t bar = full + 8 * s, qo = QO + 2 * s * TB;
      const size_t st = ((size_t)b * a.H + h) * SqP + row0;
      bar_expect(bar, 2 * TB + L::STATS_ROWS);
      tma_tile<D>(qo, &mq, h, row0, b, bar);
      tma_tile<D>(qo + TB, &mo, h, row0, b, bar);
      bulk_copy(base + SO + s * L::STATS_ROWS, lse + st, BT * 4, bar);
      bulk_copy(base + SO + s * L::STATS_ROWS + BT * 4, delta + st, BT * 4,
                bar);
    };
    if (tid == 0) {
      bar_init(full);
      bar_init(full + 8);
      bar_init(kbar);
    }
    bars_ready();
    if (tid == 0) {
      bar_expect(kbar, 2 * TB);
      tma_tile<D>(Ks, &mk, kvh, key0, b, kbar);
      tma_tile<D>(Vs, &mv, kvh, key0, b, kbar);
      if (n > 0) load(0, 0);
    }
    bar_wait(kbar, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i & 1;
      bar_wait(full + 8 * s, (i >> 1) & 1);  // step i's tiles landed
      __syncthreads();                     // and step i - 1's stage is free
      const uint32_t Qs = QO + 2 * s * TB, Os = Qs + TB;
      const float* Lr =
          reinterpret_cast<const float*>(smem + SO + s * L::STATS_ROWS);
      const float* Dr = Lr + BT;
      const int q_lo = a.q_offset + (qt0 + i % nq) * BT;
      const int q_hi = min(q_lo + BT, a.q_offset + a.Sq) - 1;

      // S^T = K Q^T and dP^T = V dO^T: keys rA + 8 hr, q rows 8 j + 2 tq
      // + e
      float sacc[BT / 2], pacc[BT / 2];
      fa::wg_fence();
      wg_dots<D>(sacc, Ks, Qs);
      wg_dots<D>(pacc, Vs, Os);
      fa::wg_commit();
      // the next step's copies, issued in the products' shadow
      if (tid == 0 && i + 1 < n) load(i + 1, s ^ 1);
      fa::wg_wait0();
      fa::reg_fence<BT / 2>(sacc);
      fa::reg_fence<BT / 2>(pacc);

      // P (0 where masked), then dV += P^T dO (hi + lo) in flight while
      // dS = P (dP - delta) is formed, then dK += dS^T Q
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 lr = *reinterpret_cast<const float2*>(Lr + 8 * j + 2 * tq);
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x)
          sacc[x] = exp2f(fmaf(sacc[x], sl2, -(x & 1 ? lr.y : lr.x) * L2E));
      }
      if (!tile_inside(a, q_lo, q_hi, key0))
        mask_tile<true>(sacc, a, key0, q_lo, rA, tq, 0.f);
      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
      fa::split_a64(sacc, ph, pl);
      fa::reg_fence<D / 2>(dva);
      fa::wg_fence();
      wg_acc<D>(dva, ph, pl, Os);
      fa::wg_commit();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 dr = *reinterpret_cast<const float2*>(Dr + 8 * j + 2 * tq);
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x)
          pacc[x] = sacc[x] * (pacc[x] - (x & 1 ? dr.y : dr.x));
      }
      fa::split_a64(pacc, sh, sl);
      fa::reg_fence<D / 2>(dka);
      fa::wg_fence();
      wg_acc<D>(dka, sh, sl, Qs);
      fa::wg_commit();
      fa::wg_wait0();
      fa::frag_fence(ph);                  // P's fragments stay put until
      fa::frag_fence(pl);                  // dV's products have read them
      fa::reg_fence<D / 2>(dva);
      fa::reg_fence<D / 2>(dka);
    }

    // the fully masked rows' uniform softmax: dv[t] += the sum of their
    // dO / skv for every key t < skv
    const int r_fm = first_masked_row(a);
    if (r_fm < a.Sq) {
      const float inv = 1.f / (float)a.skv;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float2 u = make_float2(0.f, 0.f);
        for (int g = 0; g < G; ++g) {
          const bf16* ob = dout + (size_t)b * a.Sq * q_rs +
                           (size_t)(kvh * G + g) * D + 8 * j + 2 * tq;
          for (int r = r_fm; r < a.Sq; ++r) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ob + r * q_rs));
            u.x += x.x;
            u.y += x.y;
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          if (key0 + rA + 8 * hr < a.skv) {
            dva[4 * j + 2 * hr] = fmaf(inv, u.x, dva[4 * j + 2 * hr]);
            dva[4 * j + 2 * hr + 1] = fmaf(inv, u.y, dva[4 * j + 2 * hr + 1]);
          }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = key0 + rA + 8 * hr;
    if (t < a.Skv) {
      const size_t at = kv_at + (size_t)t * kv_rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
            __floats2bfloat162_rn(dka[4 * j + 2 * hr] * a.scale,
                                  dka[4 * j + 2 * hr + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
            __floats2bfloat162_rn(dva[4 * j + 2 * hr],
                                  dva[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// pass 3: dq of one 64-row q tile of one q head
template <int D>
__global__ void __launch_bounds__(WG)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, FlashArgs a) {
  constexpr uint32_t TB = WgSmem<D>::TB;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // the two stages, Q and dO
  const uint32_t base = (fa::smem_u32(wg_smem) + 1023u) & ~1023u;
  // Q, dO, then K and V in two stages each
  const uint32_t Qs = base, Os = base + TB, Ks = base + 2 * TB,
                 Vs = base + 4 * TB;
  const uint32_t full = fa::smem_u32(bars), qbar = full + 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = lane & 3;
  const int rA = (tid >> 5) * 16 + (lane >> 2);
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t q_at = (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + BT) - 1;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  auto load_kv = [&](int t, int s) {
    const uint32_t bar = full + 8 * s;
    bar_expect(bar, 2 * TB);
    tma_tile<D>(Ks + s * TB, &mk, kvh, t * BT, b, bar);
    tma_tile<D>(Vs + s * TB, &mv, kvh, t * BT, b, bar);
  };
  if (tid == 0) {
    bar_init(full);
    bar_init(full + 8);
    bar_init(qbar);
  }
  bars_ready();
  if (tid == 0) {
    bar_expect(qbar, 2 * TB);
    tma_tile<D>(Qs, &mq, h, row0, b, qbar);
    tma_tile<D>(Os, &mo, h, row0, b, qbar);
    if (t0 < t1) load_kv(t0, 0);
  }
  float lr[2], dr[2];
  const size_t st_at = ((size_t)b * a.H + h) * stat_rows(a) + row0 + rA;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lr[hr] = lse[st_at + 8 * hr] * L2E;
    dr[hr] = delta[st_at + 8 * hr];
  }
  bar_wait(qbar, 0);

  const float sl2 = a.scale * L2E;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    bar_wait(full + 8 * s, ((t - t0) >> 1) & 1);  // K_t and V_t landed
    __syncthreads();                     // and tile t - 1's stage is free
    // S = Q K^T and dP = dO V^T: rows rA + 8 hr, keys 8 j + 2 tq + e
    float sacc[BT / 2], pacc[BT / 2];
    fa::wg_fence();
    wg_dots<D>(sacc, Qs, Ks + s * TB);
    wg_dots<D>(pacc, Os, Vs + s * TB);
    fa::wg_commit();
    // the next tile's copies, issued in the products' shadow
    if (tid == 0 && t + 1 < t1) load_kv(t + 1, s ^ 1);
    fa::wg_wait0();
    fa::reg_fence<BT / 2>(sacc);
    fa::reg_fence<BT / 2>(pacc);

    const int k_lo = t * BT;
#pragma unroll
    for (int x = 0; x < BT / 2; ++x)
      sacc[x] = exp2f(fmaf(sacc[x], sl2, -lr[(x >> 1) & 1]));
    if (!tile_inside(a, q_lo, q_hi, k_lo))
      mask_tile<false>(sacc, a, q_lo, k_lo, rA, tq, 0.f);
#pragma unroll
    for (int x = 0; x < BT / 2; ++x)
      pacc[x] = sacc[x] * (pacc[x] - dr[(x >> 1) & 1]);

    // dQ += dS_hi K + dS_lo K
    uint32_t sh[4][4], sl[4][4];
    fa::split_a64(pacc, sh, sl);
    fa::reg_fence<D / 2>(dqa);
    fa::wg_fence();
    wg_acc<D>(dqa, sh, sl, Ks + s * TB);
    fa::wg_commit();
    fa::wg_wait0();
    fa::reg_fence<D / 2>(dqa);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + rA + 8 * hr;
    if (r < a.Sq) {
      bf16* qrow = dq + q_at + (size_t)r * q_rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * hr] * a.scale,
                                  dqa[4 * j + 2 * hr + 1] * a.scale);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the TMA map of a bf16 [B, S, heads, D] operand: boxes of 64 rows by
// min(D, 64) columns (one swizzled column block of Tile<D>), rows past S
// read as zeros
template <int D>
bool operand_map(CUtensorMap* map, EncodeTiled enc, const void* p, int B,
                 int S, int heads) {
  constexpr int C = D < 64 ? D : 64;
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                             (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, 1, (cuuint32_t)BT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = Tile<D>::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : Tile<D>::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dim, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, float* lse, float* delta,
                             void* dq, void* dk, void* dv, const FlashArgs& a,
                             cudaStream_t stream) {
  using S = WgSmem<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!operand_map<D>(&mq, enc, q, a.B, a.Sq, a.H) ||
      !operand_map<D>(&mk, enc, k, a.B, a.Skv, a.K) ||
      !operand_map<D>(&mv, enc, v, a.B, a.Skv, a.K) ||
      !operand_map<D>(&mo, enc, dout, a.B, a.Sq, a.H))
    return cudaErrorInvalidValue;
  const bf16* ot = static_cast<const bf16*>(dout);
  cudaError_t e;
  if ((e = allow_smem(fa_bwd_stats_wgmma_kernel<D>, S::STATS)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dkdv_wgmma_kernel<D>, S::DKDV)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dq_wgmma_kernel<D>, S::DQ)) != cudaSuccess)
    return e;
  const dim3 qgrid(a.H, a.B, (a.Sq + BT - 1) / BT);
  const dim3 kgrid(a.K, a.B, (a.Skv + BT - 1) / BT);
  fa_bwd_stats_wgmma_kernel<D><<<qgrid, WG, S::STATS, stream>>>(
      mq, mk, mv, ot, lse, delta, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dkdv_wgmma_kernel<D><<<kgrid, WG, S::DKDV, stream>>>(
      mq, mk, mv, mo, ot, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dq_wgmma_kernel<D><<<qgrid, WG, S::DQ, stream>>>(
      mq, mk, mv, mo, lse, delta, static_cast<bf16*>(dq), a);
  return cudaGetLastError();
}

// =============================================================== f32

constexpr int NT = 256;       // threads per block

// float offset of (row r, column col) in a [rows][W] f32 tile whose
// 16-byte chunks are XOR-permuted by row (as flash_prefill_f32.cu's)
template <int W>
__device__ __forceinline__ int sw(int r, int col) {
  constexpr int CH = W / 4;
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  constexpr int SH = CH < 8 ? 1 : 0;
  return r * W + ((((col >> 2) ^ ((r >> SH) & MASK))) << 2) + (col & 3);
}

// four consecutive elements of an operand as floats, and back
template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

// the accumulating products' layout: NCG column groups of 16-byte chunks
// (CPT chunks a thread, NCG apart), NRG row groups of RPT rows
template <int D>
struct Lay {
  static constexpr int CH = D / 4;
  static constexpr int NCG = CH < 16 ? CH : 16;
  static constexpr int CPT = CH / NCG;
  static constexpr int NRG = NT / NCG;
  static constexpr int RPT = BT / NRG;
};

// rows [row0, row0 + 64) of a [rows][rs] operand (rows >= n zero-filled)
// into a swizzled f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t rs, int row0, int n) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < BT * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) x = Io<T>::load4(src + (size_t)(row0 + r) * rs + 4 * c);
    *reinterpret_cast<float4*>(dst + sw<D>(r, 4 * c)) = x;
  }
}

// s[i][j] = sum_d A[4 ty + i][d] * Bm[tx + 16 j][d], one FMA chain over d
// in ascending order
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dc = 0; dc < D / 4; ++dc) {
    float4 bb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(Bm + sw<D>(tx + 16 * j, 4 * dc));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 aa =
          *reinterpret_cast<const float4*>(A + sw<D>(4 * ty + i, 4 * dc));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(aa.x, bb[j].x, x);
        x = fmaf(aa.y, bb[j].y, x);
        x = fmaf(aa.z, bb[j].z, x);
        s[i][j] = fmaf(aa.w, bb[j].w, x);
      }
    }
  }
}

// the 4 x 4 thread tile s (rows 4 ty + i, columns tx + 16 j) into a
// swizzled [64 columns][64 rows] tile: column-major for tile_acc
__device__ __forceinline__ void store_t(float* P, int ty, int tx,
                                        const float s[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(P + sw<BT>(tx + 16 * j, 4 * ty)) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// acc[i][4 e + c] += sum_j P[j][RPT cy + i] * X[j][4 (cx + NCG e) + c]
// over j = 0..63 in ascending order; P [64][64] and X [64][D] swizzled
template <int D>
__device__ __forceinline__ void tile_acc(
    const float* P, const float* X, int cx, int cy,
    float (&acc)[Lay<D>::RPT][4 * Lay<D>::CPT]) {
  using L = Lay<D>;
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    float pr[L::RPT];
    if constexpr (L::RPT == 4) {
      const float4 x = *reinterpret_cast<const float4*>(P + sw<BT>(j, 4 * cy));
      pr[0] = x.x;
      pr[1] = x.y;
      pr[2] = x.z;
      pr[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) pr[i] = P[sw<BT>(j, L::RPT * cy + i)];
    }
#pragma unroll
    for (int e = 0; e < L::CPT; ++e) {
      const float4 xv =
          *reinterpret_cast<const float4*>(X + sw<D>(j, 4 * (cx + L::NCG * e)));
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        acc[i][4 * e] = fmaf(pr[i], xv.x, acc[i][4 * e]);
        acc[i][4 * e + 1] = fmaf(pr[i], xv.y, acc[i][4 * e + 1]);
        acc[i][4 * e + 2] = fmaf(pr[i], xv.z, acc[i][4 * e + 2]);
        acc[i][4 * e + 3] = fmaf(pr[i], xv.w, acc[i][4 * e + 3]);
      }
    }
  }
}

template <int D>
struct Smem {
  static constexpr int TILE = BT * D;
  // stats: Q, K, V, P^T, alpha, m, l
  static constexpr size_t STATS = sizeof(float) * (3 * TILE + BT * BT + 3 * BT);
  // dK/dV: K, V, Q, dO, P, dS, lse, delta
  static constexpr size_t DKDV = sizeof(float) * (4 * TILE + 2 * BT * BT + 2 * BT);
  // dQ: Q, dO, K, V, dS, lse, delta
  static constexpr size_t DQ = sizeof(float) * (4 * TILE + BT * BT + 2 * BT);
};

// pass 1: lse and delta of every q row, [B, H, Sq] each
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        float* __restrict__ lse, float* __restrict__ delta,
                        FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Qs = fb_smem;
  float* Ks = Qs + BT * D;
  float* Vs = Ks + BT * D;
  float* Ps = Vs + BT * D;
  float* As = Ps + BT * BT;
  float* Ms = As + BT;
  float* Ls = Ms + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BT;  // as the bf16 grids
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const T* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const int q_lo = a.q_offset + row0;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  load_tile<T, D>(Qs, qb, q_rs, row0, a.Sq);
  float acc[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fa::NEG_INF;
    l[i] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    __syncthreads();                       // the last tile is read
    load_tile<T, D>(Ks, kb, kv_rs, t * BT, a.skv);
    load_tile<T, D>(Vs, vb, kv_rs, t * BT, a.skv);
    __syncthreads();
    float s[4][4];
    tile_dots<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + 4 * ty + i;
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = s[i][j] * a.scale;
        s[i][j] = live(a, q_pos, t * BT + tx + 16 * j) ? sv : fa::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tx == 0) As[4 * ty + i] = alpha;
    }
    store_t(Ps, ty, tx, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::RPT; ++i) {
      const float al = As[L::RPT * cy + i];
#pragma unroll
      for (int c = 0; c < 4 * L::CPT; ++c) acc[i][c] *= al;
    }
    tile_acc<D>(Ps, Vs, cx, cy, acc);
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ms[4 * ty + i] = m[i];
      Ls[4 * ty + i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int rr = L::RPT * cy + i;
    const int r = row0 + rr;
    const float den = fmaxf(Ls[rr], 1e-30f);
    float part = 0.f;
    if (r < a.Sq) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e) {
        const float4 g =
            Io<T>::load4(ob + (size_t)r * q_rs + 4 * (cx + L::NCG * e));
        part = fmaf(g.x, acc[i][4 * e] / den, part);
        part = fmaf(g.y, acc[i][4 * e + 1] / den, part);
        part = fmaf(g.z, acc[i][4 * e + 2] / den, part);
        part = fmaf(g.w, acc[i][4 * e + 3] / den, part);
      }
    }
#pragma unroll
    for (int w = 1; w < L::NCG; w <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, w);
    if (cx == 0 && r < a.Sq) {
      const bool fm = fully_masked(a, a.q_offset + r);
      const size_t at = ((size_t)b * a.H + h) * stat_rows(a) + r;
      lse[at] = fm ? INFINITY : Ms[rr] + logf(Ls[rr]);
      delta[at] = fm ? 0.f : part;
    }
  }
}

// pass 2: dk and dv of one 64-key tile of one kv head, the group summed
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Ks = fb_smem;
  float* Vs = Ks + BT * D;
  float* Qs = Vs + BT * D;
  float* Os = Qs + BT * D;
  float* Ps = Os + BT * D;
  float* Ss = Ps + BT * BT;
  float* Lr = Ss + BT * BT;
  float* Dr = Lr + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int key0 = blockIdx.z * BT;        // as the bf16 grids
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.K;
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const size_t kv_at = (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  float dva[L::RPT][4 * L::CPT], dka[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) dva[i][c] = dka[i][c] = 0.f;

  if (key0 < a.skv) {
    load_tile<T, D>(Ks, k + kv_at, kv_rs, key0, a.skv);
    load_tile<T, D>(Vs, v + kv_at, kv_rs, key0, a.skv);
    int qt0, qt1;
    q_tiles(a, key0, qt0, qt1);
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const T* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
      const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)h * D;
      const size_t st = ((size_t)b * a.H + h) * stat_rows(a);
      for (int qt = qt0; qt < qt1; ++qt) {
        const int row0 = qt * BT;
        __syncthreads();                   // the last tiles are read
        load_tile<T, D>(Qs, qb, q_rs, row0, a.Sq);
        load_tile<T, D>(Os, ob, q_rs, row0, a.Sq);
        if (tid < BT) {
          const int r = row0 + tid;
          Lr[tid] = r < a.Sq ? lse[st + r] : INFINITY;
          Dr[tid] = r < a.Sq ? delta[st + r] : 0.f;
        }
        __syncthreads();
        // s^T and dP^T: keys 4 ty + i, rows tx + 16 j
        float s[4][4], dp[4][4];
        tile_dots<D>(Ks, Qs, ty, tx, s);
        tile_dots<D>(Vs, Os, ty, tx, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kv_pos = key0 + 4 * ty + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = tx + 16 * j;
            const float p = live(a, a.q_offset + row0 + rr, kv_pos)
                                ? expf(s[i][j] * a.scale - Lr[rr])
                                : 0.f;
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - Dr[rr]);
          }
        }
        store_t(Ps, ty, tx, s);            // [row][key]
        store_t(Ss, ty, tx, dp);
        __syncthreads();
        tile_acc<D>(Ps, Os, cx, cy, dva);  // dV[t] += sum_r P[r][t] dO[r]
        tile_acc<D>(Ss, Qs, cx, cy, dka);  // dK[t] += sum_r dS[r][t] Q[r]
      }
    }
    // the fully masked rows' uniform softmax: dv[t] += sum of their dO /
    // skv for every key t < skv
    const int r_fm = first_masked_row(a);
    if (r_fm < a.Sq) {
      float u[4 * L::CPT];
#pragma unroll
      for (int c = 0; c < 4 * L::CPT; ++c) u[c] = 0.f;
      for (int g = 0; g < G; ++g) {
        const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)(kvh * G + g) * D;
        for (int r = r_fm; r < a.Sq; ++r)
#pragma unroll
          for (int e = 0; e < L::CPT; ++e) {
            const float4 x =
                Io<T>::load4(ob + (size_t)r * q_rs + 4 * (cx + L::NCG * e));
            u[4 * e] += x.x;
            u[4 * e + 1] += x.y;
            u[4 * e + 2] += x.z;
            u[4 * e + 3] += x.w;
          }
      }
      const float inv = 1.f / (float)a.skv;
#pragma unroll
      for (int i = 0; i < L::RPT; ++i)
        if (key0 + L::RPT * cy + i < a.skv)
#pragma unroll
          for (int c = 0; c < 4 * L::CPT; ++c)
            dva[i][c] = fmaf(inv, u[c], dva[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int t = key0 + L::RPT * cy + i;
    if (t < a.Skv) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e) {
        const size_t at = kv_at + (size_t)t * kv_rs + 4 * (cx + L::NCG * e);
        Io<T>::store4(dk + at, make_float4(dka[i][4 * e] * a.scale,
                                           dka[i][4 * e + 1] * a.scale,
                                           dka[i][4 * e + 2] * a.scale,
                                           dka[i][4 * e + 3] * a.scale));
        Io<T>::store4(dv + at, make_float4(dva[i][4 * e], dva[i][4 * e + 1],
                                           dva[i][4 * e + 2],
                                           dva[i][4 * e + 3]));
      }
    }
  }
}

// pass 3: dq of one 64-row q tile of one q head
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Qs = fb_smem;
  float* Os = Qs + BT * D;
  float* Ks = Os + BT * D;
  float* Vs = Ks + BT * D;
  float* Ss = Vs + BT * D;
  float* Lr = Ss + BT * BT;
  float* Dr = Lr + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BT;  // as the bf16 grids
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const size_t q_at = (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const size_t st = ((size_t)b * a.H + h) * stat_rows(a);
  const int q_lo = a.q_offset + row0;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  load_tile<T, D>(Qs, q + q_at, q_rs, row0, a.Sq);
  load_tile<T, D>(Os, dout + q_at, q_rs, row0, a.Sq);
  if (tid < BT) {
    const int r = row0 + tid;
    Lr[tid] = r < a.Sq ? lse[st + r] : INFINITY;
    Dr[tid] = r < a.Sq ? delta[st + r] : 0.f;
  }
  float dqa[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) dqa[i][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();                       // the last tiles are read
    load_tile<T, D>(Ks, kb, kv_rs, t * BT, a.skv);
    load_tile<T, D>(Vs, vb, kv_rs, t * BT, a.skv);
    __syncthreads();
    // s and dP: rows 4 ty + i, keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<D>(Qs, Ks, ty, tx, s);
    tile_dots<D>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(a, q_lo + rr, t * BT + tx + 16 * j)
                            ? expf(s[i][j] * a.scale - Lr[rr])
                            : 0.f;
        dp[i][j] = p * (dp[i][j] - Dr[rr]);
      }
    }
    store_t(Ss, ty, tx, dp);               // [key][row]
    __syncthreads();
    tile_acc<D>(Ss, Ks, cx, cy, dqa);      // dQ[r] += sum_t dS[r][t] K[t]
  }

#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int r = row0 + L::RPT * cy + i;
    if (r < a.Sq) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e)
        Io<T>::store4(dq + q_at + (size_t)r * q_rs + 4 * (cx + L::NCG * e),
                      make_float4(dqa[i][4 * e] * a.scale,
                                  dqa[i][4 * e + 1] * a.scale,
                                  dqa[i][4 * e + 2] * a.scale,
                                  dqa[i][4 * e + 3] * a.scale));
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, float* lse, float* delta, void* dq,
                       void* dk, void* dv, const FlashArgs& a,
                       cudaStream_t stream) {
  using S = Smem<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t e;
  if ((e = allow_smem(fa_bwd_stats_kernel<T, D>, S::STATS)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dkdv_kernel<T, D>, S::DKDV)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dq_kernel<T, D>, S::DQ)) != cudaSuccess)
    return e;
  const dim3 qgrid(a.H, a.B, (a.Sq + BT - 1) / BT);
  const dim3 kgrid(a.K, a.B, (a.Skv + BT - 1) / BT);
  fa_bwd_stats_kernel<T, D><<<qgrid, NT, S::STATS, stream>>>(
      qt, kt, vt, ot, lse, delta, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dkdv_kernel<T, D><<<kgrid, NT, S::DKDV, stream>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dq_kernel<T, D><<<qgrid, NT, S::DQ, stream>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dim(const void* q, const void* k, const void* v,
                           const void* dout, float* lse, float* delta,
                           void* dq, void* dk, void* dv, const FlashArgs& a,
                           int bf16, cudaStream_t stream) {
  return bf16 ? launch_bwd_wgmma<D>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    a, stream)
              : launch_bwd<float, D>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     a, stream);
}

}  // namespace

cudaError_t launch_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const FlashArgs& a,
                                       int D, int bf16, cudaStream_t stream) {
  if (a.B == 0 || a.Sq == 0) return cudaSuccess;
  switch (D) {
    case 16:
      return launch_bwd_dim<16>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                                bf16, stream);
    case 32:
      return launch_bwd_dim<32>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                                bf16, stream);
    case 64:
      return launch_bwd_dim<64>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                                bf16, stream);
    case 128:
      return launch_bwd_dim<128>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                                 bf16, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
