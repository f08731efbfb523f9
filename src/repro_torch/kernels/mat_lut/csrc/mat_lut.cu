// K4 mat_lut_classify: the MAT classifier — compare-count quantize,
// per-feature LUT sum, arg-reduce, LabelMap — on a batch of feature rows
// -> int32 verdicts.
//
// Replaces the TPU kernel repro/kernels/mat_lut/kernel.py:41 (_kernel,
// launched by mat_pipeline_padded :82), which the split path serves a
// MAT suffix with (repro/core/pallas_backend.py:212-225).
//
// Bound: bytes.  Per row it reads F floats and writes one int; the edges
// and tables (F * (E + (E + 1) * C) floats: 4.4 KB at the mat-fused
// shape, 43 KB at the Tofino shape of path_generate) are read once.  The
// work is F * E compares and F * C adds per row, far below the card's
// rates, so what a launch costs is latency: the staging of the tables and
// the chains of dependent steps in a row.  The one-hot matmuls of the
// Pallas kernel (its gather idiom on the TPU's matrix unit) are plain
// indexed loads here.
//
// The function is K1's "mat" suffix's (csrc/mat_classify.cuh), bit for
// bit, but the schedule is K4's own:
//   Staging.  Thread 0 brings the edges and the tables into shared memory
//   with two bulk copies (cp.async.bulk, the TMA), each on an mbarrier of
//   its own, so a warp starts counting as soon as the edges land and its
//   first rows' loads overlap both copies.  Bulk copies move whole 16-byte
//   words: pack_mat pads the end of each buffer's storage to a multiple of
//   4 floats (K1 reads the same [F, E] and [F, E + 1, C] views).
//   Rows.  A warp takes R rows at once (8, or 4 when the edges are split
//   below), so each shared-memory load of an edge serves R independent
//   counts; the grid is ceil(B / (R * K4_WARPS)) blocks (at most
//   K4_MAX_BLOCKS, then the warps stride).  At the Tofino shape the
//   blocks' copies of the 43 KB of tables, not the counts, set the time
//   past about 100 blocks, so a block takes 16 rows there.
//   Bucket, the count of edges strictly below the value (searchsorted
//   side='left' as a compare-and-count, as the Pallas kernel counts: no
//   binary search, so ties, NaN, +-inf and an unsorted edge row count as
//   there).  Each compare is one FSET to a -1 / 0 mask, summed three at a
//   time.  The case follows from E, a constant of the packed tables:
//     E > 32 (SPLIT): the warp shares each feature's edges, lane l taking
//       edges l, l + 32, ... (neighbouring words: no bank conflict) of
//       pack_mat's copy of them padded with +inf to a multiple of 32 (no
//       value is above +inf, so no mask), and __reduce_add_sync gives the
//       exact count: about E / 32 compares and one reduction in series
//       instead of E; K4_FSPLIT features go at once, so their loads and
//       reductions overlap.
//     E <= 32: lane f counts feature f (and f + 32) alone.
//   Scores.  Every row's F table offsets go to the warp's slice of shared
//   memory first.  Then the warp's lanes split into groups of Cp (C
//   rounded up to a power of two, at most 32), one row a group and one
//   class a lane, so small C keeps every lane busy (C = 4: eight rows at
//   once).  Class c sums its features in ascending f from 0.0, the Pallas
//   kernel's order: in chunks of K4Chunk features a lane loads each
//   feature's offset and table entry first, then adds them in ascending
//   f, so the chain is F dependent adds, not F x (shuffle + load + add).
//   Then the masked arg-reduce over the group's lanes (arg_reduce.cuh,
//   ties to the lowest index) and the LabelMap entry, which
//   each lane holds in a register from the start (a shuffle, not a load at
//   the end of the chain).

#include <math.h>
#include <stdint.h>

#include "arg_reduce.cuh"
#include "rt_types.h"

namespace {

constexpr int K4_WARPS = 4;
constexpr int K4_THREADS = K4_WARPS * 32;
constexpr int K4_MAX_BLOCKS = 1024;
constexpr int K4_BATCH = 8;            // edges a lane loads, then compares
constexpr int K4_FSPLIT = 8;           // features a split count takes at once
constexpr int K4_OFF = 65;             // a row's offsets: >= F, = 1 mod 32
constexpr unsigned K4_FULL = 0xffffffffu;

template <bool SPLIT>
struct K4Rows {                        // rows a warp takes at once
  static constexpr int R = SPLIT ? 4 : 8;
};

// CPL classes per lane (C <= 32 CPL); chunk of features whose loads go
// out before their adds
template <int CPL>
struct K4Chunk {
  static constexpr int F = CPL == 1 ? 8 : 2;
};

__device__ __forceinline__ uint32_t k4_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void k4_bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(k4_smem(bar))
        : "memory");
}

// One thread: arm bar for n floats and copy them (n % 4 == 0, both ends
// 16-byte aligned); n == 0 completes the barrier's phase at once.
__device__ __forceinline__ void k4_stage(float* dst, const float* src,
                                         int n, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(k4_smem(bar)), "r"(4 * n)
               : "memory");
  if (n > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(k4_smem(dst)),
        "l"(src), "r"(4 * n), "r"(k4_smem(bar))
        : "memory");
}

// -1 where v > e, else 0 (NaN on either side: 0): one FSET, and the sums
// of such masks go three at a time (IADD3), not as increment chains
__device__ __forceinline__ int gt_mask(float v, float e) {
  int m;
  asm("set.gt.s32.f32 %0, %1, %2;" : "=r"(m) : "f"(v), "f"(e));
  return m;
}

// edges [F, ep]: ep = E (SPLIT false) or E rounded up to 32 with +inf
// past E (SPLIT true); cw = log2(Cp), the class lanes of a row group
template <bool SPLIT, int CPL>
__global__ void __launch_bounds__(K4_THREADS)
    mat_lut_kernel(const float* __restrict__ x, int B, MatDims m,
                   const float* __restrict__ edges, int ep,
                   const float* __restrict__ tables,
                   const int* __restrict__ lmap, int* __restrict__ out,
                   int ne4, int nt4, int cw) {
  constexpr int R = K4Rows<SPLIT>::R;
  constexpr int FC = K4Chunk<CPL>::F;
  // edges, tables, then K4_BATCH floats of slack that a lane's last batch
  // may read past its feature's edges (never counted)
  extern __shared__ __align__(16) float k4_buf[];
  __shared__ __align__(8) uint64_t bar[2];          // edges, tables
  __shared__ int offs_all[K4_WARPS][R * K4_OFF];    // [row][feature]
  const float* se = k4_buf;
  const float* st = k4_buf + ne4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* offs = offs_all[warp];
  const int F = m.F, E = m.E, C = m.C;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     k4_smem(bar))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     k4_smem(bar + 1))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    k4_stage(k4_buf, edges, ne4, bar);
    k4_stage(k4_buf + ne4, tables, nt4, bar + 1);
  }
  const int groups = (B + R - 1) / R;
  const int stride = gridDim.x * K4_WARPS;
  int g = blockIdx.x * K4_WARPS + warp;
  // lane f holds feature f and f + 32 of each of the group's rows
  float xv[R][2];
  auto load_rows = [&](int grp) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = grp * R + r;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = lane + 32 * q;
        xv[r][q] = p < B && f < F ? __ldg(x + (size_t)p * F + f) : 0.f;
      }
    }
  };
  if (g < groups) load_rows(g);      // in flight during the copies
  // the score lanes: row group rg (one row of a pass), class lane cl
  const int cp = 1 << cw;
  const int cl = lane & (cp - 1), rg = lane >> cw, rows = 32 >> cw;
  // lane l keeps the labels of classes l + 32 j
  int lm[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    lm[j] = lane + 32 * j < C ? __ldg(lmap + lane + 32 * j) : 0;
  __syncthreads();                   // the barriers are initialised
  // Warp 0 always has a group (the grid is no larger than the groups), so
  // the block outlives its copies.
  if (g >= groups) return;
  k4_bar_wait(bar);
  for (; g < groups; g += stride) {
    // offs[r * K4_OFF + f]: row r's table offset (f (E + 1) + bucket) C
    // of feature f; the counts are kept negated (sums of gt_mask)
    if constexpr (SPLIT) {
      const int J = ep >> 5;
      for (int f0 = 0; f0 < F; f0 += K4_FSPLIT) {
        int fh[K4_FSPLIT];           // past F: F - 1 again, same result
        float v[K4_FSPLIT][R];
        int neg[K4_FSPLIT][R];
#pragma unroll
        for (int h = 0; h < K4_FSPLIT; ++h) {
          fh[h] = min(f0 + h, F - 1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            v[h][r] = __shfl_sync(K4_FULL, fh[h] < 32 ? xv[r][0] : xv[r][1],
                                  fh[h] & 31);
            neg[h][r] = 0;
          }
        }
#pragma unroll 4
        for (int j = 0; j < J; ++j) {
          float ev[K4_FSPLIT];
#pragma unroll
          for (int h = 0; h < K4_FSPLIT; ++h)
            ev[h] = se[fh[h] * ep + lane + 32 * j];
#pragma unroll
          for (int h = 0; h < K4_FSPLIT; ++h)
#pragma unroll
            for (int r = 0; r < R; ++r) neg[h][r] += gt_mask(v[h][r], ev[h]);
        }
#pragma unroll
        for (int h = 0; h < K4_FSPLIT; ++h)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = __reduce_add_sync(K4_FULL, neg[h][r]);
            if (lane == 0)
              offs[r * K4_OFF + fh[h]] = (fh[h] * (E + 1) - n) * C;
          }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (32 * q >= F) break;
        const int f = lane + 32 * q;
        int neg[R];
#pragma unroll
        for (int r = 0; r < R; ++r) neg[r] = 0;
        // a lane past F counts F - 1's edges and stores nothing
        const float* e = se + min(f, F - 1) * E;
        for (int i0 = 0; i0 < E; i0 += K4_BATCH) {
          float ev[K4_BATCH];
#pragma unroll
          for (int u = 0; u < K4_BATCH; ++u) {
            ev[u] = e[i0 + u];
            ev[u] = i0 + u < E ? ev[u] : INFINITY;
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < K4_BATCH; ++u)
              neg[r] += gt_mask(xv[r][q], ev[u]);
        }
        if (f < F) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            offs[r * K4_OFF + f] = (f * (E + 1) - neg[r]) * C;
        }
      }
    }
    __syncwarp();                    // the offsets are written
    const int g_next = g + stride;   // the next group's rows fly now
    if (g_next < groups) load_rows(g_next);
    k4_bar_wait(bar + 1);
    for (int r0 = 0; r0 < R; r0 += rows) {
      const int r = r0 + rg;         // this lane's row of the pass
      const int* ro = offs + min(r, R - 1) * K4_OFF;
      float sc[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) sc[j] = 0.f;
      // no branch in a chunk: a feature past F reads F - 1's offset and
      // is not added, so every load of the chunk issues before its adds
      for (int f0 = 0; f0 < F; f0 += FC) {
        float tv[FC][CPL];
#pragma unroll
        for (int k = 0; k < FC; ++k) {
          const int o = ro[min(f0 + k, F - 1)];
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            tv[k][j] = st[o + min(cl + 32 * j, C - 1)];
        }
#pragma unroll
        for (int k = 0; k < FC; ++k) {
          const bool live = f0 + k < F;
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            sc[j] = live ? sc[j] + tv[k][j] : sc[j];
        }
      }
      const int id = warp_arg_reduce(sc, C, m.use_min != 0, cl, cp);
      // one row a warp when C > 32: every lane asks for the same register
      int l = lm[0];
#pragma unroll
      for (int j = 1; j < CPL; ++j) l = id >> 5 == j ? lm[j] : l;
      const int lab = __shfl_sync(K4_FULL, l, id & 31);
      const int p = g * R + r;
      if (cl == 0 && r < R && p < B) out[p] = lab;
    }
    __syncwarp();                    // the offsets are read
  }
}

template <bool SPLIT, int CPL>
cudaError_t launch_k4(const float* x, int B, const MatDims& m,
                      const float* edges, int ep, const float* tables,
                      const int* lmap, int* out, cudaStream_t stream) {
  const int ne4 = (m.F * ep + 3) & ~3;
  const int nt4 = (m.F * (m.E + 1) * m.C + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)ne4 + nt4 + K4_BATCH);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mat_lut_kernel<SPLIT, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int cw = 0;                        // Cp = 2^cw >= C, at most 32
  while ((1 << cw) < m.C && cw < 5) ++cw;
  const int R = K4Rows<SPLIT>::R;
  const int groups = (B + R - 1) / R;
  int blocks = (groups + K4_WARPS - 1) / K4_WARPS;
  if (blocks > K4_MAX_BLOCKS) blocks = K4_MAX_BLOCKS;
  mat_lut_kernel<SPLIT, CPL><<<blocks, K4_THREADS, smem, stream>>>(
      x, B, m, edges, ep, tables, lmap, out, ne4, nt4, cw);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_mat_lut_classify(const float* x, int B, const MatDims& m,
                                    const float* edges, int ep,
                                    const float* tables, const int* lmap,
                                    int* out, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const bool split = m.E > RT_MAT_SPLIT_EDGES;
  if (m.F < 1 || m.F > RT_MAT_MAX_FEATURES || m.C < 1 ||
      m.C > 32 * RT_CLS_PER_LANE || m.E < 0 || m.E + 1 > RT_MAT_MAX_BINS ||
      (split ? ep % 32 != 0 || ep < m.E : ep != m.E))
    return cudaErrorInvalidValue;
  if (split)
    return m.C > 32 ? launch_k4<true, RT_CLS_PER_LANE>(
                          x, B, m, edges, ep, tables, lmap, out, stream)
                    : launch_k4<true, 1>(x, B, m, edges, ep, tables, lmap,
                                         out, stream);
  return m.C > 32 ? launch_k4<false, RT_CLS_PER_LANE>(
                        x, B, m, edges, ep, tables, lmap, out, stream)
                  : launch_k4<false, 1>(x, B, m, edges, ep, tables, lmap,
                                        out, stream);
}
