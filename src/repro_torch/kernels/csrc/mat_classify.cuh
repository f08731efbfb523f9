// mat_classify: the MAT classifier (Quantize -> LUTGather -> Reduce ->
// LabelMap) of one readout row, run by one warp.  Shared by K4
// (mat_lut.cu, replacing repro/kernels/mat_lut/kernel.py:41 _kernel) and
// K1's "mat" suffix (fused_flow.cu, replacing the "mat" branch of
// suffix_verdicts, repro/kernels/fused_flow/kernel.py:178-244).
//
// The block stages the edges [F, E] and the tables [F, E + 1, C] in
// shared memory once.  Lane l first computes the buckets of features l
// and l + 32 (F <= 64): the count of edges strictly below the value
// (searchsorted side='left' as a compare-and-count: no binary search, so
// ties and NaN go as in the Pallas kernel).  Then, per feature f in
// ascending order, the warp reads f's bucket from its lane (a shuffle)
// and lane l adds that bucket's table entry of class l + 32 j to its
// running score.  Every class thus sums its features in ascending f from
// 0.0, as the Pallas kernel's `scores + dot(onehot, table[f])` does (one
// nonzero term per dot: exact), while the buckets and the table loads
// of different features do not wait on one another.  Then the masked
// arg-reduce (ties to the lowest index) and the LabelMap gather.
//
// Why a warp per row and not a thread: lanes share a row's compares and
// classes, so a row's latency is a warp's, not a thread's: K1 classifies
// each packet's row on a warp of its own after its chain walk, and K4
// uses the same function so both compute the same bits.
#pragma once

#include "arg_reduce.cuh"
#include "rt_types.h"

__host__ __device__ inline size_t mat_smem_floats(const MatDims& m) {
  return (size_t)m.F * m.E + (size_t)m.F * (m.E + 1) * m.C;
}

// Stage edges then tables (whole block; the caller synchronises after).
__device__ __forceinline__ void mat_load(float* smem, const float* edges,
                                         const float* tables,
                                         const MatDims& m) {
  const int ne = m.F * m.E;
  const int nt = m.F * (m.E + 1) * m.C;
  for (int i = threadIdx.x; i < ne; i += blockDim.x) smem[i] = edges[i];
  for (int i = threadIdx.x; i < nt; i += blockDim.x)
    smem[ne + i] = tables[i];
}

// z: the readout row (F floats) in this warp's shared buffer.  Returns
// the label on every lane.
__device__ __forceinline__ int mat_classify(const float* z,
                                            const float* smem,
                                            const int* lmap,
                                            const MatDims& m, int lane) {
  __syncwarp();                              // the row is written
  const float* tables = smem + (size_t)m.F * m.E;
  int bucket[2] = {0, 0};                    // features lane, lane + 32
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = lane + 32 * q;
    if (f < m.F) {
      const float v = z[f];
      const float* e = smem + (size_t)f * m.E;
      int cnt = 0;
      for (int i = 0; i < m.E; ++i) cnt += v > e[i] ? 1 : 0;
      bucket[q] = cnt;
    }
  }
  float sc[RT_CLS_PER_LANE];
#pragma unroll
  for (int j = 0; j < RT_CLS_PER_LANE; ++j) sc[j] = 0.f;
  for (int f = 0; f < m.F; ++f) {
    const int b = __shfl_sync(0xffffffffu, f < 32 ? bucket[0] : bucket[1],
                              f & 31);
    const float* t = tables + ((size_t)f * (m.E + 1) + b) * m.C;
#pragma unroll
    for (int j = 0; j < RT_CLS_PER_LANE; ++j) {
      const int c = lane + 32 * j;
      if (c < m.C) sc[j] = sc[j] + t[c];
    }
  }
  const int id = warp_arg_reduce(sc, m.C, m.use_min != 0, lane);
  __syncwarp();                              // the row buffer is free
  return lmap[id];
}
