// centroid_classify: the centroid classifier ([FeatureSelect] ->
// CentroidDistance -> Reduce -> LabelMap) of one readout row, run by one
// warp.  K1's "centroid" suffix (fused_flow.cu, replacing the "centroid"
// branch of suffix_verdicts, repro/kernels/fused_flow/kernel.py:178-244).
//
// The block stages the centroids [K, D] in shared memory once.  Lane l
// computes the squared distance to centroids l + 32 j, summing the
// features in ascending index with the products and sums rounded
// separately (__fmul_rn / __fadd_rn: no FMA contraction), the arithmetic
// of the plain version fused_flow/ref.py::centroid_scores_ref.  A folded
// FeatureSelect reads the readout row through its index.  Then the masked
// arg-reduce, ties to the lowest index (duplicated centroids tie exactly:
// same arithmetic), and the LabelMap gather.
#pragma once

#include "arg_reduce.cuh"
#include "rt_types.h"

__host__ __device__ inline size_t cent_smem_floats(const CentDims& c) {
  return (size_t)c.K * c.D;
}

__device__ __forceinline__ void cent_load(float* smem, const float* cent,
                                          const CentDims& c) {
  const int n = c.K * c.D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = cent[i];
}

// z: the readout row in this warp's shared buffer.  Returns the label on
// every lane.
__device__ __forceinline__ int centroid_classify(const float* z,
                                                 const float* smem,
                                                 const int* fidx,
                                                 const int* lmap,
                                                 const CentDims& c,
                                                 int lane) {
  __syncwarp();                              // the row is written
  float d[RT_CLS_PER_LANE];
#pragma unroll
  for (int j = 0; j < RT_CLS_PER_LANE; ++j) {
    const int k = lane + 32 * j;
    float acc = 0.f;
    if (k < c.K) {
      const float* ck = smem + (size_t)k * c.D;
      for (int i = 0; i < c.D; ++i) {
        const float t = __fsub_rn(z[c.n_sel ? fidx[i] : i], ck[i]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
    d[j] = acc;
  }
  const int id = warp_arg_reduce(d, c.K, c.use_min != 0, lane);
  __syncwarp();                              // the row buffer is free
  return lmap[id];
}
