// warp_arg_reduce: the masked arg-reduce of the MAT and centroid
// classifiers (_arg_reduce, repro/kernels/fused_flow/kernel.py:167, and
// the argmax/argmin of mat_lut._kernel): argmax, or argmin with
// ``use_min``, over n <= 32 * RT_CLS_PER_LANE scores held across the
// warp (lane l holds class l + 32 j in v[j]), ties to the lowest index.
#pragma once

#include <math.h>

#include "rt_types.h"

__device__ __forceinline__ int warp_arg_reduce(
    const float (&v)[RT_CLS_PER_LANE], int n, bool use_min, int lane) {
  float best = use_min ? INFINITY : -INFINITY;
  int idx = 0x7fffffff;                      // no class on this lane yet
#pragma unroll
  for (int j = 0; j < RT_CLS_PER_LANE; ++j) {
    const int c = lane + 32 * j;
    if (c < n) {
      const float x = v[j];
      // strict: a later class must beat the kept one to replace it
      if (idx == 0x7fffffff || (use_min ? x < best : x > best)) {
        best = x;
        idx = c;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    const bool better = use_min ? ob < best : ob > best;
    if (better || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}
