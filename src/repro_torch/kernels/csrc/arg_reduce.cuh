// warp_arg_reduce: the masked arg-reduce of the MAT and centroid
// classifiers (_arg_reduce, repro/kernels/fused_flow/kernel.py:167, and
// the argmax/argmin of mat_lut._kernel): argmax, or argmin with
// ``use_min``, over n <= 32 * J scores held across the warp (lane l
// holds class l + 32 j in v[j]), ties to the lowest index.  With width
// < 32 (J = 1) each aligned group of width lanes reduces its own scores
// (lane l of a group holds class l): K4 runs one row a group.
#pragma once

#include <math.h>

template <int J>
__device__ __forceinline__ int warp_arg_reduce(const float (&v)[J], int n,
                                               bool use_min, int lane,
                                               int width = 32) {
  float best = use_min ? INFINITY : -INFINITY;
  int idx = 0x7fffffff;                      // no class on this lane yet
#pragma unroll
  for (int j = 0; j < J; ++j) {
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
  for (int off = width >> 1; off > 0; off >>= 1) {
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
