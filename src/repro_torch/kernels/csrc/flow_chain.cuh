// flow_chain: the per-slot register chain shared by K1 (fused_flow) and
// K2 (flow_update).  Replaces the TPU's _flow_phase
// (repro/kernels/flow_update/kernel.py:73) — same per-element arithmetic
// as the sequential reference (flow_update/ref.py), none of its lockstep
// rounds or drain.
//
// One warp owns one slot segment (all of a batch's packets for one slot,
// in arrival order).  Lane l holds register columns l, l+32, ... (up to
// RT_COLS of them) in registers, loads the stored key and row once, walks
// the segment's packets in order and writes the row and key home at the
// end.  Slots never interact, so warps need no synchronisation.
#pragma once

#include "rt_types.h"

// (row0 - row0*a) + val*a: both products exact for a power-of-two alpha,
// so FMA contraction cannot change the bits (flow_update/ref.py).
__device__ __forceinline__ float ewma_blend(float row0, float val,
                                            float alpha) {
  float ta = row0 * alpha;
  float tv = val * alpha;
  return (row0 - ta) + tv;
}

// Walk segment k.  After each packet's update ``emit(p, row, lane)`` sees
// the post-update row (arrival index p).
template <class Emit>
__device__ __forceinline__ void flow_chain(const FlowArgs& a, int k,
                                           int lane, Emit& emit) {
  const int len = a.seg_len[k];
  if (len == 0) return;
  const int s = a.seg_slot[k];
  const int first = a.seg_first[k];
  const size_t base = (size_t)s * a.W;
  int stored = a.keys[s];
  float row[RT_COLS];
#pragma unroll
  for (int j = 0; j < RT_COLS; ++j) {
    const int c = lane + 32 * j;
    row[j] = c < a.W ? a.regs[base + c] : 0.f;
  }
  for (int r = 0; r < len; ++r) {
    const int p = a.order[first + r];
    const int key = a.pkt_keys[p];
    const bool fresh = stored != key;        // evict-on-collision
    const float* u = a.upd + (size_t)p * a.U;
    const int* bp = a.bins + (size_t)p * a.H;
#pragma unroll
    for (int j = 0; j < RT_COLS; ++j) {
      const int c = lane + 32 * j;
      if (c < a.W) {
        const float r0 = fresh ? 0.f : row[j];
        float v;
        if (c < a.C) {
          v = r0 + u[c];                     // counters
        } else if (c < a.C + a.E) {          // EWMAs
          const float val = u[c];
          v = fresh ? val : ewma_blend(r0, val, a.alpha);
        } else {
          v = r0;
        }
        // histograms: one add per bins column, in column order (the
        // + 0.0 of a miss is kept: it turns -0.0 into +0.0 as the
        // reference does)
        for (int h = 0; h < a.H; ++h) v = v + (bp[h] == c ? 1.f : 0.f);
        row[j] = v;
      }
    }
    stored = key;
    emit(p, row, lane);
  }
#pragma unroll
  for (int j = 0; j < RT_COLS; ++j) {
    const int c = lane + 32 * j;
    if (c < a.W) a.regs[base + c] = row[j];
  }
  if (lane == 0) a.keys[s] = stored;
}
