// mitigate_chain: one action-table slot chain walked in arrival order —
// K1's mitigation phase (fused_flow.cu), replacing _mitigation_phase
// (repro/kernels/fused_flow/kernel.py:250-332).  The Pallas kernel's
// closed form (segmented cumsums over same-key runs) is a TPU idiom; here
// one warp walks each segment of the action table's own slot
// segmentation with mitigate_update's rules
// (repro_torch/kernels/fused_flow/mitigate_ref.py):
//
//   - evict on collision: a different stored key starts a fresh row;
//   - the state BEFORE the packet decides: a marked row (hits >=
//     threshold) drops the packet ("drop"), or drops all but every
//     keep_every-th packet since the mark ("rate_limit"); a dropped
//     packet's verdict becomes RT_MITIGATED;
//   - hits counts attack verdicts, dropped packets included; since counts
//     packets while marked, and is 0 otherwise.
//
// As in flow_chain.cuh, only the recurrence stays on the chain.  The
// segment is walked in chunks of 32 steps: lane i loads step i's arrival
// index, key and verdict (the next chunk's are in flight while a chunk
// is walked), the eviction flags come from adjacent keys (the last key
// carried across the chunk's edge) and the attack flags from a ballot.
// Every lane then walks the chunk's (hits, since) recurrence, taking its
// flags by bit, and lane i keeps step i's state; the drop rule, which
// feeds no later step, runs after the chunk on every lane at once.
//
// Every value is an integer-valued f32 below 2^24, so the walk is exact.
// The verdicts were written to their arrival indices before the grid-wide
// barrier that precedes this phase.
#pragma once

#include <math.h>

#include "rt_types.h"

#define MC_FULL 0xffffffffu

// Walk action segment k with this warp (every lane calls it).
__device__ __forceinline__ void mitigate_chain(const MitArgs& m,
                                               const int* pkt_keys,
                                               int* verdicts, int k,
                                               int lane) {
  const int len = m.seg_len[k];
  if (len == 0) return;
  const int s = m.seg_slot[k];
  const int first = m.seg_first[k];
  int stored = m.keys[s];
  float hits = m.regs[2 * s];
  float since = m.regs[2 * s + 1];
  int n = len < 32 ? len : 32;
  int p = lane < n ? m.order[first + lane] : 0;
  int key = lane < n ? pkt_keys[p] : 0;
  int v = lane < n ? verdicts[p] : 0;
  int p_next = 32 + lane < len ? m.order[first + 32 + lane] : 0;
  for (int r0 = 0; r0 < len; r0 += 32) {
    n = len - r0 < 32 ? len - r0 : 32;
    // the next chunk's keys and verdicts, the one after's indices
    const int n1 = len - r0 - 32;
    const int key_next = lane < n1 ? pkt_keys[p_next] : 0;
    const int v_next = lane < n1 ? verdicts[p_next] : 0;
    const int p_next2 =
        r0 + 64 + lane < len ? m.order[first + r0 + 64 + lane] : 0;
    int prev = __shfl_up_sync(MC_FULL, key, 1);
    if (lane == 0) prev = stored;
    const unsigned fmask = __ballot_sync(MC_FULL, lane < n && key != prev);
    const unsigned amask =
        __ballot_sync(MC_FULL, lane < n && v == m.attack_class);
    unsigned marks = 0u;
    float my_s0 = 0.f;
    for (int i = 0; i < n; ++i) {
      const bool fresh = (fmask >> i) & 1u;
      const float h0 = fresh ? 0.f : hits;
      const float s0 = fresh ? 0.f : since;
      const bool marked = h0 >= m.threshold;
      if (lane == i) my_s0 = s0;
      marks |= (marked ? 1u : 0u) << i;
      hits = h0 + (((amask >> i) & 1u) ? 1.f : 0.f);
      since = marked ? s0 + 1.f : 0.f;
    }
    if (lane < n && ((marks >> lane) & 1u) &&
        (m.drop || fmodf(my_s0, m.keep_every) != 0.f))
      verdicts[p] = RT_MITIGATED;
    stored = __shfl_sync(MC_FULL, key, n - 1);
    p = p_next;
    key = key_next;
    v = v_next;
    p_next = p_next2;
  }
  if (lane == 0) {
    m.keys[s] = stored;
    m.regs[2 * s] = hits;
    m.regs[2 * s + 1] = since;
  }
}
