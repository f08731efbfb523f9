// mitigate_chain: one action-table slot chain walked in arrival order —
// K1's mitigation phase (fused_flow.cu), replacing _mitigation_phase
// (repro/kernels/fused_flow/kernel.py:250-332).  The Pallas kernel's
// closed form (segmented cumsums over same-key runs) is a TPU idiom; here
// one thread walks each segment of the action table's own slot
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
// Every value is an integer-valued f32 below 2^24, so the walk is exact.
// The verdicts were written to their arrival indices before the grid-wide
// barrier that precedes this phase.
#pragma once

#include <math.h>

#include "rt_types.h"

__device__ __forceinline__ void mitigate_chain(const MitArgs& m,
                                               const int* pkt_keys,
                                               int* verdicts, int k) {
  const int len = m.seg_len[k];
  if (len == 0) return;
  const int s = m.seg_slot[k];
  const int first = m.seg_first[k];
  int stored = m.keys[s];
  float hits = m.regs[2 * s];
  float since = m.regs[2 * s + 1];
  for (int r = 0; r < len; ++r) {
    const int p = m.order[first + r];
    const int key = pkt_keys[p];
    const bool fresh = stored != key;
    const float h0 = fresh ? 0.f : hits;
    const float s0 = fresh ? 0.f : since;
    const bool marked = h0 >= m.threshold;
    const bool drop =
        marked && (m.drop || fmodf(s0, m.keep_every) != 0.f);
    const int v = verdicts[p];
    if (drop) verdicts[p] = RT_MITIGATED;
    hits = h0 + (v == m.attack_class ? 1.f : 0.f);
    since = marked ? s0 + 1.f : 0.f;
    stored = key;
  }
  m.keys[s] = stored;
  m.regs[2 * s] = hits;
  m.regs[2 * s + 1] = since;
}
