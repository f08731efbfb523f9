// flow_chain: the per-slot register chain shared by K1 (fused_flow) and
// K2 (flow_update).  Replaces the TPU's _flow_phase
// (repro/kernels/flow_update/kernel.py:73) — the same per-element
// arithmetic as the sequential reference (flow_update/ref.py), none of
// its lockstep rounds or drain.
//
// One warp owns one slot segment (all of a batch's packets for one slot,
// in arrival order).  Lane l holds register columns l, l+32, ... (up to
// RT_COLS of them) in registers, loads the stored key and row once, walks
// the segment's packets in order and writes the row and key home at the
// end.  Slots never interact, so warps need no synchronisation.
//
// What is serial, and what is not.  A step depends on the previous one
// only through the row: per column "fresh ? vf : (ewma ? r - r*alpha :
// r) + t".  Everything else is known before the walk, so it leaves the
// chain, and one warp has few cycles to spare: with a single warp on
// the serial path, every instruction a step issues is latency.  So:
//   - the operands are staged in chunks of up to FC_CHUNK steps, one step
//     per lane: lane i loads step i's arrival index p = order[...] and its
//     key, and copies the step's upd and bins rows into a per-warp ring
//     in shared memory with cp.async (16-byte copies where the rows are
//     aligned, 4-byte otherwise).  The ring holds two chunks: chunk n + 1
//     is in flight while chunk n is walked;
//   - a step's eviction flag is key != previous key, from adjacent lanes
//     (__shfl_up_sync); the last key of a chunk, or the stored key for the
//     first chunk, is carried across the chunk's edge;
//   - lane i folds its step's histogram hits into a bit mask, and each
//     lane forms its column's per-step term — the counter increment, the
//     EWMA value times alpha, the histogram hit — and the value vf a
//     fresh row takes from the staged rows and that mask (a shuffle):
//     loads and selects that wait on nothing the chain computes;
//   - the chain keeps "fresh ? vf : (ewma ? r - r*alpha : r) + t" and
//     nothing else: no branch and no store; a chunk's post-update rows
//     stay in registers (one per step and lane) and go out after the
//     chunk where nothing on the chain waits for them (K2: the packets'
//     feature rows; K1: their rows of the scratch z).
// A chain is never split across warps: a parallel scan would reorder the
// counters' and EWMAs' f32 sums, whose bits are exact.
//
// Why the fold gives the sequential walk's bits.  The walk computes, per
// column, x = r + u (counters), x = (r - r*a) + u*a (EWMAs) or x = r
// (histograms), then adds (b_h == c ? 1 : 0) for each bins column h in
// order.  Adding +0.0 only turns -0.0 into +0.0, and after a +1.0 the
// value is never -0.0, so the adds collapse to: x + 0.0 when no bins
// column hits c (and there is at least one bins column), else x + 1.0
// once per hit.  And (y + z) + 0.0 == y + (z + 0.0) for every y, z, so
// the + 0.0 folds into the term.  A packet whose bins hit a counter or
// EWMA column, or hit one column twice, leaves + 1.0 adds after the
// chain's own add: a chunk holding such a packet (flagged when it is
// staged; RegisterUpdate never makes one) takes a walk that keeps them,
// counting each step's hits column by column.
// The JAX package's kernel folds the same way
// (repro/kernels/flow_update/kernel.py:100-110).
#pragma once

#include <stdint.h>

#include "rt_types.h"

#define FC_FULL 0xffffffffu
#define FC_CHUNK RT_CHAIN_CHUNK // steps staged per chunk: one per lane
#define FC_WARP_MAX 2048        // floats of one warp's ring, at most

// One warp's ring for a table with U update words and H bins columns,
// staging L steps a chunk: two buffers of L x (U + H) words, each
// rounded up to 4 (16-byte aligned).
__host__ __device__ inline int fc_stage_words(int L, int U, int H) {
  return (L * (U + H) + 3) & ~3;
}

// Floats to give each warp's ring: FC_CHUNK steps a chunk when they fit
// in FC_WARP_MAX, else FC_WARP_MAX (fewer steps a chunk).
__host__ __device__ inline int fc_warp_floats(int U, int H) {
  const int full = 2 * fc_stage_words(FC_CHUNK, U, H);
  if (full <= FC_WARP_MAX) return full;
  const int one = 2 * fc_stage_words(1, U, H);
  return one > FC_WARP_MAX ? one : FC_WARP_MAX;
}

// Steps a chunk for a ring of `floats`.
__host__ __device__ inline int fc_chunk_steps(int floats, int U, int H) {
  int L = FC_CHUNK;
  while (L > 1 && 2 * fc_stage_words(L, U, H) > floats) --L;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest one has landed (for this thread).
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Lane i < n copies step i's row [width] (arrival index p) from src to
// row i of dst; vec: 16-byte copies.
template <class T>
__device__ __forceinline__ void fc_copy_row(T* dst, const T* src,
                                            int width, int p, int n,
                                            int lane, bool vec) {
  if (lane >= n) return;
  T* d = dst + lane * width;
  const T* s = src + (size_t)p * width;
  if (vec) {
    for (int o = 0; o < width; o += 4) cp_async16(d + o, s + o);
  } else {
    for (int o = 0; o < width; ++o) cp_async4(d + o, s + o);
  }
}

// Stage the chunk of n steps whose arrival indices lane i holds (p) into
// buf: upd rows [L, U] then bins rows [L, H].  One cp.async group.
__device__ __forceinline__ void fc_stage(const FlowArgs& a, float* buf,
                                         int L, int p, int n, int lane,
                                         bool vec_u, bool vec_b) {
  fc_copy_row(buf, a.upd, a.U, p, n, lane, vec_u);
  fc_copy_row(reinterpret_cast<int*>(buf + L * a.U), a.bins, a.H, p, n,
              lane, vec_b);
  cp_async_commit();
}

// (r - r*alpha): the row's share of ewma_blend, (row0 - row0*a) + val*a
// (flow_update/ref.py).  Both products are exact for a power-of-two alpha,
// so FMA contraction cannot change the bits.
__device__ __forceinline__ float ewma_keep(float r, float alpha) {
  const float ta = r * alpha;
  return r - ta;
}

// The walk of one chunk of n staged steps (bu [n, U] upd rows) whose
// packets hit only histogram columns, each at most once: bit i of fmask
// = step i evicts; bit c - 32 j of lane i's hm[j] = step i hits column c;
// lane i holds step i's arrival index p.  FULL: n == FC_CHUNK.  One
// column group (W <= 32, every configuration of the repository) keeps the
// chunk's rows in registers and stores them after the walk; wider rows
// store each step's row as it goes.
template <int NC, bool FULL>
__device__ __forceinline__ void fc_walk(float (&row)[RT_COLS],
                                        const FlowArgs& a, const float* bu,
                                        int n, unsigned fmask,
                                        const unsigned (&hm)[NC], int p,
                                        float* out, int ostride, int lane) {
  const int U = a.U, C = a.C, CE = a.C + a.E, W = a.W;
  const bool bins = a.H > 0;
  const float alpha = a.alpha;
  const float miss = bins ? 0.f : -0.f;      // r + -0.0 == r
  bool is_e[NC], is_h[NC];
  int ui[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    is_e[j] = c >= C && c < CE;
    is_h[j] = c >= CE;
    ui[j] = c < CE ? c : 0;
  }
  // step i, column group j -> the post-update value
  auto step = [&](int i, int j) {
    // off the chain: the term t and the fresh value vf
    const bool hit = (__shfl_sync(FC_FULL, hm[j], i) >> lane) & 1u;
    const float x = bu[i * U + ui[j]];
    const float w = is_e[j] ? x * alpha : x;
    const float t = is_h[j] ? (hit ? 1.f : miss) : (bins ? w + 0.f : w);
    const float vf = is_h[j] ? (hit ? 1.f : 0.f)
                     : is_e[j] ? (bins ? x + 0.f : x) : 0.f + x;
    // on the chain
    const float r = row[j];
    const float v = (is_e[j] ? ewma_keep(r, alpha) : r) + t;
    row[j] = (fmask >> i) & 1u ? vf : v;
  };
  if constexpr (NC == 1) {
    float res[FC_CHUNK];
#pragma unroll
    for (int i = 0; i < FC_CHUNK; ++i) {
      if (FULL || i < n) {                   // warp-uniform
        step(i, 0);
        res[i] = row[0];
      }
    }
    // every row's offset first, so that no store waits on a shuffle
    int off[FC_CHUNK];
#pragma unroll
    for (int i = 0; i < FC_CHUNK; ++i)
      off[i] = __shfl_sync(FC_FULL, p, i) * ostride + lane;
#pragma unroll
    for (int i = 0; i < FC_CHUNK; ++i)
      if ((FULL || i < n) && lane < W) out[off[i]] = res[i];
  } else {
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const int q = __shfl_sync(FC_FULL, p, i);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (32 * j < W) {                    // warp-uniform
          step(i, j);
          const int c = lane + 32 * j;
          if (c < W) out[(size_t)q * ostride + c] = row[j];
        }
      }
    }
  }
}

// The walk that keeps the + 1.0 adds past the chain's own add (a chunk
// with a packet whose bins hit a counter or EWMA column or one column
// twice): each step's hits counted column by column from the staged
// rows, in the order of the sequential walk.
template <int NC>
__device__ __forceinline__ void fc_walk_general(float (&row)[RT_COLS],
                                                const FlowArgs& a,
                                                const float* bu,
                                                const int* bb, int n,
                                                unsigned fmask, int p,
                                                float* out, int ostride,
                                                int lane) {
  const int U = a.U, H = a.H, C = a.C, CE = a.C + a.E, W = a.W;
  const float alpha = a.alpha;
  for (int i = 0; i < n; ++i) {
    const bool fresh = (fmask >> i) & 1u;
    const float* u = bu + i * U;
    const int* b = bb + i * H;
    const int q = __shfl_sync(FC_FULL, p, i);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < W) {
        int nh = 0;                          // bins columns hitting c
        for (int h = 0; h < H; ++h) nh += b[h] == c ? 1 : 0;
        const bool ewma = c >= C && c < CE;
        const float uc = c < CE ? u[c] : 0.f;
        // the term t, the + 1.0 adds k after it, the fresh value vf
        float t, vf;
        int k;
        if (c < CE) {                        // counters, EWMAs
          const float w = ewma ? uc * alpha : uc;
          t = nh == 0 && H > 0 ? w + 0.f : w;
          vf = ewma ? uc : 0.f + uc;
          k = nh;
        } else {                             // histograms
          t = nh > 0 ? 1.f : (H > 0 ? 0.f : -0.f);
          vf = 0.f;
          k = nh > 0 ? nh - 1 : 0;
        }
        if (nh == 0 && H > 0) vf = vf + 0.f;
        for (int e = 0; e < nh; ++e) vf = vf + 1.f;
        const float r = row[j];
        float v = (ewma ? ewma_keep(r, alpha) : r) + t;
        for (int e = 0; e < k; ++e) v = v + 1.f;
        row[j] = fresh ? vf : v;
        out[(size_t)q * ostride + c] = row[j];
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void flow_chain_nc(const FlowArgs& a, int k,
                                              int lane, float* ring,
                                              int floats, float* out,
                                              int ostride) {
  const int len = a.seg_len[k];
  if (len == 0) return;
  __syncwarp();                              // the ring's last reader
  const int s = a.seg_slot[k];
  const int first = a.seg_first[k];
  const size_t base = (size_t)s * a.W;
  const int L = fc_chunk_steps(floats, a.U, a.H);
  float* const buf0 = ring;
  float* const buf1 = ring + fc_stage_words(L, a.U, a.H);
  // 16-byte copies need 16-byte aligned rows at both ends
  const bool al = ((uintptr_t)ring & 15) == 0;
  const bool vec_u = al && a.U % 4 == 0 && ((uintptr_t)a.upd & 15) == 0;
  const bool vec_b = al && a.H % 4 == 0 && (L * a.U) % 4 == 0 &&
                     ((uintptr_t)a.bins & 15) == 0;

  int stored = a.keys[s];
  float row[RT_COLS];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    row[j] = c < a.W ? a.regs[base + c] : 0.f;
  }
  // chunk 0's indices, keys and rows; chunk 1's indices
  int n = len < L ? len : L;
  int p = lane < n ? a.order[first + lane] : 0;
  int p_next = lane < L && L + lane < len ? a.order[first + L + lane] : 0;
  int key = lane < n ? a.pkt_keys[p] : 0;
  fc_stage(a, buf0, L, p, n, lane, vec_u, vec_b);
  for (int r0 = 0, ci = 0; r0 < len; r0 += L, ++ci) {
    n = len - r0 < L ? len - r0 : L;
    float* const cur = (ci & 1) ? buf1 : buf0;
    // chunk ci + 1's rows and keys, chunk ci + 2's indices, in flight
    // while chunk ci is walked
    const int r1 = r0 + L;
    const int n1 = len - r1 < L ? len - r1 : L;
    int key_next = 0, p_next2 = 0;
    __syncwarp();                            // chunk ci - 1 is walked
    if (n1 > 0) {
      fc_stage(a, (ci & 1) ? buf0 : buf1, L, p_next, n1, lane, vec_u,
               vec_b);
      key_next = lane < n1 ? a.pkt_keys[p_next] : 0;
      p_next2 = lane < L && r1 + L + lane < len
                    ? a.order[first + r1 + L + lane] : 0;
    } else {
      cp_async_commit();                     // an empty group
    }
    // eviction flags from adjacent keys, the carry across the edge
    int prev = __shfl_up_sync(FC_FULL, key, 1);
    if (lane == 0) prev = stored;
    const unsigned fmask = __ballot_sync(FC_FULL, lane < n && key != prev);
    cp_async_wait_prev();                    // chunk ci has landed
    __syncwarp();
    const float* bu = cur;
    const int* bb = reinterpret_cast<const int*>(cur + L * a.U);
    // step lane's histogram hits as bit masks; does a packet hit a
    // counter or EWMA column, or one column twice?
    unsigned hm[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) hm[j] = 0u;
    bool odd = false;
    if (lane < n) {
      const int* b = bb + lane * a.H;
#pragma unroll
      for (int h = 0; h < RT_MAX_HISTS; ++h) {
        if (h < a.H) {
          const int x = b[h];
          if (x >= 0 && x < a.C + a.E) odd = true;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const unsigned bit = 1u << (x & 31);
            if (x >> 5 == j && x >= 0) {
              if (hm[j] & bit) odd = true;   // one column twice
              hm[j] |= bit;
            }
          }
        }
      }
    }
    if (__any_sync(FC_FULL, odd))
      fc_walk_general<NC>(row, a, bu, bb, n, fmask, p, out, ostride, lane);
    else if (NC == 1 && n == FC_CHUNK)
      fc_walk<NC, true>(row, a, bu, n, fmask, hm, p, out, ostride, lane);
    else
      fc_walk<NC, false>(row, a, bu, n, fmask, hm, p, out, ostride, lane);
    stored = __shfl_sync(FC_FULL, key, n - 1);
    key = key_next;
    p = p_next;
    p_next = p_next2;
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < a.W) a.regs[base + c] = row[j];
  }
  if (lane == 0) a.keys[s] = stored;
}

// Walk segment k with this warp's ring of `floats` (at least
// fc_warp_floats(U, H)); after each packet's update the post-update row
// goes to out + p * ostride (arrival index p).  Every lane of the warp
// calls it.
__device__ __forceinline__ void flow_chain(const FlowArgs& a, int k,
                                           int lane, float* ring,
                                           int floats, float* out,
                                           int ostride) {
  if (a.W <= 32)
    flow_chain_nc<1>(a, k, lane, ring, floats, out, ostride);
  else
    flow_chain_nc<RT_COLS>(a, k, lane, ring, floats, out, ostride);
}
