// K8b selective_scan_bwd: the gradient of K8's discretizing entry.  The
// forward (selective_scan.cu) takes dt [B, S, di], A [di, N], Bm and C
// [B, S, N] f32, x [B, S, di] f32 or bf16 and h0 [B, di, N] f32 and runs
//   dA_t = expf(dt_t A), dBx_t = (dt_t Bm_t) x_t,
//   h_t = dA_t h_{t-1} + dBx_t,  y_t[d] = sum_n h_t[d, n] C_t[n].
// With g_t = dL/dh_t = dy_t C_t + dA_{t+1} g_{t+1} (dh_final added at the
// last step) this computes
//   ddt_t[d] = sum_n g_t h_{t-1} dA_t A[d, n] + (sum_n g_t Bm_t[n]) x_t[d]
//   dA[d, n] = sum_{b, t} g_t h_{t-1} dA_t dt_t[d]
//   dBm_t[n] = sum_d g_t dt_t[d] x_t[d]
//   dC_t[n]  = sum_d dy_t[d] h_t[d, n]
//   dx_t[d]  = dt_t[d] sum_n g_t Bm_t[n]          (in x's dtype)
//   dh0      = dA_1 g_1                            (when asked for).
//
// The TPU kernel (repro/kernels/selective_scan/kernel.py:35) has no
// gradient: the JAX package trains through XLA's gradient of its chunked
// scan (repro/models/ssm.py:58-89) after the discretization (:117-121).
// This is the port's hand-written one, so that training holds no [B, S,
// di, N] tensor (4.3 GB each at Jamba's width with 4 x 1,024 tokens).
//
// Bound: operations.  The bytes are dt, x and dy read once and ddt and
// dx written once (5 B S di words, x's two in its dtype), Bm, C, dBm and
// dC (4 B S N), A, dA, h0 / dh_final / dh0 and the checkpoints (B ceil(S
// / T) di N); the f32 operations on every (t, d, n) are the chunk's
// forward again and the walk, about 21 of them: 0.337 ms at 67 TFLOP/s at
// Jamba's training shape (4 x 1,024 tokens, di 16,384, N = 16).  Issued
// as single instructions (no FMA contraction, IEEE expf, the channel sums
// by shuffles) they are about 43 a (t, d, n) in the step loops here and
// 53 with a chunk's own work, about 1.7 ms at the card's issue rate: the
// issue rate, not the bound, is what the design works against.
//
// Design.  The walk needs h_{t-1} at every step, and h_{t-1} = (h_t -
// dBx_t) / dA_t is not computed: dA can be tiny.  K8's forward under
// autograd (selective_scan_ckpt_kernel) stores h entering every chunk of
// T = SSB_CHUNK(N) steps (4 at N = 16), and the walk takes the chunks
// last to first: it recomputes the chunk forward from its checkpoint in
// K8's order, then walks the chunk backward.  This is the scheme of the
// upstream Mamba CUDA kernels' backward, over a channel's own states
// instead of over a block's steps.  The first version ran one thread a
// channel; tools/k8b_phase_clocks.py showed it at 12 resident warps an
// SM, 128 registers plus local memory, a 9,216-instruction chunk loop
// and its two butterflies and walk taking most of a chunk.  What this
// version does, each measured on the card with that tool:
//
// * A channel's N states lie on SSB_LANES(N) adjacent lanes of
//   SSB_LANE_N each (4 lanes a channel at N = 16), so a thread carries 4
//   states and a block of SSB_THREADS threads SSB_CHANNELS(N) channels.
//   The shared memory a channel is the same, and 64 registers a thread
//   (__launch_bounds__) let an SM hold SSB_SM_THREADS threads: 32 warps,
//   and at N = 16 two whole waves of 4 x 16,384 channels.
// * The recompute keeps dA_t and the product dA_t h_{t-1} it forms
//   anyway, in shared memory ([T][SSB_THREADS][4] each): the walk does
//   no expf and its q = g (dA h_{t-1}) keeps its bits.
// * Every per-step operand lives in shared memory (the chunk's dt, x and
//   dy of the block's channels, its rows of Bm and C, the history), so
//   the step loops are not unrolled (about 90 instructions a step each)
//   and only a lane's 4 states are.  A chunk of 4 steps (SSB_HIST 64)
//   halves the history and let 8 blocks of 128 threads in where 8 steps
//   let 5; 256 threads a block then halve the partials the second
//   launch adds, at the same occupancy.
// * A lane's registers hold its states in an order set by its channel's
//   place in the warp (lane_perm), so each halving step of a channel sum
//   sends one half of the registers and keeps the other with no select;
//   ddt's and dx's sums over n are a pairwise tree, which that order
//   keeps.  Blocks whose channels are all below di run with no zeroing.
// * Prefetching the next chunk's operands into registers cost more in
//   occupancy than it hid, and was dropped: the SM is issue-bound, with
//   the loads' wait at a chunk's end overlapped by other blocks.
//
// No atomics: the sums across channels (dBm, dC) go by a butterfly over
// each warp's channels (channels 16 / L lanes apart first, then half
// that, ...: each lane ends with one n's warp sum), the warps' sums are
// added in order at the chunk's end, and each block writes its partial to
// ws_b / ws_c [blk][b][t][n]; dA's partials over t stay in registers and
// go to ws_a [b][d][n].  A second launch adds the partials over the
// blocks (and dA's over the batch) in ascending order, so two calls give
// the same bits; kernels/selective_scan/ref.py's
// selective_scan_bwd_chunked_ref writes out this schedule.  Every product
// and sum is __fmul_rn / __fadd_rn (no contraction into FMAs) and expf is
// the IEEE-accurate one, as in K8.

#include <cuda_bf16.h>

#include "rt_types.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int W = SSB_THREADS / 32;  // warps a block
constexpr int SUM_THREADS = 256;     // the partials' sum: threads a block

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// The shape of one instance: T steps a chunk, NL states a lane, L lanes a
// channel, CH channels a block.
template <int N>
struct Shape {
  static constexpr int T = SSB_CHUNK(N);
  static constexpr int L = SSB_LANES(N);
  static constexpr int NL = N / L;
  static constexpr int CH = SSB_CHANNELS(N);
};

// NL consecutive floats (16-byte aligned when NL = 4) to registers
template <int NL>
__device__ __forceinline__ void ld_n(const float* p, float* r) {
  if constexpr (NL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) r[i] = p[i];
  }
}

template <int NL>
__device__ __forceinline__ void st_n(float* p, const float* r) {
  if constexpr (NL == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) p[i] = r[i];
  }
}

template <bool XBF>
__device__ __forceinline__ float ld_x(const void* x, size_t i) {
  if constexpr (XBF)
    return __bfloat162float(static_cast<const bf16*>(x)[i]);
  else
    return __ldg(static_cast<const float*>(x) + i);
}

template <bool XBF>
__device__ __forceinline__ void st_x(void* x, size_t i, float v) {
  if constexpr (XBF)
    static_cast<bf16*>(x)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(x)[i] = v;
}

// A lane's register i holds state n0 + (i ^ perm) of its channel, perm
// (< NL) set by the lane's channel bits 16, 8, ... (one a halving step of
// chan_sum: bit 16 flips the upper half, bit 8 the upper quarter, ...).
// So at each halving step a lane keeps the lower half of its registers
// and sends the upper half, which on its partner holds the same states:
// no select.
template <int NL>
__device__ __forceinline__ int lane_perm(int lane) {
  int perm = 0;
#pragma unroll
  for (int k = 0; k < log2i(NL); ++k)
    if (lane & (16 >> k)) perm |= (NL >> k) / 2;
  return perm;
}

// The sum over a warp's channels.  v[NL] on each lane (lane = c L + j,
// its registers in lane_perm's order) -> the sum over the warp's 32 / L
// channels of its register 0's state, n0 + perm: halving steps over
// lanes 16, 8, ... apart while more than one value is left, then plain
// steps down to lanes L apart.  Every lane of one state ends with the
// same bits (a + b = b + a): channels 16 / L apart are added first, then
// 8 / L, ... (the order ref.py's _block_sums writes out).
template <int NL, int L>
__device__ __forceinline__ float chan_sum(float* v) {
  constexpr int LG = log2i(NL);
#pragma unroll
  for (int k = 0; k < LG; ++k) {
    const int h = (NL >> k) / 2;
#pragma unroll
    for (int i = 0; i < h; ++i)
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i + h],
                                              16 >> k));
  }
  float r = v[0];
#pragma unroll
  for (int o = 16 >> LG; o >= L; o >>= 1)
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// Whether the lane writes its warp's sum (one lane a state: the lanes
// whose plain-step bits are 0)
template <int NL, int L>
__device__ __forceinline__ bool chan_sum_writer(int lane) {
  return (lane & ((32 >> log2i(NL)) - L)) == 0;
}

// NL words of a lane's states from global memory into its registers in
// lane_perm's order, and back
template <int NL>
__device__ __forceinline__ void ldg_perm(const float* p, int perm,
                                         float* r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = __ldg(p + (i ^ perm));
}

template <int NL>
__device__ __forceinline__ void stg_perm(float* p, int perm,
                                         const float* r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i ^ perm] = r[i];
}

// v[0] + ... + v[NL - 1] as a pairwise tree, adjacent pairs first
template <int NL>
__device__ __forceinline__ float pair_sum(float* v) {
#pragma unroll
  for (int h = NL / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
  }
  return v[0];
}

// Stages a chunk's operands in shared memory: its rows of Bm and C
// ([T][N] each, at Bs, once for each lane_perm q: word n of a row at n ^
// q) and its channels' dt, x and dy ([T][CH] each,
// consecutive arrays at sd; a channel past di takes di - 1's).  A thread
// moves words tid + k SSB_THREADS of each: of Bm and C from offset ob (its
// first word of the chunk's rows), of dt, x and dy those of its channel
// at steps u0 + k L from offset od (its first of the chunk), since
// SSB_THREADS is a whole number of CH-word rows.
template <int N, bool XBF>
__device__ __forceinline__ void stage(const ScanBwdArgs& p, float* Bs,
                                      float* sd, size_t ob, size_t od,
                                      int nt, int tid, int u0) {
  constexpr int T = Shape<N>::T, CH = Shape<N>::CH, L = Shape<N>::L;
  constexpr int NL = Shape<N>::NL;
  for (int k = 0; tid + k * SSB_THREADS < nt * N; ++k) {
    const int i = tid + k * SSB_THREADS;
    const float bv = __ldg(p.Bm + ob + k * SSB_THREADS);
    const float cv = __ldg(p.C + ob + k * SSB_THREADS);
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      Bs[q * 2 * T * N + (i ^ q)] = bv;
      Bs[q * 2 * T * N + T * N + (i ^ q)] = cv;
    }
  }
  for (int k = 0; u0 + k * L < nt; ++k) {
    const size_t o = od + (size_t)k * L * p.di;
    sd[tid + k * SSB_THREADS] = __ldg(p.dt + o);
    sd[T * CH + tid + k * SSB_THREADS] = ld_x<XBF>(p.x, o);
    sd[2 * T * CH + tid + k * SSB_THREADS] = __ldg(p.dy + o);
  }
}

template <int N>
constexpr size_t smem_bytes() {
  using Sh = Shape<N>;
  return sizeof(float) *
         (size_t)(2 * Sh::T * Sh::NL * SSB_THREADS + 2 * Sh::NL * Sh::T * N +
                  3 * Sh::T * Sh::CH + 2 * Sh::T * W * N);
}

// One block's channels, last chunk first.  FULL: every channel of the
// block is below di (all but the last block of a row), so no lane needs
// the zeros of a channel past di.
template <int N, bool XBF, bool FULL>
__device__ __forceinline__ void walk_block(const ScanBwdArgs& p, float* sm) {
  using Sh = Shape<N>;
  constexpr int T = Sh::T, L = Sh::L, NL = Sh::NL, CH = Sh::CH;
  constexpr int HS = NL * SSB_THREADS;  // history words a step
  static_assert(T * N <= SSB_THREADS, "a chunk's partials: a word a thread");
  // the history: dA_t, then dA_t h_{t-1} ([T][SSB_THREADS][NL] each);
  // the stage: Bm's and C's rows ([T][N] each, NL times), then the
  // channels' dt, x and dy ([T][CH] each); the warps' sums of dC's and
  // dBm's products ([T][W][N] each)
  float* const ha = sm + threadIdx.x * NL;
  float* const Bs = sm + 2 * T * HS;
  float* const sdt = Bs + 2 * NL * T * N;
  float* const red_c = sdt + 3 * T * CH;
  float* const red_b = red_c + T * W * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / L, n0 = (tid % L) * NL;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int S = p.S, di = p.di;
  const int d0 = blk * CH;
  // a lane past di reads channel di - 1's operands (so every address is
  // valid), adds zeros to the sums and stores nothing
  const bool live = FULL || d0 + cl < di;
  const size_t dd = live ? d0 + cl : di - 1;
  const int nC = (S + T - 1) / T;
  const bool writer = chan_sum_writer<NL, L>(lane);
  const int perm = lane_perm<NL>(lane), my_n = n0 + perm;
  float* const Bq = Bs + perm * 2 * T * N;  // the stage's rows in my order

  float a[NL], carry[NL], dacc[NL];
  ldg_perm<NL>(p.A + dd * N + n0, perm, a);
  if (p.dh_final) {
    ldg_perm<NL>(p.dh_final + ((size_t)b * di + dd) * N + n0, perm, carry);
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) carry[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) dacc[i] = 0.f;

  // Offsets at chunk c, each stepped back a chunk at its end: ob, the
  // thread's word of the chunk's rows of Bm and C (and of the block's
  // partials, wo); od, its dt, x and dy at step t0 + u0 of channel
  // min(d0 + tid % CH, di - 1) (its share of the stage); oc, its ddt and
  // dx at step t0; ck, its channel's checkpoint of chunk c.
  const int u0 = tid / CH;
  const int tl = (nC - 1) * T;
  size_t ob = ((size_t)b * S + tl) * N + tid;
  size_t wo = (((size_t)blk * p.B + b) * S + tl) * N + tid;
  size_t od = ((size_t)b * S + tl + u0) * di + min(d0 + tid % CH, di - 1);
  size_t oc = ((size_t)b * S + tl) * di + dd;
  const float* ck = p.ckpt + (((size_t)b * nC + nC - 1) * di + dd) * N + n0;
  const size_t chunk_rows = (size_t)T * N, chunk_steps = (size_t)T * di;
  const size_t chunk_ck = (size_t)di * N;

  // chunk c's operands are staged and h is its checkpoint when its turn
  // comes
  float h[NL];
  stage<N, XBF>(p, Bs, sdt, ob, od, S - tl, tid, u0);
  ldg_perm<NL>(ck, perm, h);
  __syncthreads();
  for (int c = nC - 1; c >= 0; --c) {
    const int nt = min(T, S - c * T);

    // the chunk forward from its checkpoint, in K8's order: dA_t and
    // dA_t h_{t-1} to the history, dC's products summed over the warp
    {
      const float* ps = sdt + cl;
      const float* pb = Bq + n0;
      float* ph = ha;
      float* pr = red_c + warp * N + my_n;
#pragma unroll 1
      for (int u = 0; u < nt; ++u, ps += CH, pb += N, ph += HS, pr += W * N) {
        const float dt = ps[0], xv = ps[T * CH], dy = ps[2 * T * CH];
        float bm[NL], dA[NL], P[NL], v[NL];
        ld_n<NL>(pb, bm);
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          dA[i] = expf(__fmul_rn(dt, a[i]));
          const float dBx = __fmul_rn(__fmul_rn(dt, bm[i]), xv);
          P[i] = __fmul_rn(dA[i], h[i]);
          h[i] = __fadd_rn(P[i], dBx);
          v[i] = live ? __fmul_rn(dy, h[i]) : 0.f;
        }
        st_n<NL>(ph, dA);
        st_n<NL>(ph + T * HS, P);
        const float s = chan_sum<NL, L>(v);
        if (writer) *pr = s;
      }
    }

    // the walk, last step first
    {
      const float* ps = sdt + (nt - 1) * CH + cl;
      const float* pb = Bq + (nt - 1) * N + n0;
      const float* ph = ha + (nt - 1) * HS;
      float* pr = red_b + (nt - 1) * W * N + warp * N + my_n;
      size_t o = oc + (size_t)(nt - 1) * di;
#pragma unroll 1
      for (int u = nt - 1; u >= 0;
           --u, ps -= CH, pb -= N, ph -= HS, pr -= W * N, o -= di) {
        const float dt = ps[0], xv = ps[T * CH], dy = ps[2 * T * CH];
        const float dtx = __fmul_rn(dt, xv);
        float bm[NL], cc[NL], dA[NL], P[NL], v[NL];
        ld_n<NL>(pb, bm);
        ld_n<NL>(pb + T * N, cc);
        ld_n<NL>(ph, dA);
        ld_n<NL>(ph + T * HS, P);
        float qa[NL], gb[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float g = __fadd_rn(__fmul_rn(dy, cc[i]), carry[i]);
          const float q = __fmul_rn(g, P[i]);
          qa[i] = __fmul_rn(q, a[i]);
          gb[i] = __fmul_rn(g, bm[i]);
          dacc[i] = __fadd_rn(dacc[i], __fmul_rn(q, dt));
          v[i] = live ? __fmul_rn(g, dtx) : 0.f;
          carry[i] = __fmul_rn(dA[i], g);
        }
        // the sums over n: a pairwise tree over the lane's states (its
        // register pairs are state pairs whatever its perm), then over
        // the channel's lanes, 1 apart, then 2, ...
        float sa = pair_sum<NL>(qa), sgb = pair_sum<NL>(gb);
#pragma unroll
        for (int k = 1; k < L; k <<= 1) {
          sa = __fadd_rn(sa, __shfl_xor_sync(0xffffffffu, sa, k));
          sgb = __fadd_rn(sgb, __shfl_xor_sync(0xffffffffu, sgb, k));
        }
        if (live && n0 == 0) {
          p.ddt[o] = __fadd_rn(sa, __fmul_rn(sgb, xv));
          st_x<XBF>(p.dx, o, __fmul_rn(dt, sgb));
        }
        const float s = chan_sum<NL, L>(v);
        if (writer) *pr = s;
      }
    }
    __syncthreads();

    // the block's partials of the chunk's dBm and dC: the warps in order
    if (tid < nt * N) {
      const int u = tid / N, n = tid % N;
      float sb = red_b[u * W * N + n], sc = red_c[u * W * N + n];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        sb = __fadd_rn(sb, red_b[(u * W + w) * N + n]);
        sc = __fadd_rn(sc, red_c[(u * W + w) * N + n]);
      }
      p.ws_b[wo] = sb;
      p.ws_c[wo] = sc;
    }
    if (c > 0) {  // chunk c - 1's turn
      ob -= chunk_rows;
      wo -= chunk_rows;
      od -= chunk_steps;
      oc -= chunk_steps;
      ck -= chunk_ck;
      stage<N, XBF>(p, Bs, sdt, ob, od, T, tid, u0);
      ldg_perm<NL>(ck, perm, h);
      __syncthreads();
    }
  }
  if (live) {
    stg_perm<NL>(p.ws_a + ((size_t)b * di + dd) * N + n0, perm, dacc);
    if (p.dh0)
      stg_perm<NL>(p.dh0 + ((size_t)b * di + dd) * N + n0, perm, carry);
  }
}

template <int N, bool XBF>
__global__ void __launch_bounds__(SSB_THREADS, SSB_SM_THREADS / SSB_THREADS)
    selective_scan_bwd_kernel(ScanBwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  if ((blockIdx.x + 1) * Shape<N>::CH <= p.di)
    walk_block<N, XBF, true>(p, sm);
  else
    walk_block<N, XBF, false>(p, sm);
}

// dBm and dC: the blocks' partials in ascending order; dA: the batch
// rows' in ascending order.  One thread an output value.
__global__ void __launch_bounds__(SUM_THREADS)
    selective_scan_bwd_sum_kernel(ScanBwdArgs p, int nblk) {
  const size_t nbs = (size_t)p.B * p.S * p.N;
  const size_t na = (size_t)p.di * p.N;
  const size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i < nbs) {
    float sb = p.ws_b[i], sc = p.ws_c[i];
#pragma unroll 8
    for (int k = 1; k < nblk; ++k) {
      sb = __fadd_rn(sb, p.ws_b[k * nbs + i]);
      sc = __fadd_rn(sc, p.ws_c[k * nbs + i]);
    }
    p.dBm[i] = sb;
    p.dC[i] = sc;
  } else if (i < nbs + na) {
    const size_t j = i - nbs;
    float s = p.ws_a[j];
    for (int k = 1; k < p.B; ++k) s = __fadd_rn(s, p.ws_a[k * na + j]);
    p.dA[j] = s;
  }
}

template <int N, bool XBF>
cudaError_t launch_n(const ScanBwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  static_assert(smem <= 232448, "K8b: over a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N, XBF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nblk = (a.di + SSB_CHANNELS(N) - 1) / SSB_CHANNELS(N);
  selective_scan_bwd_kernel<N, XBF>
      <<<dim3(nblk, a.B), SSB_THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)a.B * a.S * a.N + (size_t)a.di * a.N;
  selective_scan_bwd_sum_kernel<<<(unsigned)((total + SUM_THREADS - 1) /
                                             SUM_THREADS),
                                  SUM_THREADS, 0, stream>>>(a, nblk);
  return cudaGetLastError();
}

template <bool XBF>
cudaError_t launch_any(const ScanBwdArgs& a, cudaStream_t stream) {
  switch (a.N) {
    case 1: return launch_n<1, XBF>(a, stream);
    case 2: return launch_n<2, XBF>(a, stream);
    case 4: return launch_n<4, XBF>(a, stream);
    case 8: return launch_n<8, XBF>(a, stream);
    case 16: return launch_n<16, XBF>(a, stream);
    case 32: return launch_n<32, XBF>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_selective_scan_bwd(const ScanBwdArgs& a, int x_bf16,
                                      cudaStream_t stream) {
  if (a.B == 0 || a.S == 0 || a.di == 0) return cudaErrorInvalidValue;
  return x_bf16 ? launch_any<true>(a, stream) : launch_any<false>(a, stream);
}
