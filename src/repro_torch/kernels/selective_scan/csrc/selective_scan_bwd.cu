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
// Bound: bytes.  dt, x and dy read once and ddt and dx written once (5 B
// S di words, x's two in its dtype), Bm, C, dBm and dC (4 B S N), A, dA,
// h0 / dh_final / dh0, the checkpoints (B ceil(S / T) di N).  The
// operations are about three times K8's (the chunk's forward again, then
// the walk), and K8's discretizing entry is already instruction-bound.
//
// Design: K8's layout.  One thread per channel (b, d) holds its row of A,
// its N-wide g (as the carry dA_{t+1} g_{t+1}) and its N partial sums of
// dA in registers; a block is SSB_THREADS consecutive channels of one
// batch row.  The walk needs h_{t-1} at every step, and h_{t-1} = (h_t -
// dBx_t) / dA_t is not computed: dA can be tiny.  Instead K8's forward
// under autograd (selective_scan_ckpt_kernel) stores h entering every
// chunk of T = SSB_CHUNK(N) steps (T N = SSB_HIST words, 8 steps at N =
// 16), and the walk takes the chunks last to first: it recomputes the
// chunk forward from its checkpoint in K8's order, keeping each h_{t-1}
// in shared memory (hist, [T][N][SSB_THREADS]: consecutive threads,
// consecutive words), then walks the chunk backward.  This is the scheme
// of the upstream Mamba CUDA kernels' backward, over a thread's own
// channel instead of over a block's steps.  dt, x and dy of the chunk go
// to registers by T independent loads before its steps run; Bm and C are
// staged in shared memory once a block, as in K8.
//
// No atomics: the sums across channels (dBm, dC) go by a butterfly over
// each warp's 32 lanes (lanes 16 apart first, then 8, ..., 1: each lane
// ends with one n's warp sum), the warps' sums are added in order at the
// chunk's end, and each block writes its partial to ws_b / ws_c
// [blk][b][t][n]; dA's partials over t stay in registers and go to ws_a
// [b][d][n].  A second launch adds the partials over the blocks (and dA's
// over the batch) in ascending order, so two calls give the same bits;
// kernels/selective_scan/ref.py's selective_scan_bwd_chunked_ref writes
// out this schedule.  Every product and sum is __fmul_rn / __fadd_rn (no
// contraction into FMAs) and expf is the IEEE-accurate one, as in K8.

#include <cuda_bf16.h>

#include "rt_types.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int W = SSB_THREADS / 32;  // warps a block
constexpr int SUM_THREADS = 256;     // the partials' sum: threads a block

template <int N>
__device__ __forceinline__ void ldg_row(const float* p, float* r) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __ldg(p + i);
  }
}

template <int N>
__device__ __forceinline__ void lds_row(const float* p, float* r) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void stg_row(float* p, const float* r) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = r[i];
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

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// v[N] on each lane -> the warp's sum of v[n] for n = lane >> (5 - log2
// N): halving steps over lanes 16, 8, ... apart while more than one value
// is left (each lane keeps one half and sends the other), then the lanes
// that hold the same n add theirs.  Every lane of one n ends with the
// same bits (a + b = b + a).
template <int N>
__device__ __forceinline__ float warp_sum_scatter(float* v, int lane) {
  constexpr int LG = log2i(N);
#pragma unroll
  for (int k = 0; k < LG; ++k) {
    const int o = 16 >> k;
    const int h = (N >> k) / 2;
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
  float r = v[0];
#pragma unroll
  for (int o = 16 >> LG; o >= 1; o >>= 1)
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

template <int N>
constexpr size_t smem_bytes() {
  constexpr int T = SSB_CHUNK(N);
  return sizeof(float) *
         (size_t)(T * N * SSB_THREADS + 2 * T * N + 2 * T * W * N);
}

template <int N, bool XBF>
__global__ void __launch_bounds__(SSB_THREADS)
    selective_scan_bwd_kernel(ScanBwdArgs p) {
  constexpr int T = SSB_CHUNK(N);
  constexpr int SPREAD = 32 / N;         // lanes that end with one n's sum
  extern __shared__ __align__(16) float sm[];
  float* hist = sm;                            // [T][N][SSB_THREADS]
  float* Bs = hist + T * N * SSB_THREADS;      // [T][N]
  float* Cs = Bs + T * N;                      // [T][N]
  float* red_c = Cs + T * N;                   // [T][W][N]
  float* red_b = red_c + T * W * N;            // [T][W][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int S = p.S, di = p.di;
  const int d = blk * SSB_THREADS + tid;
  // a thread past di reads channel di - 1's operands (so every address
  // is valid), adds zeros to the sums and stores nothing
  const bool live = d < di;
  const size_t dd = live ? d : di - 1;
  const size_t row = (size_t)b * S * di + dd;  // (b, t = 0, d)
  const int nC = (S + T - 1) / T;
  const bool writer = lane % SPREAD == 0;
  const int my_n = lane / SPREAD;

  float a[N], carry[N], dacc[N];
  ldg_row<N>(p.A + dd * N, a);
  if (p.dh_final) {
    ldg_row<N>(p.dh_final + ((size_t)b * di + dd) * N, carry);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) carry[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) dacc[n] = 0.f;

  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * T;
    const int nt = min(T, S - t0);
    __syncthreads();  // the last chunk's readers are done with the stage
    const size_t c0 = ((size_t)b * S + t0) * N;
    for (int i = tid; i < nt * N; i += SSB_THREADS) {
      Bs[i] = __ldg(p.Bm + c0 + i);
      Cs[i] = __ldg(p.C + c0 + i);
    }
    float rdt[T], rx[T], rdy[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u < nt) {  // the same for every thread of the block
        const size_t off = row + (size_t)(t0 + u) * di;
        rdt[u] = __ldg(p.dt + off);
        rx[u] = ld_x<XBF>(p.x, off);
        rdy[u] = __ldg(p.dy + off);
      }
    }
    __syncthreads();

    // the chunk forward from its checkpoint, in K8's order: h_{t-1} to
    // hist, dC's products summed over the block's channels
    float h[N];
    ldg_row<N>(p.ckpt + (((size_t)b * nC + c) * di + dd) * N, h);
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u < nt) {
        float bm[N], v[N];
        lds_row<N>(Bs + u * N, bm);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          hist[(u * N + n) * SSB_THREADS + tid] = h[n];
          const float dA = expf(__fmul_rn(rdt[u], a[n]));
          const float dBx = __fmul_rn(__fmul_rn(rdt[u], bm[n]), rx[u]);
          h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
          v[n] = live ? __fmul_rn(rdy[u], h[n]) : 0.f;
        }
        const float s = warp_sum_scatter<N>(v, lane);
        if (writer) red_c[(u * W + warp) * N + my_n] = s;
      }
    }

    // the walk, last step first
#pragma unroll
    for (int u = T - 1; u >= 0; --u) {
      if (u < nt) {
        float bm[N], cc[N], v[N];
        lds_row<N>(Bs + u * N, bm);
        lds_row<N>(Cs + u * N, cc);
        const float dt = rdt[u], xv = rx[u];
        const float dtx = __fmul_rn(dt, xv);
        float sa = 0.f, sgb = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float g = __fadd_rn(__fmul_rn(rdy[u], cc[n]), carry[n]);
          const float dA = expf(__fmul_rn(dt, a[n]));
          const float q = __fmul_rn(
              g, __fmul_rn(dA, hist[(u * N + n) * SSB_THREADS + tid]));
          const float qa = __fmul_rn(q, a[n]);
          const float gb = __fmul_rn(g, bm[n]);
          sa = n == 0 ? qa : __fadd_rn(sa, qa);
          sgb = n == 0 ? gb : __fadd_rn(sgb, gb);
          dacc[n] = __fadd_rn(dacc[n], __fmul_rn(q, dt));
          v[n] = live ? __fmul_rn(g, dtx) : 0.f;
          carry[n] = __fmul_rn(dA, g);
        }
        const float s = warp_sum_scatter<N>(v, lane);
        if (writer) red_b[(u * W + warp) * N + my_n] = s;
        if (live) {
          const size_t off = row + (size_t)(t0 + u) * di;
          p.ddt[off] = __fadd_rn(sa, __fmul_rn(sgb, xv));
          st_x<XBF>(p.dx, off, __fmul_rn(dt, sgb));
        }
      }
    }
    __syncthreads();

    // the block's partials of the chunk's dBm and dC: the warps in order
    for (int i = tid; i < nt * N; i += SSB_THREADS) {
      const int u = i / N, n = i % N;
      float sb = red_b[u * W * N + n], sc = red_c[u * W * N + n];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        sb = __fadd_rn(sb, red_b[(u * W + w) * N + n]);
        sc = __fadd_rn(sc, red_c[(u * W + w) * N + n]);
      }
      const size_t o = (((size_t)blk * p.B + b) * S + t0 + u) * N + n;
      p.ws_b[o] = sb;
      p.ws_c[o] = sc;
    }
  }
  if (live) {
    stg_row<N>(p.ws_a + ((size_t)b * di + dd) * N, dacc);
    if (p.dh0) stg_row<N>(p.dh0 + ((size_t)b * di + dd) * N, carry);
  }
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
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N, XBF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nblk = (a.di + SSB_THREADS - 1) / SSB_THREADS;
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
