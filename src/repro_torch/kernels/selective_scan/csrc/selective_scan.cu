// K8 selective_scan: the Mamba S6 recurrence over the sequence,
//   h_t = dA_t * h_{t-1} + dBx_t        (elementwise over [di, N])
//   y_t[d] = sum_n h_t[d, n] * C_t[n]
// C [B, S, N] f32, h0 [B, di, N] f32 -> y [B, S, di] f32 and h_final
// [B, di, N] f32.  One kernel template, two entries:
//
//   selective_scan_kernel<N, false, false>: the TPU kernel's interface,
//     dA and dBx [B, S, di, N] f32 as the caller discretized them;
//   selective_scan_kernel<N, true, XBF>: the discretizing entry, dt [B,
//     S, di] f32, A [di, N] f32, Bm [B, S, N] f32 and x [B, S, di] (bf16
//     when XBF, else f32, widened in registers: exact), forming
//       dA_t[d, n]  = expf(dt_t[d] * A[d, n])
//       dBx_t[d, n] = (dt_t[d] * Bm_t[n]) * x_t[d]
//     in registers, in the reference's expression order
//     (repro/models/ssm.py:117-121), so that no [B, S, di, N] tensor
//     exists.
//
// Both replace the TPU kernel repro/kernels/selective_scan/kernel.py:35
// (_scan_kernel, launched by selective_scan_pallas :75), which computes
// what kernels/selective_scan/ref.py computes; the port's hybrid LM path
// runs the discretizing entry in every Mamba mixer, for prefill and for
// each decode step (S = 1).
//
// Bound: bytes.  The discretizing entry reads dt and x and writes y once
// (3 * B * S * di words), reads B and C (2 * B * S * N), A (di * N) and
// h0 and writes h_final (2 * B * di * N), over 3.35 TB/s; its 8
// operations per (t, d, n), expf counted as one, take about half that
// at the f32 rate, but expf without fast math issues several
// instructions.  The TPU interface reads dA and dBx, 2 * B * S * di * N
// words, instead of dt and x.
//
// Design.  The TPU kernel keeps h in VMEM scratch across a sequential
// grid axis over chunks of time.  Here the time loop runs inside the
// thread: one thread per channel (b, d) holds its N states (and, to
// discretize, its row of A) in registers for the whole sequence, so h
// never touches device memory between steps and y_t[d] is summed in
// registers, over n in ascending order.  A block of 128 threads covers
// 128 consecutive channels of one batch row, so each warp's loads of dt
// and x and its stores of y are 32 consecutive words; the loads of
// SS_UNROLL steps are issued before their steps run.  B and C for
// SS_TCHUNK steps are staged once a block in shared memory, behind one
// barrier a chunk, and read as broadcasts.  h0, h_final, A and the dA /
// dBx rows go by 16-byte vector loads and stores where N is a multiple
// of 4.  Every product and sum is __fmul_rn / __fadd_rn, so that nvcc
// contracts nothing into an FMA that the reference's expressions do not
// have; expf is the IEEE-accurate one (no fast math).
//
// Under autograd the discretizing entry runs as selective_scan_ckpt_kernel
// <N, XBF>: the same body, which also stores h entering every chunk of
// SSB_CHUNK(N) steps (ckpt [B, ceil(S / SSB_CHUNK(N)), di, N]) for K8b
// (selective_scan_bwd.cu) to recompute its chunks from.  The serving
// instances compile the body with that store left out.

#include <cuda_bf16.h>

#include "rt_types.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int SS_THREADS = 128;  // channels per block
constexpr int SS_TCHUNK = 32;    // steps of B and C staged in shared memory
constexpr int SS_UNROLL = 8;     // steps whose loads are in flight together

// a row of N floats from global memory, by 16-byte loads where N allows
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

// the same from shared memory (a broadcast: every thread reads one row)
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

struct ScanPtrs {
  const float* dA;    // TPU interface: [B, S, di, N]
  const float* dBx;
  const float* dt;    // discretizing: [B, S, di]
  const float* A;     // [di, N]
  const float* Bm;    // [B, S, N]
  const void* x;      // [B, S, di], f32 or bf16
  const float* C;     // [B, S, N]
  const float* h0;    // [B, di, N]
  float* y;           // [B, S, di]
  float* h_out;       // [B, di, N]
  float* ckpt;        // CKPT: [B, ceil(S / SSB_CHUNK(N)), di, N]
};

template <int N, bool DISC, bool XBF, bool CKPT>
__device__ __forceinline__ void scan_body(const ScanPtrs& p, int S, int di) {
  // steps in flight: DISC holds a word or two a step, the TPU interface
  // 2 N words, so it keeps about 64 words in flight
  constexpr int U =
      DISC || 32 / N > SS_UNROLL ? SS_UNROLL : 32 / N;
  constexpr int NB = DISC ? N : 1;                  // operand words a step
  constexpr int NA = DISC ? 1 : N;
  __shared__ __align__(16) float Bs[DISC ? SS_TCHUNK * N : 4];
  __shared__ __align__(16) float Cs[SS_TCHUNK * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * SS_THREADS + threadIdx.x;
  // a thread past di reads channel di - 1's operands (so every address
  // is valid) and stores nothing; it still stages B and C
  const bool live = d < di;
  const size_t dd = live ? d : di - 1;
  const size_t row = (size_t)b * S * di + dd;       // (b, t = 0, d)
  float h[N], a[NB];
  ldg_row<N>(p.h0 + ((size_t)b * di + dd) * N, h);
  if constexpr (DISC) ldg_row<N>(p.A + dd * N, a);

  for (int t0 = 0; t0 < S; t0 += SS_TCHUNK) {
    const int nt = min(SS_TCHUNK, S - t0);
    __syncthreads();  // the last chunk's readers are done with Bs and Cs
    const size_t c0 = ((size_t)b * S + t0) * N;
    for (int i = threadIdx.x; i < nt * N; i += SS_THREADS) {
      Cs[i] = __ldg(p.C + c0 + i);
      if constexpr (DISC) Bs[i] = __ldg(p.Bm + c0 + i);
    }
    __syncthreads();
    for (int u0 = 0; u0 < nt; u0 += U) {
      // DISC: rd = dt, rx = x; TPU interface: rd = the dA row, rx dBx
      float rd[U][NA], rx[U][NA];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < nt) {  // the same for every thread of the block
          const size_t off = row + (size_t)(t0 + u0 + u) * di;
          if constexpr (DISC) {
            rd[u][0] = __ldg(p.dt + off);
            rx[u][0] = ld_x<XBF>(p.x, off);
          } else {
            ldg_row<N>(p.dA + off * N, rd[u]);
            ldg_row<N>(p.dBx + off * N, rx[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < nt) {
          if constexpr (CKPT) {
            constexpr int T = SSB_CHUNK(N);
            const int t = t0 + u0 + u;
            if (live && t % T == 0)
              stg_row<N>(p.ckpt + (((size_t)b * ((S + T - 1) / T) + t / T)
                                   * di + dd) * N, h);
          }
          float c[N];
          lds_row<N>(Cs + (u0 + u) * N, c);
          float bm[NB];
          if constexpr (DISC) lds_row<N>(Bs + (u0 + u) * N, bm);
          float yv = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            float dA, dBx;
            if constexpr (DISC) {
              dA = expf(__fmul_rn(rd[u][0], a[n]));
              dBx = __fmul_rn(__fmul_rn(rd[u][0], bm[n]), rx[u][0]);
            } else {
              dA = rd[u][n];
              dBx = rx[u][n];
            }
            h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
            const float hc = __fmul_rn(h[n], c[n]);
            yv = n == 0 ? hc : __fadd_rn(yv, hc);
          }
          if (live) p.y[row + (size_t)(t0 + u0 + u) * di] = yv;
        }
      }
    }
  }
  if (live) stg_row<N>(p.h_out + ((size_t)b * di + dd) * N, h);
}

template <int N, bool DISC, bool XBF>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_kernel(ScanPtrs p, int S, int di) {
  scan_body<N, DISC, XBF, false>(p, S, di);
}

template <int N, bool XBF>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_ckpt_kernel(ScanPtrs p, int S, int di) {
  scan_body<N, true, XBF, true>(p, S, di);
}

template <int N, bool DISC, bool XBF, bool CKPT>
cudaError_t launch_n(const ScanPtrs& p, const ScanArgs& a,
                     cudaStream_t stream) {
  const dim3 grid((a.di + SS_THREADS - 1) / SS_THREADS, a.B);
  if constexpr (CKPT)
    selective_scan_ckpt_kernel<N, XBF><<<grid, SS_THREADS, 0, stream>>>(
        p, a.S, a.di);
  else
    selective_scan_kernel<N, DISC, XBF><<<grid, SS_THREADS, 0, stream>>>(
        p, a.S, a.di);
  return cudaGetLastError();
}

template <bool DISC, bool XBF, bool CKPT = false>
cudaError_t launch_any(const ScanPtrs& p, const ScanArgs& a,
                       cudaStream_t stream) {
  if (a.B == 0 || a.di == 0) return cudaSuccess;
  switch (a.N) {
    case 1: return launch_n<1, DISC, XBF, CKPT>(p, a, stream);
    case 2: return launch_n<2, DISC, XBF, CKPT>(p, a, stream);
    case 4: return launch_n<4, DISC, XBF, CKPT>(p, a, stream);
    case 8: return launch_n<8, DISC, XBF, CKPT>(p, a, stream);
    case 16: return launch_n<16, DISC, XBF, CKPT>(p, a, stream);
    case 32: return launch_n<32, DISC, XBF, CKPT>(p, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_selective_scan(const float* dA, const float* dBx,
                                  const float* C, const float* h0, float* y,
                                  float* h_out, const ScanArgs& a,
                                  cudaStream_t stream) {
  ScanPtrs p{};
  p.dA = dA;
  p.dBx = dBx;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.h_out = h_out;
  return launch_any<false, false>(p, a, stream);
}

cudaError_t launch_selective_scan_discretized(
    const float* dt, const float* A, const float* Bm, const float* C,
    const void* x, int x_bf16, const float* h0, float* y, float* h_out,
    const ScanArgs& a, cudaStream_t stream) {
  ScanPtrs p{};
  p.dt = dt;
  p.A = A;
  p.Bm = Bm;
  p.x = x;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.h_out = h_out;
  return x_bf16 ? launch_any<true, true>(p, a, stream)
                : launch_any<true, false>(p, a, stream);
}

cudaError_t launch_selective_scan_discretized_ckpt(
    const float* dt, const float* A, const float* Bm, const float* C,
    const void* x, int x_bf16, const float* h0, float* y, float* h_out,
    float* ckpt, const ScanArgs& a, cudaStream_t stream) {
  ScanPtrs p{};
  p.dt = dt;
  p.A = A;
  p.Bm = Bm;
  p.x = x;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.h_out = h_out;
  p.ckpt = ckpt;
  return x_bf16 ? launch_any<true, true, true>(p, a, stream)
                : launch_any<true, false, true>(p, a, stream);
}
