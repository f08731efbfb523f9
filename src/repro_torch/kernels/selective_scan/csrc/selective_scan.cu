// K8 selective_scan: the Mamba S6 recurrence over the sequence,
//   h_t = dA_t * h_{t-1} + dBx_t        (elementwise over [di, N])
//   y_t[d] = sum_n h_t[d, n] * C_t[n]
// dA and dBx [B, S, di, N] f32, C [B, S, N] f32, h0 [B, di, N] f32 ->
// y [B, S, di] f32 and h_final [B, di, N] f32.
//
// Replaces the TPU kernel repro/kernels/selective_scan/kernel.py:35
// (_scan_kernel, launched by selective_scan_pallas :75), which computes
// what kernels/selective_scan/ref.py computes.  The port's hybrid LM path
// runs it in every Mamba mixer, for prefill and for each decode step
// (S = 1).
//
// Bound: bytes.  dA and dBx are read once (2 * 4 * B * S * di * N), y
// written once, h0 read and h_final written once, over 3.35 TB/s; the
// 4 operations per (t, d, n) over 67 TFLOP/s take a tenth of that.
//
// Design.  The TPU kernel keeps h in VMEM scratch across a sequential
// grid axis over chunks of time.  Here the time loop runs inside the
// thread: one thread per (b, d, n) holds its h in a register for the
// whole sequence, so h never touches device memory between steps.  A
// block of 256 threads covers 256 / N consecutive channels d of one
// batch row b, so at each step the block's loads of dA and dBx are one
// contiguous run of 256 floats.  The loads of SS_UNROLL steps are issued
// together before their recurrence steps, to keep enough bytes in flight
// for the memory rate.  C for SS_TCHUNK steps is staged in shared
// memory.  The readout over n is a butterfly of __shfl_xor_sync inside
// each aligned group of N lanes (N a power of two <= 32, so a group
// never straddles a warp); lane n = 0 stores y.  The step is written
// with __fmul_rn / __fadd_rn so that nvcc does not contract dA * h + dBx
// into an FMA that the reference's expression does not have.

#include "rt_types.h"

namespace {

constexpr int SS_THREADS = 256;
constexpr int SS_TCHUNK = 32;  // steps of C staged in shared memory
constexpr int SS_UNROLL = 8;   // steps whose loads are in flight together

template <int N>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_kernel(const float* __restrict__ dA,
                          const float* __restrict__ dBx,
                          const float* __restrict__ C,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_out,
                          int S, int di) {
  constexpr int DPB = SS_THREADS / N;  // channels per block
  __shared__ float Cs[SS_TCHUNK * N];
  const int b = blockIdx.y;
  const int n = threadIdx.x & (N - 1);
  const int d = blockIdx.x * DPB + threadIdx.x / N;
  // a whole N-lane group is live or not, so the shuffles stay inside
  // live lanes' groups; dead lanes still take part in them
  const bool live = d < di;
  const size_t step = (size_t)di * N;  // stride of t in dA and dBx
  const size_t col = (size_t)d * N + n;
  const float* pa = dA + (size_t)b * S * step + col;
  const float* pb = dBx + (size_t)b * S * step + col;
  const float* pc = C + (size_t)b * S * N;
  float* py = y + (size_t)b * S * di + d;
  float h = live ? h0[(size_t)b * step + col] : 0.f;

  for (int t0 = 0; t0 < S; t0 += SS_TCHUNK) {
    const int nt = min(SS_TCHUNK, S - t0);
    __syncthreads();  // the last chunk's readers are done with Cs
    for (int i = threadIdx.x; i < nt * N; i += SS_THREADS)
      Cs[i] = pc[(size_t)t0 * N + i];
    __syncthreads();
    for (int u0 = 0; u0 < nt; u0 += SS_UNROLL) {
      float ra[SS_UNROLL], rb[SS_UNROLL];
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u) {
        const bool in = live && u0 + u < nt;
        const size_t off = (size_t)(t0 + u0 + u) * step;
        ra[u] = in ? __ldg(pa + off) : 0.f;
        rb[u] = in ? __ldg(pb + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u) {
        if (u0 + u < nt) {  // the same for every thread of the block
          h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
          float v = __fmul_rn(h, Cs[(u0 + u) * N + n]);
#pragma unroll
          for (int o = N / 2; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (live && n == 0) py[(size_t)(t0 + u0 + u) * di] = v;
        }
      }
    }
  }
  if (live) h_out[(size_t)b * step + col] = h;
}

template <int N>
cudaError_t launch_n(const float* dA, const float* dBx, const float* C,
                     const float* h0, float* y, float* h_out,
                     const ScanArgs& a, cudaStream_t stream) {
  constexpr int DPB = SS_THREADS / N;
  dim3 grid((a.di + DPB - 1) / DPB, a.B);
  selective_scan_kernel<N><<<grid, SS_THREADS, 0, stream>>>(
      dA, dBx, C, h0, y, h_out, a.S, a.di);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_selective_scan(const float* dA, const float* dBx,
                                  const float* C, const float* h0, float* y,
                                  float* h_out, const ScanArgs& a,
                                  cudaStream_t stream) {
  if (a.B == 0 || a.di == 0) return cudaSuccess;
  switch (a.N) {
    case 1: return launch_n<1>(dA, dBx, C, h0, y, h_out, a, stream);
    case 2: return launch_n<2>(dA, dBx, C, h0, y, h_out, a, stream);
    case 4: return launch_n<4>(dA, dBx, C, h0, y, h_out, a, stream);
    case 8: return launch_n<8>(dA, dBx, C, h0, y, h_out, a, stream);
    case 16: return launch_n<16>(dA, dBx, C, h0, y, h_out, a, stream);
    case 32: return launch_n<32>(dA, dBx, C, h0, y, h_out, a, stream);
    default: return cudaErrorInvalidValue;
  }
}
