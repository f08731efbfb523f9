// K1 fused_flow_serve: the whole stateful pipeline in one launch —
// register update, WindowStats readout, MLP, argmax — for one table and
// the "mlp" suffix.
//
// Replaces the TPU kernel repro/kernels/fused_flow/kernel.py:338
// (_serve_kernel, launched by fused_flow_serve_padded :442) for a Plan
// with one table, the "mlp" suffix and no mitigation.
//
// Bound: bytes, as K2 plus the classifier weights (staged once per block
// into shared memory) and minus the [B, W] feature rows, which never
// leave the warp: each packet's post-update row is read out, classified
// and reduced to an int32 verdict written straight to the packet's
// arrival index (no inverse-permutation gather).  Like K2 it is latency
// bound by the deepest slot chain, which one warp walks serially; here
// each step of the chain also runs the MLP.
//
// Readout (suffix_readout, fused_flow/kernel.py:137): mode 0 "all" =
// counters ++ EWMAs raw ++ histograms / max(count, 1); 1 "hist" = the
// normalised histograms only; 2 "raw" = the row as is.  The divide is
// the IEEE divide (no fast math), so readout rows match bit for bit.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps; warp k owns segment
// k, and when arrival row k is padding it also writes that row's verdict
// (the classifier on an all-zero readout row, as the reference does).

#include "flow_chain.cuh"
#include "mlp_argmax.cuh"

namespace {

struct EmitVerdict {
  float* hbuf;
  const float* smem_w;
  const MlpDims* d;
  int* verdicts;
  int W, head, mode;

  __device__ __forceinline__ void operator()(int p,
                                             const float (&row)[RT_COLS],
                                             int lane) {
    const float count = __shfl_sync(0xffffffffu, row[0], 0);
    const float denom = fmaxf(count, 1.f);
#pragma unroll
    for (int j = 0; j < RT_COLS; ++j) {
      const int c = lane + 32 * j;
      if (c < W) {
        const float v = row[j];
        if (mode == 2) {
          hbuf[c] = v;
        } else if (c >= head) {
          hbuf[mode == 1 ? c - head : c] = v / denom;
        } else if (mode == 0) {
          hbuf[c] = v;
        }
      }
    }
    const int cls = mlp_argmax(hbuf, smem_w, *d, lane);
    if (lane == 0) verdicts[p] = cls;
  }
};

__global__ void fused_flow_kernel(FlowArgs a, MlpDims d, const float* w,
                                  const float* b, int* verdicts, int mode) {
  extern __shared__ float smem[];
  mlp_load(smem, w, b, d);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * RT_WARPS + warp;
  if (k >= a.B) return;
  float* hbuf = smem + d.n_w + d.n_b + warp * 2 * RT_MAX_MLP_WIDTH;
  if (a.valid[k] == 0) {                     // padding: zero readout row
    for (int i = lane; i < d.widths[0]; i += 32) hbuf[i] = 0.f;
    const int cls = mlp_argmax(hbuf, smem, d, lane);
    if (lane == 0) verdicts[k] = cls;
  }
  EmitVerdict emit{hbuf, smem, &d, verdicts, a.W, a.C + a.E, mode};
  flow_chain(a, k, lane, emit);
}

}  // namespace

cudaError_t launch_fused_flow_serve(const FlowArgs& a, const MlpDims& d,
                                    const float* w, const float* b,
                                    int* verdicts, int mode,
                                    cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  const size_t smem = mlp_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.B + RT_WARPS - 1) / RT_WARPS;
  fused_flow_kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(
      a, d, w, b, verdicts, mode);
  return cudaGetLastError();
}
