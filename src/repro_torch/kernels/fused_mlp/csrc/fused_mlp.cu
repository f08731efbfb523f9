// K3 fused_mlp_classify: ReLU MLP + argmax -> int32 class ids.
//
// Replaces the TPU kernel repro/kernels/fused_mlp/kernel.py:71
// (_classify_kernel, launched by fused_mlp_classify_padded :93).
//
// Bound: bytes at the serving shapes.  A per-packet model of a few
// hundred weights does ~1.2 kFLOP per row against 4*d_0 + 4 bytes in and
// out, so the rows and the one-time weight load set the floor; the card's
// f32 rate is far away.  The design reads the weights from device memory
// once per block into shared memory and each input row once; logits never
// leave the warp.  No lane padding: each layer runs at its true width.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps, one row per warp.

#include "mlp_argmax.cuh"

namespace {

__global__ void fused_mlp_kernel(const float* x, int B, MlpDims d,
                                 const float* w, const float* b, int* out) {
  extern __shared__ float smem[];
  mlp_load(smem, w, b, d);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * RT_WARPS + warp;
  if (p >= B) return;
  float* hbuf = smem + d.n_w + d.n_b + warp * 2 * RT_MAX_MLP_WIDTH;
  const int d0 = d.widths[0];
  for (int i = lane; i < d0; i += 32) hbuf[i] = x[(size_t)p * d0 + i];
  const int cls = mlp_argmax(hbuf, smem, d, lane);
  if (lane == 0) out[p] = cls;
}

}  // namespace

cudaError_t launch_fused_mlp_classify(const float* x, int B,
                                      const MlpDims& d, const float* w,
                                      const float* b, int* out,
                                      cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const size_t smem = mlp_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + RT_WARPS - 1) / RT_WARPS;
  fused_mlp_kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(x, B, d, w, b,
                                                            out);
  return cudaGetLastError();
}
