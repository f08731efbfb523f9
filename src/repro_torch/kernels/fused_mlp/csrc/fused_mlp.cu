// K3 fused_mlp_classify: ReLU MLP + argmax -> int32 class ids, and
// K5 fused_mlp: ReLU MLP -> f32 logits.
//
// Replace the TPU kernels repro/kernels/fused_mlp/kernel.py:71
// (_classify_kernel, launched by fused_mlp_classify_padded :93) and :59
// (_kernel, launched by fused_mlp_padded :267).
//
// Bound: bytes at the serving shapes.  A per-packet model of a few
// hundred weights does ~1.2 kFLOP per row against 4*d_0 + 4 bytes in and
// out (4*C out for K5), so the rows and the one-time weight load set the
// floor; the card's f32 rate is far away.  The design reads each input
// row once and, when the model fits, the weights once per block into
// shared memory (mlp_argmax.cuh); K3's logits never leave the warp.  No
// lane padding: each layer runs at its true width.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps, one row per warp.

#include "mlp_argmax.cuh"

namespace {

// LOGITS: write the last layer [B, C] to out_f; else the class id to out_i.
template <bool LOGITS>
__global__ void fused_mlp_kernel(const float* x, int B, MlpDims d,
                                 const float* w, const float* b,
                                 int* out_i, float* out_f) {
  extern __shared__ float smem[];
  const bool staged = mlp_fits_smem(d, RT_MLP_HBUF_FLOATS);
  const MlpParams p = mlp_stage(smem, w, b, d, staged);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * RT_WARPS + warp;
  if (row >= B) return;
  float* hbuf = smem + (staged ? d.n_w + d.n_b : 0) +
                warp * 2 * RT_MAX_MLP_WIDTH;
  const int d0 = d.widths[0];
  for (int i = lane; i < d0; i += 32) hbuf[i] = x[(size_t)row * d0 + i];
  if constexpr (LOGITS) {
    const float* logits = mlp_forward(hbuf, p, d, lane);
    const int C = d.widths[d.n_layers];
    for (int o = lane; o < C; o += 32) out_f[(size_t)row * C + o] = logits[o];
  } else {
    const int cls = mlp_argmax(hbuf, p, d, lane);
    if (lane == 0) out_i[row] = cls;
  }
}

template <bool LOGITS>
cudaError_t launch(const float* x, int B, const MlpDims& d, const float* w,
                   const float* b, int* out_i, float* out_f,
                   cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  auto kernel = fused_mlp_kernel<LOGITS>;
  const size_t smem = mlp_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + RT_WARPS - 1) / RT_WARPS;
  kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(x, B, d, w, b, out_i,
                                                  out_f);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_fused_mlp_classify(const float* x, int B,
                                      const MlpDims& d, const float* w,
                                      const float* b, int* out,
                                      cudaStream_t stream) {
  return launch<false>(x, B, d, w, b, out, nullptr, stream);
}

cudaError_t launch_fused_mlp(const float* x, int B, const MlpDims& d,
                             const float* w, const float* b, float* out,
                             cudaStream_t stream) {
  return launch<true>(x, B, d, w, b, nullptr, out, stream);
}
