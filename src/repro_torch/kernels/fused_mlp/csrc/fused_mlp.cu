// K3 fused_mlp_classify: ReLU MLP + argmax -> int32 class ids, and
// K5 fused_mlp: ReLU MLP -> f32 logits.
//
// Replace the TPU kernels repro/kernels/fused_mlp/kernel.py:71
// (_classify_kernel, launched by fused_mlp_classify_padded :93) and :59
// (_kernel, launched by fused_mlp_padded :267).
//
// Bound: operations at full width ([7, 128 x 10, 2]: 0.0045 ms per
// 1,024 rows at 67 TFLOP/s against 0.0009 ms for the bytes); bytes for
// the per-packet models of a few hundred weights, where the launch itself
// is the floor.  Two kernels, one launch per call:
// - fused_mlp_tile_kernel, for a model past one chunk (RT_MLP_CHUNK floats):
//   a block takes a tile of R rows through the model one layer at a
//   time, each layer's weights streamed once per tile through shared
//   memory, every warp on a register tile of rows x outputs
//   (mlp_tile.cuh).
// - fused_mlp_kernel, for a model that fits in one chunk: the block
//   stages it whole and each warp takes one row through every layer
//   (mlp_argmax.cuh), with no block-wide barrier between layers; on
//   the per-packet models it is faster than the tile path, whose layer
//   barriers cost more than their products.
// Both give the same bits: each output is one FMA chain over ascending
// input index.  K3's logits never leave the block.
//
// Grid: ceil(B / R) blocks of MT_WARPS warps, or ceil(B / RT_WARPS)
// blocks of RT_WARPS warps for the per-warp kernel.

#include "mlp_argmax.cuh"
#include "mlp_tile.cuh"

namespace {

// LOGITS: write the last layer [B, C] to out_f; else the class id to out_i.
template <bool LOGITS>
__global__ void __launch_bounds__(MT_THREADS)
    fused_mlp_tile_kernel(const float* x, int B,
                          const __grid_constant__ MtModels s, MtCfg c,
                          const float* w, const float* b, int* out_i,
                          float* out_f) {
  extern __shared__ float4 smem4[];
  const int row0 = blockIdx.x * c.R;
  const int nr = min(c.R, B - row0);
  const int C = s.w[0][s.nl[0]];
  mt_tile(s, c, x, row0, nr, w, b, reinterpret_cast<float*>(smem4),
          [&](int, const float* logits, int P) {
            if constexpr (LOGITS) {
              for (int e = threadIdx.x; e < nr * C; e += MT_THREADS) {
                const int r = e / C;
                out_f[(size_t)row0 * C + e] = logits[r * P + e - r * C];
              }
            } else {
              const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
              for (int r = warp; r < nr; r += MT_WARPS) {
                const int cls = mt_argmax(logits + r * P, C, lane);
                if (lane == 0) out_i[row0 + r] = cls;
              }
            }
          });
}

// One warp a row; the model is staged whole.
template <bool LOGITS>
__global__ void fused_mlp_kernel(const float* x, int B, MlpDims d,
                                 const float* w, const float* b,
                                 int* out_i, float* out_f) {
  extern __shared__ float smem[];
  const MlpParams p = mlp_stage(smem, w, b, d, true);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * RT_WARPS + warp;
  if (row >= B) return;
  float* hbuf = smem + d.n_w + d.n_b + warp * 2 * RT_MAX_MLP_WIDTH;
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
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) & 15)
    return cudaErrorMisalignedAddress;
  cudaError_t e;
  if (d.n_w <= RT_MLP_CHUNK) {           // one chunk: staged whole
    const size_t smem =
        sizeof(float) * ((size_t)d.n_w + d.n_b + RT_MLP_HBUF_FLOATS);
    auto kernel = fused_mlp_kernel<LOGITS>;
    if ((e = mt_opt_in(kernel, smem)) != cudaSuccess) return e;
    kernel<<<(B + RT_WARPS - 1) / RT_WARPS, RT_WARPS * 32, smem, stream>>>(
        x, B, d, w, b, out_i, out_f);
    return cudaGetLastError();
  }
  MtModels s{};
  s.n = 1;
  s.nl[0] = d.n_layers;
  for (int l = 0; l <= d.n_layers; ++l) s.w[0][l] = d.widths[l];
  MtCfg c;
  size_t smem = 0;
  if ((e = mt_config(s, B, 0, &c, &smem)) != cudaSuccess) return e;
  auto kernel = fused_mlp_tile_kernel<LOGITS>;
  if ((e = mt_opt_in(kernel, smem)) != cudaSuccess) return e;
  kernel<<<(B + c.R - 1) / c.R, MT_THREADS, smem, stream>>>(x, B, s, c, w, b,
                                                           out_i, out_f);
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
