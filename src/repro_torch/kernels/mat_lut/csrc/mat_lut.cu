// K4 mat_lut_classify: the MAT classifier — compare-count quantize,
// per-feature LUT sum, arg-reduce, LabelMap — on a batch of feature rows
// -> int32 verdicts.
//
// Replaces the TPU kernel repro/kernels/mat_lut/kernel.py:41 (_kernel,
// launched by mat_pipeline_padded :82), which the split path serves a
// MAT suffix with (repro/core/pallas_backend.py:212-225).
//
// Bound: bytes.  Per row it reads F floats and writes one int; per block
// it stages the edges and tables (F * (E + (E + 1) * C) floats, 4.4 KB at
// the mat-fused shapes) in shared memory once.  The work is F * E
// compares and F * C adds per row, far below the card's rates.  The
// one-hot matmuls of the Pallas kernel (its gather idiom on the TPU's
// matrix unit) are plain indexed loads here.
//
// Layout: one warp per row (mat_classify.cuh, shared with K1's "mat"
// suffix): each lane computes the buckets of its features, then the
// lanes split the classes' running scores, reading each feature's bucket
// by a shuffle.  Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps.

#include "mat_classify.cuh"

namespace {

__global__ void mat_lut_kernel(const float* x, int B, MatDims m,
                               const float* edges, const float* tables,
                               const int* lmap, int* out) {
  extern __shared__ float smem[];
  mat_load(smem, edges, tables, m);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * RT_WARPS + warp;
  if (p >= B) return;
  float* z = smem + mat_smem_floats(m) + warp * RT_MAT_MAX_FEATURES;
  for (int i = lane; i < m.F; i += 32) z[i] = x[(size_t)p * m.F + i];
  const int cls = mat_classify(z, smem, lmap, m, lane);
  if (lane == 0) out[p] = cls;
}

}  // namespace

cudaError_t launch_mat_lut_classify(const float* x, int B, const MatDims& m,
                                    const float* edges, const float* tables,
                                    const int* lmap, int* out,
                                    cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const size_t smem =
      sizeof(float) *
      (mat_smem_floats(m) + (size_t)RT_WARPS * RT_MAT_MAX_FEATURES);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mat_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + RT_WARPS - 1) / RT_WARPS;
  mat_lut_kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(x, B, m, edges,
                                                          tables, lmap, out);
  return cudaGetLastError();
}
