// K2 flow_update: the register update alone -> (keys', regs', feats).
//
// Replaces the TPU kernel repro/kernels/flow_update/kernel.py:235
// (_kernel, launched by flow_update_padded :269) on the split path.
//
// Bound: bytes.  Per batch it moves the touched table rows, the packet
// operands and the [B, W] feature rows — a few hundred KB at the serving
// shapes — and does a handful of f32 operations per register word, far
// below the card's rates.  What limits it in practice is latency: one
// warp per slot segment walks its chain serially, so a batch takes as
// long as its deepest chain (a single hot flow serialises the batch on
// one warp).  The design keeps each row in registers for the whole chain
// and touches global memory once per row and once per feature word.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps; warp k owns segment
// k (idle when seg_len[k] == 0) and also zeroes feature row k when
// arrival row k is padding (valid == 0).

#include "flow_chain.cuh"

namespace {

struct EmitFeats {
  float* feats;
  int W;
  __device__ __forceinline__ void operator()(int p, const float (&row)[RT_COLS],
                                             int lane) {
    float* out = feats + (size_t)p * W;
#pragma unroll
    for (int j = 0; j < RT_COLS; ++j) {
      const int c = lane + 32 * j;
      if (c < W) out[c] = row[j];
    }
  }
};

__global__ void flow_update_kernel(FlowArgs a, float* feats) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * RT_WARPS + warp;
  if (k >= a.B) return;
  if (a.valid[k] == 0) {                     // padding emits a zero row
    for (int c = lane; c < a.W; c += 32) feats[(size_t)k * a.W + c] = 0.f;
  }
  EmitFeats emit{feats, a.W};
  flow_chain(a, k, lane, emit);
}

}  // namespace

cudaError_t launch_flow_update(const FlowArgs& a, float* feats,
                               cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  const int blocks = (a.B + RT_WARPS - 1) / RT_WARPS;
  flow_update_kernel<<<blocks, RT_WARPS * 32, 0, stream>>>(a, feats);
  return cudaGetLastError();
}
