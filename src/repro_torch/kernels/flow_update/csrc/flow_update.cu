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
// and, in flow_chain.cuh, takes everything but the recurrence off the
// chain: the operands are staged 32 steps at a time into a per-warp ring
// in shared memory (cp.async), eviction flags come from adjacent keys,
// each step's terms are formed where the chain does not wait for them,
// and a chunk's feature rows are stored after its walk.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps; warp k owns segment
// k (idle when seg_len[k] == 0) and also zeroes feature row k when
// arrival row k is padding (valid == 0).  Dynamic shared memory: one
// buffer per warp (fc_warp_floats).

#include "flow_chain.cuh"

namespace {

__global__ void __launch_bounds__(RT_WARPS * 32)
    flow_update_kernel(FlowArgs a, float* feats, int floats) {
  extern __shared__ __align__(16) float fu_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * RT_WARPS + warp;
  if (k >= a.B) return;
  if (a.valid[k] == 0) {                     // padding emits a zero row
    for (int c = lane; c < a.W; c += 32) feats[(size_t)k * a.W + c] = 0.f;
  }
  flow_chain(a, k, lane, fu_smem + warp * floats, floats, feats, a.W);
}

}  // namespace

cudaError_t launch_flow_update(const FlowArgs& a, float* feats,
                               cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  const int blocks = (a.B + RT_WARPS - 1) / RT_WARPS;
  const int floats = fc_warp_floats(a.U, a.H);
  const size_t smem = sizeof(float) * RT_WARPS * (size_t)floats;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flow_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  flow_update_kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(a, feats,
                                                             floats);
  return cudaGetLastError();
}
