// mlp_argmax: the ReLU MLP + argmax shared by K1 (fused_flow) and K3
// (fused_mlp).  Replaces the matmul chain and masked argmax of the TPU's
// _classify_kernel (repro/kernels/fused_mlp/kernel.py:71) and of the
// "mlp" branch of suffix_verdicts (fused_flow/kernel.py:199).
//
// The block stages every layer's weights and biases in shared memory
// once.  A warp then classifies one input row at a time: lane o computes
// outputs o, o+32, ... of a layer, accumulating in f32 in ascending input
// index (no cuBLAS, no tensor cores, no lane padding), adds the bias,
// applies ReLU on all but the last layer, and the warp takes the argmax
// over the last layer's outputs with ties to the lowest index.  The
// activations ping-pong between two rows of the warp's shared buffer.
#pragma once

#include <math.h>

#include "rt_types.h"

// Stage weights then biases into shared memory (whole block; the caller
// synchronises the block afterwards).
__device__ __forceinline__ void mlp_load(float* smem_w, const float* w,
                                         const float* b, const MlpDims& d) {
  for (int i = threadIdx.x; i < d.n_w; i += blockDim.x) smem_w[i] = w[i];
  for (int i = threadIdx.x; i < d.n_b; i += blockDim.x)
    smem_w[d.n_w + i] = b[i];
}

// hbuf: this warp's 2 * RT_MAX_MLP_WIDTH floats, input row in
// hbuf[0, widths[0]).  Returns the class id on every lane.
__device__ __forceinline__ int mlp_argmax(float* hbuf, const float* smem_w,
                                          const MlpDims& d, int lane) {
  __syncwarp();                              // the input row is written
  const float* wl = smem_w;
  const float* bl = smem_w + d.n_w;
  float* src = hbuf;
  float* dst = hbuf + RT_MAX_MLP_WIDTH;
  for (int l = 0; l < d.n_layers; ++l) {
    const int din = d.widths[l];
    const int dout = d.widths[l + 1];
    for (int o = lane; o < dout; o += 32) {
      float acc = 0.f;
      for (int i = 0; i < din; ++i) acc += src[i] * wl[i * dout + o];
      acc = acc + bl[o];
      if (l < d.n_layers - 1) acc = fmaxf(acc, 0.f);
      dst[o] = acc;
    }
    __syncwarp();
    wl += din * dout;
    bl += dout;
    float* t = src;
    src = dst;
    dst = t;
  }
  const int n_cls = d.widths[d.n_layers];
  float best = -INFINITY;
  int idx = 0x7fffffff;
  if (lane < n_cls) {
    best = src[lane];
    idx = lane;
  }
  for (int o = lane + 32; o < n_cls; o += 32) {
    const float v = src[o];
    if (v > best) {                          // strict: keep the lowest
      best = v;
      idx = o;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  __syncwarp();                              // hbuf free for the next row
  return idx;
}

// Dynamic shared memory of a kernel that stages the MLP and gives each
// warp its activation buffer.
static inline size_t mlp_smem_bytes(const MlpDims& d) {
  return sizeof(float) *
         ((size_t)d.n_w + d.n_b + (size_t)RT_WARPS * 2 * RT_MAX_MLP_WIDTH);
}
