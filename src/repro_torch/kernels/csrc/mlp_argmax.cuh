// mlp_argmax: the ReLU MLP (+ argmax) one warp a row, shared by K1
// (fused_flow) and by K3 and K5 (fused_mlp) and K6 (fused_dag) for models
// that fit in one chunk of mlp_tile.cuh (larger ones run the tile path).
// Replaces the matmul chains of the TPU's fused_mlp kernels
// (repro/kernels/fused_mlp/kernel.py:59 _kernel, :71 _classify_kernel,
// :158 _dag_kernel) and of the "mlp" branch of suffix_verdicts
// (fused_flow/kernel.py:199).
//
// Weights: a block stages a model's weights and biases in shared memory
// once when they fit beside the warps' activation rows (mlp_stage);
// larger models (the design space's deepest, [30, 128 x 10, 2], is 611 KB)
// are read from device memory, where the card's 50 MB L2 keeps them after
// the first rows.  Either way the arithmetic is the same.
//
// A warp classifies one input row at a time: lane o computes outputs o,
// o+32, ... of a layer, accumulating in f32 in ascending input index (no
// cuBLAS, no tensor cores, no lane padding), adds the bias, applies ReLU
// on all but the last layer.  mlp_argmax then takes the argmax over the
// last layer's outputs with ties to the lowest index.  The activations
// ping-pong between two rows of the warp's shared buffer.
#pragma once

#include <math.h>

#include "rt_types.h"

// Shared memory a block can use on the H100 (227 KB).
#define RT_SMEM_MAX (227 * 1024)

// Where a model's weights and biases are read from.
struct MlpParams {
  const float* w;
  const float* b;
};

// Does the model fit in shared memory beside `extra_floats` of the
// block's other buffers?
__host__ __device__ inline bool mlp_fits_smem(const MlpDims& d,
                                              size_t extra_floats) {
  return sizeof(float) * ((size_t)d.n_w + d.n_b + extra_floats) <=
         RT_SMEM_MAX;
}

// Floats of the activation rows of a block's warps.
#define RT_MLP_HBUF_FLOATS ((size_t)RT_WARPS * 2 * RT_MAX_MLP_WIDTH)

// Stage weights then biases at `smem` when `staged` (whole block; the
// caller synchronises the block afterwards) -> where to read them.
__device__ __forceinline__ MlpParams mlp_stage(float* smem, const float* w,
                                               const float* b,
                                               const MlpDims& d,
                                               bool staged) {
  if (!staged) return MlpParams{w, b};
  for (int i = threadIdx.x; i < d.n_w; i += blockDim.x) smem[i] = w[i];
  for (int i = threadIdx.x; i < d.n_b; i += blockDim.x) smem[d.n_w + i] = b[i];
  return MlpParams{smem, smem + d.n_w};
}

// hbuf: this warp's 2 * RT_MAX_MLP_WIDTH floats, input row in
// hbuf[0, widths[0]).  Returns the row of last-layer outputs (inside
// hbuf), written by the whole warp.
__device__ __forceinline__ const float* mlp_forward(float* hbuf,
                                                    MlpParams p,
                                                    const MlpDims& d,
                                                    int lane) {
  __syncwarp();                              // the input row is written
  const float* wl = p.w;
  const float* bl = p.b;
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
  return src;
}

// The class id (argmax of the logits, ties to the lowest index), on every
// lane.  hbuf is free for the next row afterwards.
__device__ __forceinline__ int mlp_argmax(float* hbuf, MlpParams p,
                                          const MlpDims& d, int lane) {
  const float* logits = mlp_forward(hbuf, p, d, lane);
  const int n_cls = d.widths[d.n_layers];
  float best = -INFINITY;
  int idx = 0x7fffffff;
  if (lane < n_cls) {
    best = logits[lane];
    idx = lane;
  }
  for (int o = lane + 32; o < n_cls; o += 32) {
    const float v = logits[o];
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

// Dynamic shared memory of a kernel that runs one model and gives each
// warp its activation rows: the model too when it fits.
static inline size_t mlp_smem_bytes(const MlpDims& d) {
  const bool staged = mlp_fits_smem(d, RT_MLP_HBUF_FLOATS);
  return sizeof(float) *
         ((staged ? (size_t)d.n_w + d.n_b : 0) + RT_MLP_HBUF_FLOATS);
}
