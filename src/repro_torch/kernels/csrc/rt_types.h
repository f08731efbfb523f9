// Plain C++ interface between the CUDA sources (*.cu, compiled by nvcc
// without PyTorch's headers) and the one PyTorch binding (binding.cpp).
#pragma once

#include <cuda_runtime_api.h>

#define RT_WARPS 8             // warps per block in every kernel
#define RT_COLS 8              // register columns per lane: W <= 256
#define RT_MAX_LAYERS 16       // MLP layers the kernels take
#define RT_MAX_MLP_WIDTH 256   // widest MLP layer the kernels take

// One flow table and one slot-segmented batch.  ``keys``/``regs`` are
// updated in place; only the batch's slots are read and written.
struct FlowArgs {
  int* keys;              // [S] stored keys, -1 = empty
  float* regs;            // [S, W] register rows
  const int* pkt_keys;    // [B] arrival order
  const float* upd;       // [B, U] counter increments ++ EWMA values
  const int* bins;        // [B, H] absolute hist columns, -1 = none
  const int* valid;       // [B] 0 = padding row
  const int* order;       // [B] arrival index of sorted position
  const int* seg_first;   // [B] per segment: first sorted position
  const int* seg_len;     // [B] per segment: packets (0 = no segment)
  const int* seg_slot;    // [B] per segment: table slot
  int B, W, U, H, C, E;
  float alpha;
};

// An MLP packed back to back: weights row-major [d_in, d_out] per layer,
// then (separately) the biases of every layer.
struct MlpDims {
  int n_layers;
  int widths[RT_MAX_LAYERS + 1];
  int n_w;                // weight floats
  int n_b;                // bias floats
};

cudaError_t launch_flow_update(const FlowArgs& a, float* feats,
                               cudaStream_t stream);
cudaError_t launch_fused_mlp_classify(const float* x, int B,
                                      const MlpDims& d, const float* w,
                                      const float* b, int* out,
                                      cudaStream_t stream);
cudaError_t launch_fused_flow_serve(const FlowArgs& a, const MlpDims& d,
                                    const float* w, const float* b,
                                    int* verdicts, int mode,
                                    cudaStream_t stream);
