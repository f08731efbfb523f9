// K6 fused_dag: a whole Seq/Par DAG of MLP classifiers in one launch ->
// int32 verdicts.
//
// Replaces the TPU kernel repro/kernels/fused_mlp/kernel.py:158
// (_dag_kernel, launched by fused_dag_padded :188), which
// chaining.compile_dag serves a kernel-eligible DAG with
// (repro/core/pallas_backend.py:371 lower_dag_pallas).
//
// Bound: bytes at the serving shapes, as K3: each input row is read once
// and one int32 verdict written, the weights of every distinct model once.
// A chained pipeline thus pays one round trip to device memory instead of
// one per model plus the verdict merges between them.
//
// The plan: the Pallas kernel traces the DAG's nested plan statically
// (kernel.py:124-156); here it is a postfix program passed by value in
// the argument struct (rt_types.h DagArgs), at most RT_DAG_MAX_OPS
// instructions over at most RT_DAG_MAX_MODELS deduplicated models.  The
// fold is on int32 verdicts: SEQ n keeps out > 0 ? out : next from left
// to right (the reference's where-gate), OR n is the max, AND n the min.
//
// Models: each runs at its true widths (no 128-lane padding); a folded
// FeatureSelect is zero rows in its first layer (the JAX package's rule),
// so every model reads the same input row.  The launcher stages each
// model's weights in shared memory while they fit beside the warps'
// activation rows, in model order; the rest are read from device memory
// (mlp_argmax.cuh).  A warp takes one row through every model, then
// folds the verdicts; every model runs on every row.
//
// Grid: ceil(B / RT_WARPS) blocks of RT_WARPS warps, one row per warp.

#include "mlp_argmax.cuh"

namespace {

__global__ void fused_dag_kernel(const float* x, int B, DagArgs g,
                                 const float* w, const float* b, int* out) {
  extern __shared__ float smem[];
  for (int i = 0; i < g.n_models; ++i)
    if (g.smem_off[i] >= 0)
      mlp_stage(smem + g.smem_off[i], w + g.w_off[i], b + g.b_off[i],
                g.m[i], true);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * RT_WARPS + warp;
  if (row >= B) return;
  float* hbuf = smem + g.smem_floats + warp * 2 * RT_MAX_MLP_WIDTH;
  int v[RT_DAG_MAX_MODELS];
  for (int i = 0; i < g.n_models; ++i) {
    for (int f = lane; f < g.n_feat; f += 32)
      hbuf[f] = x[(size_t)row * g.n_feat + f];
    const MlpDims& d = g.m[i];
    const MlpParams p =
        g.smem_off[i] >= 0
            ? MlpParams{smem + g.smem_off[i], smem + g.smem_off[i] + d.n_w}
            : MlpParams{w + g.w_off[i], b + g.b_off[i]};
    v[i] = mlp_argmax(hbuf, p, d, lane);
  }
  int stack[RT_DAG_MAX_OPS];
  int top = 0;
  for (int k = 0; k < g.n_ops; ++k) {
    const int op = g.op[k];
    const int n = g.arg[k];
    if (op == DAG_MODEL) {
      stack[top++] = v[n];
      continue;
    }
    const int base = top - n;
    int acc = stack[base];
    for (int j = 1; j < n; ++j) {
      const int nxt = stack[base + j];
      if (op == DAG_SEQ) acc = acc > 0 ? acc : nxt;
      else if (op == DAG_OR) acc = max(acc, nxt);
      else acc = min(acc, nxt);
    }
    top = base;
    stack[top++] = acc;
  }
  if (lane == 0) out[row] = stack[0];
}

}  // namespace

cudaError_t launch_fused_dag(const float* x, int B, const DagArgs& g_in,
                             const float* w, const float* b, int* out,
                             cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  DagArgs g = g_in;
  size_t staged = 0;
  for (int i = 0; i < g.n_models; ++i) {
    const size_t floats = (size_t)g.m[i].n_w + g.m[i].n_b;
    if (sizeof(float) * (staged + floats + RT_MLP_HBUF_FLOATS) <=
        RT_SMEM_MAX) {
      g.smem_off[i] = (int)staged;
      staged += floats;
    } else {
      g.smem_off[i] = -1;
    }
  }
  g.smem_floats = (int)staged;
  const size_t smem = sizeof(float) * (staged + RT_MLP_HBUF_FLOATS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_dag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + RT_WARPS - 1) / RT_WARPS;
  fused_dag_kernel<<<blocks, RT_WARPS * 32, smem, stream>>>(x, B, g, w, b,
                                                            out);
  return cudaGetLastError();
}
