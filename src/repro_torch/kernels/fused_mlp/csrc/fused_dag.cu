// K6 fused_dag: a whole Seq/Par DAG of MLP classifiers in one launch ->
// int32 verdicts.
//
// Replaces the TPU kernel repro/kernels/fused_mlp/kernel.py:158
// (_dag_kernel, launched by fused_dag_padded :188), which
// chaining.compile_dag serves a kernel-eligible DAG with
// (repro/core/pallas_backend.py:371 lower_dag_pallas).
//
// Bound: operations when a model is at full width (`ad_full > tc`: 0.0045
// ms per 1,024 rows at 67 TFLOP/s, 0.0009 ms for the bytes); bytes for
// DAGs of per-packet models, where each input row is read once and one
// int32 verdict written.  A chained pipeline thus pays one round trip to
// device memory instead of one per model plus the verdict merges between
// them.
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
// so every model reads the same input row.  Every model runs on every
// row.  Two kernels, one launch per call:
// - fused_dag_tile_kernel, when the models' weights pass one chunk
//   (mlp_tile.cuh): a block takes a tile of R rows through every model in
//   turn, the weights one stream through shared memory in packing order
//   (a model that fits in a chunk is staged whole, a large one streamed a
//   chunk at a time); each model's verdicts for the tile stay in shared
//   memory, and one thread a row folds them.
// - fused_dag_kernel, when they fit in one chunk: the block stages every
//   model, a warp takes one row through each (mlp_argmax.cuh) and folds.
//
// Grid: ceil(B / R) blocks of MT_WARPS warps, or ceil(B / RT_WARPS)
// blocks of RT_WARPS warps for the per-warp kernel.

#include "mlp_argmax.cuh"
#include "mlp_tile.cuh"

namespace {

// The plan folded over one row's verdicts (verdict(i): model i's).
template <class V>
__device__ __forceinline__ int dag_fold(const DagArgs& g, V verdict) {
  int stack[RT_DAG_MAX_OPS];
  int top = 0;
  for (int k = 0; k < g.n_ops; ++k) {
    const int op = g.op[k];
    const int n = g.arg[k];
    if (op == DAG_MODEL) {
      stack[top++] = verdict(n);
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
  return stack[0];
}

__global__ void __launch_bounds__(MT_THREADS)
    fused_dag_tile_kernel(const float* x, int B,
                          const __grid_constant__ DagArgs g,
                          const __grid_constant__ MtModels s, MtCfg c,
                          const float* w, const float* b, int* out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* verd = reinterpret_cast<int*>(
      smem + c.n_stg * c.stg + c.R * (c.p_in + 2 * c.p_h));
  const int row0 = blockIdx.x * c.R;
  const int nr = min(c.R, B - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  mt_tile(s, c, x, row0, nr, w, b, smem,
          [&](int m, const float* logits, int P) {
            const int C = s.w[m][s.nl[m]];
            for (int r = warp; r < nr; r += MT_WARPS) {
              const int cls = mt_argmax(logits + r * P, C, lane);
              if (lane == 0) verd[m * c.R + r] = cls;
            }
          });
  const int r = threadIdx.x;
  if (r < nr)
    out[row0 + r] = dag_fold(g, [&](int m) { return verd[m * c.R + r]; });
}

// One warp a row; every model staged whole (n_w weights, then n_b
// biases, each in model order).
__global__ void fused_dag_kernel(const float* x, int B,
                                 const __grid_constant__ DagArgs g, int n_w,
                                 int n_b, const float* w, const float* b,
                                 int* out) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) smem[i] = w[i];
  for (int i = threadIdx.x; i < n_b; i += blockDim.x) smem[n_w + i] = b[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * RT_WARPS + warp;
  if (row >= B) return;
  float* hbuf = smem + n_w + n_b + warp * 2 * RT_MAX_MLP_WIDTH;
  int v[RT_DAG_MAX_MODELS];
  int wo = 0, bo = 0;
  for (int i = 0; i < g.n_models; ++i) {
    for (int f = lane; f < g.n_feat; f += 32)
      hbuf[f] = x[(size_t)row * g.n_feat + f];
    v[i] = mlp_argmax(hbuf, MlpParams{smem + wo, smem + n_w + bo}, g.m[i],
                      lane);
    wo += g.m[i].n_w;
    bo += g.m[i].n_b;
  }
  const int verdict = dag_fold(g, [&](int m) { return v[m]; });
  if (lane == 0) out[row] = verdict;
}

}  // namespace

cudaError_t launch_fused_dag(const float* x, int B, const DagArgs& g,
                             const float* w, const float* b, int* out,
                             cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) & 15)
    return cudaErrorMisalignedAddress;
  int n_w = 0, n_b = 0;
  for (int i = 0; i < g.n_models; ++i) {
    n_w += g.m[i].n_w;
    n_b += g.m[i].n_b;
  }
  cudaError_t e;
  if (n_w <= RT_MLP_CHUNK) {             // one chunk: staged whole
    const size_t smem =
        sizeof(float) * ((size_t)n_w + n_b + RT_MLP_HBUF_FLOATS);
    if ((e = mt_opt_in(fused_dag_kernel, smem)) != cudaSuccess) return e;
    fused_dag_kernel<<<(B + RT_WARPS - 1) / RT_WARPS, RT_WARPS * 32, smem,
                       stream>>>(x, B, g, n_w, n_b, w, b, out);
    return cudaGetLastError();
  }
  MtModels s{};
  s.n = g.n_models;
  for (int i = 0; i < g.n_models; ++i) {
    s.nl[i] = g.m[i].n_layers;
    for (int l = 0; l <= g.m[i].n_layers; ++l) s.w[i][l] = g.m[i].widths[l];
  }
  MtCfg c;
  size_t smem = 0;
  e = mt_config(s, B, sizeof(int) * RT_DAG_MAX_MODELS, &c, &smem);
  if (e != cudaSuccess) return e;
  if ((e = mt_opt_in(fused_dag_tile_kernel, smem)) != cudaSuccess) return e;
  fused_dag_tile_kernel<<<(B + c.R - 1) / c.R, MT_THREADS, smem, stream>>>(
      x, B, g, s, c, w, b, out);
  return cudaGetLastError();
}
