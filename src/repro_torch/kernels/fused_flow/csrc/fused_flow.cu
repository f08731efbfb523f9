// K1 fused_flow_serve: the whole stateful pipeline in one launch —
// register update, WindowStats readout, classifier (MLP, MAT or
// centroid) and, optionally, the mitigation action table.
//
// Replaces the TPU kernel repro/kernels/fused_flow/kernel.py:338
// (_serve_kernel, launched by fused_flow_serve_padded :442) for every
// Plan: one table or several (the multi-table mode, below), the "mlp",
// "mat" and "centroid" suffixes (suffix_verdicts :178-244) and the folded
// mitigation phase (_mitigation_phase :250-332).
//
// Bound: bytes, as K2 plus the classifier parameters (staged once per
// block into shared memory; an MLP too large for it is read from device
// memory through L2, mlp_argmax.cuh) and the touched action rows, minus the [B, W]
// feature rows, which never leave the warp: each packet's post-update row
// is read out, classified and reduced to an int32 verdict written
// straight to the packet's arrival index (no inverse-permutation
// gather).  Like K2 it is latency bound by the deepest slot chain, which
// one warp walks serially; here each step of the chain also classifies.
//
// Readout (suffix_readout, fused_flow/kernel.py:137): mode 0 "all" =
// counters ++ EWMAs raw ++ histograms / max(count, 1); 1 "hist" = the
// normalised histograms only; 2 "raw" = the row as is.  The divide is
// the IEEE divide (no fast math), so readout rows match bit for bit.
//
// Grid: warp k of the grid owns slot segment k, striding by the grid's
// warp count; when arrival row k is padding it also writes that row's
// verdict (the classifier on an all-zero readout row, as the reference
// does).  Without mitigation the grid is ceil(B / RT_WARPS) blocks.
//
// Mitigation: the action table is keyed by hash_slot(key, Sm) with its
// own slot count, so its chains cut across the detection segments and a
// packet's action needs verdicts that other warps write.  The launch is
// then cooperative (cudaLaunchCooperativeKernel, a grid no larger than
// the blocks the card can keep resident): after every verdict is written
// a grid-wide barrier (cooperative_groups this_grid().sync()) orders them
// before the mitigation phase, in which thread t of the grid walks action
// segment t (mitigate_chain.cuh) in arrival order.  One launch either way.
//
// Multi-table mode (kernel.py:356-392: one _flow_phase per table, each
// table's readout rows gathered to arrival order through `inv` and
// concatenated): a packet's classifier row is made of readouts that
// different warps produce, one per table's chain, so classification
// cannot ride on the chain walk.  One cooperative launch in three phases:
//   A. warp k walks slot segment k of each table in turn (the grid's
//      warps stride over nt x B segments) and writes each packet's
//      readout into the scratch row z[p] at the table's column offset: a
//      scatter to arrival order in place of the TPU's gather (EmitVerdict's
//      write_readout, IEEE divide, so z matches the plain version bit for
//      bit); padding rows get zeros;
//   B. after a grid-wide barrier warp k classifies row z[k] (a folded
//      FeatureSelect gathers its features first, so any row width works);
//   C. when mitigated, after a second barrier, thread k walks action
//      segment k, the action table keyed by table 0's keys.
// The table descriptors ride by value in the parameter space
// (__grid_constant__, read in place), RT_MAX_TABLES of them.  The bound
// does not count z: the function needs no readout rows in device memory
// (the TPU kernel keeps its gather in VMEM); z written once and read once
// (B x n_in floats) is this design's own extra traffic.
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "centroid_classify.cuh"
#include "flow_chain.cuh"
#include "mat_classify.cuh"
#include "mitigate_chain.cuh"
#include "mlp_argmax.cuh"

namespace cg = cooperative_groups;

namespace {

enum { KIND_MLP = 0, KIND_MAT = 1, KIND_CENTROID = 2 };

// Is the MLP staged in shared memory (it fits beside the warps' rows)?
__host__ __device__ inline bool mlp_staged(const SuffixArgs& s) {
  return mlp_fits_smem(s.mlp, RT_MLP_HBUF_FLOATS);
}

// Shared-memory floats of the staged classifier parameters: none for an
// MLP too large to stage, which is read from device memory instead.
__host__ __device__ inline size_t suffix_floats(const SuffixArgs& s) {
  if (s.kind == KIND_MLP)
    return mlp_staged(s) ? (size_t)s.mlp.n_w + s.mlp.n_b : 0;
  if (s.kind == KIND_MAT) return mat_smem_floats(s.mat);
  return cent_smem_floats(s.cent);
}

// Stage the classifier -> where the MLP's weights are read from.
template <int KIND>
__device__ __forceinline__ MlpParams suffix_load(float* smem,
                                                 const SuffixArgs& s) {
  if constexpr (KIND == KIND_MLP)
    return mlp_stage(smem, s.p0, s.p1, s.mlp, mlp_staged(s));
  if constexpr (KIND == KIND_MAT) mat_load(smem, s.p0, s.p1, s.mat);
  if constexpr (KIND == KIND_CENTROID) cent_load(smem, s.p0, s.cent);
  return MlpParams{nullptr, nullptr};
}

// hbuf: this warp's 2 * RT_MAX_MLP_WIDTH floats, readout row first.
template <int KIND>
__device__ __forceinline__ int classify(float* hbuf, const float* smem,
                                        MlpParams mp, const SuffixArgs& s,
                                        int lane) {
  if constexpr (KIND == KIND_MLP) {
    return mlp_argmax(hbuf, mp, s.mlp, lane);
  } else if constexpr (KIND == KIND_MAT) {
    return mat_classify(hbuf, smem, s.lmap, s.mat, lane);
  } else {
    return centroid_classify(hbuf, smem, s.fidx, s.lmap, s.cent, lane);
  }
}

// The readout of one post-update row (lane holds columns lane + 32 j),
// written to out[0..n_out): every lane of the warp calls it.
__device__ __forceinline__ void write_readout(float* out,
                                              const float (&row)[RT_COLS],
                                              int lane, int W, int head,
                                              int mode) {
  const float count = __shfl_sync(0xffffffffu, row[0], 0);
  const float denom = fmaxf(count, 1.f);
#pragma unroll
  for (int j = 0; j < RT_COLS; ++j) {
    const int c = lane + 32 * j;
    if (c < W) {
      const float v = row[j];
      if (mode == 2) {
        out[c] = v;
      } else if (c >= head) {
        out[mode == 1 ? c - head : c] = v / denom;
      } else if (mode == 0) {
        out[c] = v;
      }
    }
  }
}

template <int KIND>
struct EmitVerdict {
  float* hbuf;
  const float* smem;
  MlpParams mp;
  const SuffixArgs* s;
  int* verdicts;
  int W, head, mode;

  __device__ __forceinline__ void operator()(int p,
                                             const float (&row)[RT_COLS],
                                             int lane) {
    write_readout(hbuf, row, lane, W, head, mode);
    const int cls = classify<KIND>(hbuf, smem, mp, *s, lane);
    if (lane == 0) verdicts[p] = cls;
  }
};

template <int KIND, bool MIT>
__global__ void fused_flow_kernel(FlowArgs a, SuffixArgs s, int* verdicts,
                                  int mode, MitArgs m) {
  extern __shared__ float smem[];
  const MlpParams mp = suffix_load<KIND>(smem, s);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* hbuf = smem + suffix_floats(s) + warp * 2 * RT_MAX_MLP_WIDTH;
  EmitVerdict<KIND> emit{hbuf, smem, mp, &s, verdicts, a.W, a.C + a.E,
                         mode};
  for (int k = blockIdx.x * RT_WARPS + warp; k < a.B;
       k += gridDim.x * RT_WARPS) {
    if (a.valid[k] == 0) {                   // padding: zero readout row
      for (int i = lane; i < a.W; i += 32) hbuf[i] = 0.f;
      const int cls = classify<KIND>(hbuf, smem, mp, s, lane);
      if (lane == 0) verdicts[k] = cls;
    }
    flow_chain(a, k, lane, emit);
  }
  if constexpr (MIT) {
    cg::this_grid().sync();                  // every verdict is written
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < a.B;
         k += gridDim.x * blockDim.x)
      mitigate_chain(m, a.pkt_keys, verdicts, k);
  }
}

// Blocks the card keeps resident for `kernel` at `smem` bytes of dynamic
// shared memory: the largest cooperative grid.  Queried once per (device,
// kernel, smem) and cached, so a launch makes no occupancy query.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  *blocks = cache[key] = per_sm * sms;
  return cudaSuccess;
}

// ---------------------------------------------------- multi-table mode

struct MultiArgs {
  float* z;                    // [B, n_in] readout rows, arrival order
  int nt, B, n_in;
  TableArgs t[RT_MAX_TABLES];
};

// Kernel parameters end at 32,764 bytes on Hopper (CUDA 12.1 and later).
static_assert(sizeof(MultiArgs) + sizeof(SuffixArgs) + sizeof(int*) +
                      sizeof(MitArgs) <=
                  32764,
              "RT_MAX_TABLES table descriptors exceed the parameter space");

// One table's readout of a post-update row, written to the packet's row
// of z (zt: the table's first column of row 0).
struct WriteReadout {
  float* zt;
  int n_in, W, head, mode;

  __device__ __forceinline__ void operator()(int p,
                                             const float (&row)[RT_COLS],
                                             int lane) {
    write_readout(zt + (size_t)p * n_in, row, lane, W, head, mode);
  }
};

template <int KIND>
__global__ void fused_flow_multi_kernel(const __grid_constant__ MultiArgs g,
                                        SuffixArgs s, int* verdicts,
                                        MitArgs m) {
  extern __shared__ float smem[];
  const MlpParams mp = suffix_load<KIND>(smem, s);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * RT_WARPS + warp;
  const int nw = gridDim.x * RT_WARPS;
  // A: every table's chains, readouts scattered to arrival order
  const int items = g.nt * g.B;
  for (int i = gw; i < items; i += nw) {
    const int t = i / g.B;
    const int k = i - t * g.B;
    const TableArgs& ta = g.t[t];
    const int head = ta.a.C + ta.a.E;
    float* zt = g.z + ta.col;
    if (ta.a.valid[k] == 0) {                // padding: a zero readout
      const int n = ta.mode == 1 ? ta.a.W - head : ta.a.W;
      for (int c = lane; c < n; c += 32) zt[(size_t)k * g.n_in + c] = 0.f;
    }
    WriteReadout emit{zt, g.n_in, ta.a.W, head, ta.mode};
    flow_chain(ta.a, k, lane, emit);
  }
  cg::this_grid().sync();                    // every row of z is written
  // B: classify in arrival order
  float* hbuf = smem + suffix_floats(s) + warp * 2 * RT_MAX_MLP_WIDTH;
  for (int k = gw; k < g.B; k += nw) {
    const float* zr = g.z + (size_t)k * g.n_in;
    int cls;
    if constexpr (KIND == KIND_CENTROID) {
      // gather the folded FeatureSelect's columns: the row may be wider
      // than the warp's buffer
      for (int i = lane; i < s.cent.D; i += 32)
        hbuf[i] = zr[s.cent.n_sel ? s.fidx[i] : i];
      CentDims c = s.cent;
      c.n_sel = 0;
      cls = centroid_classify(hbuf, smem, nullptr, s.lmap, c, lane);
    } else {
      for (int i = lane; i < g.n_in; i += 32) hbuf[i] = zr[i];
      cls = classify<KIND>(hbuf, smem, mp, s, lane);
    }
    if (lane == 0) verdicts[k] = cls;
  }
  // C: the action table, keyed by table 0's keys
  if (m.keys != nullptr) {
    cg::this_grid().sync();                  // every verdict is written
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < g.B;
         k += gridDim.x * blockDim.x)
      mitigate_chain(m, g.t[0].a.pkt_keys, verdicts, k);
  }
}

template <int KIND>
cudaError_t launch_multi_kind(const TableArgs* tables, int nt, float* z,
                              int n_in, const SuffixArgs& s, int* verdicts,
                              const MitArgs& m, cudaStream_t stream) {
  auto kernel = fused_flow_multi_kernel<KIND>;
  const size_t smem =
      sizeof(float) * (suffix_floats(s) + RT_MLP_HBUF_FLOATS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = RT_WARPS * 32;
  int resident = 0;
  cudaError_t e =
      resident_blocks((const void*)kernel, threads, smem, &resident);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  static thread_local MultiArgs g;           // 30 KB: off the stack
  g.z = z;
  g.nt = nt;
  g.B = tables[0].a.B;
  g.n_in = n_in;
  for (int t = 0; t < nt; ++t) g.t[t] = tables[t];
  const long long warps = (long long)nt * g.B;
  int blocks = (int)((warps + RT_WARPS - 1) / RT_WARPS);
  if (blocks > resident) blocks = resident;
  SuffixArgs s_ = s;
  MitArgs m_ = m;
  void* args[] = {&g, &s_, &verdicts, &m_};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------ one-table mode

template <int KIND, bool MIT>
cudaError_t launch_kind(const FlowArgs& a, const SuffixArgs& s,
                        int* verdicts, int mode, const MitArgs& m,
                        cudaStream_t stream) {
  auto kernel = fused_flow_kernel<KIND, MIT>;
  const size_t smem =
      sizeof(float) * (suffix_floats(s) + RT_MLP_HBUF_FLOATS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int blocks = (a.B + RT_WARPS - 1) / RT_WARPS;
  const int threads = RT_WARPS * 32;
  if constexpr (!MIT) {
    kernel<<<blocks, threads, smem, stream>>>(a, s, verdicts, mode, m);
    return cudaGetLastError();
  }
  // a cooperative grid must fit on the card at once
  int resident = 0;
  cudaError_t e =
      resident_blocks((const void*)kernel, threads, smem, &resident);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (blocks > resident) blocks = resident;
  FlowArgs a_ = a;
  SuffixArgs s_ = s;
  MitArgs m_ = m;
  void* args[] = {&a_, &s_, &verdicts, &mode, &m_};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool MIT>
cudaError_t launch_mit(const FlowArgs& a, const SuffixArgs& s,
                       int* verdicts, int mode, const MitArgs& m,
                       cudaStream_t stream) {
  if (s.kind == KIND_MLP)
    return launch_kind<KIND_MLP, MIT>(a, s, verdicts, mode, m, stream);
  if (s.kind == KIND_MAT)
    return launch_kind<KIND_MAT, MIT>(a, s, verdicts, mode, m, stream);
  return launch_kind<KIND_CENTROID, MIT>(a, s, verdicts, mode, m, stream);
}

}  // namespace

cudaError_t launch_fused_flow_serve(const FlowArgs& a, const SuffixArgs& s,
                                    int* verdicts, int mode,
                                    const MitArgs* mit,
                                    cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  if (mit == nullptr) {
    MitArgs none{};
    return launch_mit<false>(a, s, verdicts, mode, none, stream);
  }
  return launch_mit<true>(a, s, verdicts, mode, *mit, stream);
}

cudaError_t launch_fused_flow_multi(const TableArgs* tables, int nt,
                                    float* z, int n_in, const SuffixArgs& s,
                                    int* verdicts, const MitArgs* mit,
                                    cudaStream_t stream) {
  if (nt < 1 || nt > RT_MAX_TABLES) return cudaErrorInvalidValue;
  if (tables[0].a.B == 0) return cudaSuccess;
  MitArgs none{};                            // keys == nullptr: no table
  const MitArgs& m = mit == nullptr ? none : *mit;
  if (s.kind == KIND_MLP)
    return launch_multi_kind<KIND_MLP>(tables, nt, z, n_in, s, verdicts, m,
                                       stream);
  if (s.kind == KIND_MAT)
    return launch_multi_kind<KIND_MAT>(tables, nt, z, n_in, s, verdicts, m,
                                       stream);
  return launch_multi_kind<KIND_CENTROID>(tables, nt, z, n_in, s, verdicts,
                                          m, stream);
}
