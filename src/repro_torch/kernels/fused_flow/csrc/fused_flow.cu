// K1 fused_flow_serve: the whole stateful pipeline in one launch —
// register update, WindowStats readout, classifier (MLP, MAT or
// centroid) and, optionally, the mitigation action table.
//
// Replaces the TPU kernel repro/kernels/fused_flow/kernel.py:338
// (_serve_kernel, launched by fused_flow_serve_padded :442) for a Plan
// with one table: the "mlp", "mat" and "centroid" suffixes
// (suffix_verdicts :178-244) and the folded mitigation phase
// (_mitigation_phase :250-332).
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
    const float count = __shfl_sync(0xffffffffu, row[0], 0);
    const float denom = fmaxf(count, 1.f);
#pragma unroll
    for (int j = 0; j < RT_COLS; ++j) {
      const int c = lane + 32 * j;
      if (c < W) {
        const float v = row[j];
        if (mode == 2) {
          hbuf[c] = v;
        } else if (c >= head) {
          hbuf[mode == 1 ? c - head : c] = v / denom;
        } else if (mode == 0) {
          hbuf[c] = v;
        }
      }
    }
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
