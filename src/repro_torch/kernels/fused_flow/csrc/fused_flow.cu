// K1 fused_flow_serve: the whole stateful pipeline in one launch —
// register update, WindowStats readout, classifier (MLP, MAT or
// centroid) and, optionally, the mitigation action table.
//
// Replaces the TPU kernel repro/kernels/fused_flow/kernel.py:338
// (_serve_kernel, launched by fused_flow_serve_padded :442) for every
// Plan: one table or several (kernel.py:356-392: one _flow_phase per
// table, each table's readout rows gathered to arrival order and
// concatenated), the "mlp", "mat" and "centroid" suffixes
// (suffix_verdicts :178-244) and the folded mitigation phase
// (_mitigation_phase :250-332).
//
// Bound: bytes, as K2 per table plus the classifier parameters (staged
// once per block into shared memory; an MLP too large for it is read from
// device memory through L2, mlp_argmax.cuh), the touched action rows and
// the verdicts.  What limits it is latency: the deepest slot chain, which
// one warp walks serially.  So the design keeps only the recurrence on
// that chain (flow_chain.cuh: operands staged 32 steps at a time into a
// per-warp ring with cp.async, eviction flags from adjacent keys, each
// step's terms formed where the chain does not wait for them, the rows
// stored after each chunk) and moves the readout and the classifier off
// it: a batch no longer waits for one warp to classify its deepest
// chain's packets one after the other.
//
// One cooperative launch (cudaLaunchCooperativeKernel, a grid no larger
// than the blocks the card keeps resident) in three phases, for one table
// or many:
//   A. the grid's warps stride over the nt x B slot segments of the
//      tables; warp k walks segment k of a table and, after each step,
//      stores the packet's post-update row into the scratch row z[p] at
//      the table's column offset (a scatter to arrival order in place of
//      the TPU's gather), exactly as K2 stores its feature rows.  Padding
//      rows get zeros;
//   B. after a grid-wide barrier (cooperative_groups this_grid().sync())
//      the block stages the classifier, and warp k reads row k of z out
//      (suffix_readout, kernel.py:137: mode 0 "all" = counters ++ EWMAs
//      raw ++ histograms / max(count, 1); 1 "hist" = the normalised
//      histograms only; 2 "raw" = the row as is; the IEEE divide, no fast
//      math, so the readout matches the plain version bit for bit) and
//      classifies it: every row at once, each on its own warp (a padding
//      row's verdict is the classifier's on the all-zero readout, as the
//      reference gives it);
//   C. when mitigated, after a second barrier, warp k walks action
//      segment k (mitigate_chain.cuh) in arrival order, the action table
//      keyed by table 0's keys.
// Shared memory holds, per warp, the walk's buffer in phase A
// (flow_chain.cuh) and the classifier's activation rows in phase B, then
// the staged classifier after them: the two phases share it, so the walk
// takes none of the room in which an MLP is staged.  The table
// descriptors ride by value in the parameter space (__grid_constant__,
// read in place): one of them for a one-table launch, RT_MAX_TABLES for a
// multi-table one.  The bound does not count z: the function needs no
// rows in device memory (the TPU kernel keeps its gather in VMEM); z
// written once and read once (B x the tables' widths) is this design's
// own extra traffic.
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

// One launch's tables (up to MAXT) and scratch.  A table's ``col`` is
// its first column in z.
template <int MAXT>
struct FlowLaunch {
  float* z;                    // [B, zw] post-update rows, arrival order
  int nt, B, zw, n_in;
  int wbuf;                    // floats of each warp's walk buffer
  TableArgs t[MAXT];
};

// Kernel parameters end at 32,764 bytes on Hopper (CUDA 12.1 and later).
static_assert(sizeof(FlowLaunch<RT_MAX_TABLES>) + sizeof(SuffixArgs) +
                      sizeof(int*) + sizeof(MitArgs) <=
                  32764,
              "RT_MAX_TABLES table descriptors exceed the parameter space");

// Floats of each warp's activation rows in phase B.
#define FF_HBUF (2 * RT_MAX_MLP_WIDTH)

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

// Column i of a packet's classifier row (the tables' readouts side by
// side) from its post-update rows zr.
template <int MAXT>
__device__ __forceinline__ float readout_at(const FlowLaunch<MAXT>& g,
                                            const float* zr, int i) {
  int ro = 0;
  for (int t = 0; t < g.nt; ++t) {
    const TableArgs& ta = g.t[t];
    const int head = ta.a.C + ta.a.E;
    const int n = ta.mode == 1 ? ta.a.W - head : ta.a.W;
    if (i < ro + n) {
      const int c = ta.mode == 1 ? i - ro + head : i - ro;
      const float v = zr[ta.col + c];
      if (ta.mode == 2 || c < head) return v;
      return v / fmaxf(zr[ta.col], 1.f);      // counter 0 = packet count
    }
    ro += n;
  }
  return 0.f;
}

template <int KIND, int MAXT>
__global__ void __launch_bounds__(RT_WARPS * 32)
    fused_flow_kernel(const __grid_constant__ FlowLaunch<MAXT> g,
                      SuffixArgs s, int* verdicts, MitArgs m) {
  extern __shared__ __align__(16) float ff_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * RT_WARPS + warp;
  const int nw = gridDim.x * RT_WARPS;
  // A: every table's chains, rows scattered to arrival order
  float* wb = ff_smem + warp * g.wbuf;
  const int items = g.nt * g.B;
  for (int i = gw; i < items; i += nw) {
    const int t = i / g.B;
    const int k = i - t * g.B;
    const TableArgs& ta = g.t[t];
    float* zt = g.z + ta.col;
    if (ta.a.valid[k] == 0) {                // padding: a zero row
      for (int c = lane; c < ta.a.W; c += 32)
        zt[(size_t)k * g.zw + c] = 0.f;
    }
    const FlowArgs fa = ta.a;                // off the parameter space
    flow_chain(fa, k, lane, wb, g.wbuf, zt, g.zw);
  }
  cg::this_grid().sync();                    // every row of z is written
  // B: stage the classifier, then classify in arrival order, one warp
  // per row
  float* hb = ff_smem + warp * FF_HBUF;
  float* psm = ff_smem + RT_WARPS * FF_HBUF;
  const MlpParams mp = suffix_load<KIND>(psm, s);
  __syncthreads();
  const bool sel = KIND == KIND_CENTROID && s.cent.n_sel != 0;
  const int n_feat = KIND == KIND_CENTROID ? s.cent.D : g.n_in;
  for (int k = gw; k < g.B; k += nw) {
    const float* zr = g.z + (size_t)k * g.zw;
    // a folded FeatureSelect gathers its columns: the readout row may be
    // wider than the warp's buffer
    for (int i = lane; i < n_feat; i += 32)
      hb[i] = readout_at(g, zr, sel ? s.fidx[i] : i);
    int cls;
    if constexpr (KIND == KIND_MLP) {
      cls = mlp_argmax(hb, mp, s.mlp, lane);
    } else if constexpr (KIND == KIND_MAT) {
      cls = mat_classify(hb, psm, s.lmap, s.mat, lane);
    } else {
      CentDims c = s.cent;
      c.n_sel = 0;
      cls = centroid_classify(hb, psm, nullptr, s.lmap, c, lane);
    }
    if (lane == 0) verdicts[k] = cls;
  }
  // C: the action table, keyed by table 0's keys
  if (m.keys != nullptr) {
    cg::this_grid().sync();                  // every verdict is written
    for (int k = gw; k < g.B; k += nw)
      mitigate_chain(m, g.t[0].a.pkt_keys, verdicts, k, lane);
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

template <int KIND, int MAXT>
cudaError_t launch_kind(const TableArgs* tables, int nt, float* z, int zw,
                        int n_in, const SuffixArgs& s, int* verdicts,
                        const MitArgs& m, cudaStream_t stream) {
  auto kernel = fused_flow_kernel<KIND, MAXT>;
  // phase A: each warp's walk buffer for the widest table; phase B: each
  // warp's activation rows and the staged classifier
  int wbuf = 0;
  for (int t = 0; t < nt; ++t) {
    const FlowArgs& a = tables[t].a;
    const int f = fc_warp_floats(a.U, a.H);
    if (f > wbuf) wbuf = f;
  }
  const size_t walk = (size_t)RT_WARPS * wbuf;
  const size_t cls = RT_MLP_HBUF_FLOATS + suffix_floats(s);
  const size_t smem = sizeof(float) * (walk > cls ? walk : cls);
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
  static thread_local FlowLaunch<MAXT> g;    // 30 KB at most: off the stack
  g.z = z;
  g.nt = nt;
  g.B = tables[0].a.B;
  g.zw = zw;
  g.n_in = n_in;
  g.wbuf = wbuf;
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

// A one-table launch carries one descriptor, a multi-table one
// RT_MAX_TABLES: the larger parameter block (about 30 KB) goes with every
// launch and cost a one-table batch about 2.4 us of device time on an
// H100 (0.0162 against 0.0138 ms at B = 512).
template <int KIND>
cudaError_t launch_tables(const TableArgs* tables, int nt, float* z,
                          int zw, int n_in, const SuffixArgs& s,
                          int* verdicts, const MitArgs& m,
                          cudaStream_t stream) {
  if (nt == 1)
    return launch_kind<KIND, 1>(tables, nt, z, zw, n_in, s, verdicts, m,
                                stream);
  return launch_kind<KIND, RT_MAX_TABLES>(tables, nt, z, zw, n_in, s,
                                          verdicts, m, stream);
}

}  // namespace

cudaError_t launch_fused_flow(const TableArgs* tables, int nt, float* z,
                              int zw, int n_in, const SuffixArgs& s,
                              int* verdicts, const MitArgs* mit,
                              cudaStream_t stream) {
  if (nt < 1 || nt > RT_MAX_TABLES) return cudaErrorInvalidValue;
  if (tables[0].a.B == 0) return cudaSuccess;
  MitArgs none{};                            // keys == nullptr: no table
  const MitArgs& m = mit == nullptr ? none : *mit;
  if (s.kind == KIND_MLP)
    return launch_tables<KIND_MLP>(tables, nt, z, zw, n_in, s, verdicts, m,
                                   stream);
  if (s.kind == KIND_MAT)
    return launch_tables<KIND_MAT>(tables, nt, z, zw, n_in, s, verdicts, m,
                                   stream);
  return launch_tables<KIND_CENTROID>(tables, nt, z, zw, n_in, s, verdicts,
                                      m, stream);
}
