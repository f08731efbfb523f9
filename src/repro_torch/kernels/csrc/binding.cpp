// PyTorch binding for the port's CUDA kernels: the only source that
// includes torch/extension.h.  Each function takes tensors the Python
// wrapper has already checked (device, dtype, shape, contiguity), fills
// the plain-C argument structs, launches on the current stream and
// raises on a refused launch.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <pybind11/stl.h>

#include <climits>
#include <cmath>
#include <vector>

#include "rt_types.h"

namespace {

FlowArgs flow_args(at::Tensor& keys, at::Tensor& regs,
                   const at::Tensor& pkt_keys, const at::Tensor& upd,
                   const at::Tensor& bins, const at::Tensor& valid,
                   const at::Tensor& order, const at::Tensor& seg_first,
                   const at::Tensor& seg_len, const at::Tensor& seg_slot,
                   int64_t n_counters, int64_t n_ewma, double alpha) {
  TORCH_CHECK(regs.size(1) <= 32 * RT_COLS, "register width > ",
              32 * RT_COLS);
  TORCH_CHECK(bins.size(1) <= RT_MAX_HISTS, "bins columns > ",
              RT_MAX_HISTS);
  FlowArgs a;
  a.keys = keys.data_ptr<int>();
  a.regs = regs.data_ptr<float>();
  a.pkt_keys = pkt_keys.data_ptr<int>();
  a.upd = upd.data_ptr<float>();
  a.bins = bins.data_ptr<int>();
  a.valid = valid.data_ptr<int>();
  a.order = order.data_ptr<int>();
  a.seg_first = seg_first.data_ptr<int>();
  a.seg_len = seg_len.data_ptr<int>();
  a.seg_slot = seg_slot.data_ptr<int>();
  a.B = (int)pkt_keys.size(0);
  a.W = (int)regs.size(1);
  a.U = (int)upd.size(1);
  a.H = (int)bins.size(1);
  a.C = (int)n_counters;
  a.E = (int)n_ewma;
  a.alpha = (float)alpha;
  return a;
}

MlpDims mlp_dims(const std::vector<int64_t>& widths) {
  TORCH_CHECK(widths.size() >= 2 && widths.size() <= RT_MAX_LAYERS + 1,
              "MLP needs 1..", RT_MAX_LAYERS, " layers");
  MlpDims d;
  d.n_layers = (int)widths.size() - 1;
  d.n_w = 0;
  d.n_b = 0;
  for (size_t i = 0; i < widths.size(); ++i) {
    TORCH_CHECK(widths[i] >= 1 && widths[i] <= RT_MAX_MLP_WIDTH,
                "MLP width out of range: ", widths[i]);
    d.widths[i] = (int)widths[i];
    if (i > 0) {
      d.n_w += d.widths[i - 1] * d.widths[i];
      d.n_b += d.widths[i];
    }
  }
  return d;
}

cudaStream_t stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void flow_update(at::Tensor keys, at::Tensor regs, at::Tensor pkt_keys,
                 at::Tensor upd, at::Tensor bins, at::Tensor valid,
                 at::Tensor order, at::Tensor seg_first, at::Tensor seg_len,
                 at::Tensor seg_slot, at::Tensor feats, int64_t n_counters,
                 int64_t n_ewma, double alpha) {
  c10::cuda::CUDAGuard guard(regs.device());
  FlowArgs a = flow_args(keys, regs, pkt_keys, upd, bins, valid, order,
                         seg_first, seg_len, seg_slot, n_counters, n_ewma,
                         alpha);
  C10_CUDA_CHECK(launch_flow_update(a, feats.data_ptr<float>(),
                                    stream_of(regs)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_classify(at::Tensor x, at::Tensor w_flat, at::Tensor b_flat,
                        std::vector<int64_t> widths, at::Tensor out) {
  c10::cuda::CUDAGuard guard(x.device());
  MlpDims d = mlp_dims(widths);
  TORCH_CHECK(w_flat.numel() == d.n_w && b_flat.numel() == d.n_b,
              "packed MLP does not match its widths");
  C10_CUDA_CHECK(launch_fused_mlp_classify(
      x.data_ptr<float>(), (int)x.size(0), d, w_flat.data_ptr<float>(),
      b_flat.data_ptr<float>(), out.data_ptr<int>(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp(at::Tensor x, at::Tensor w_flat, at::Tensor b_flat,
               std::vector<int64_t> widths, at::Tensor out) {
  c10::cuda::CUDAGuard guard(x.device());
  MlpDims d = mlp_dims(widths);
  TORCH_CHECK(w_flat.numel() == d.n_w && b_flat.numel() == d.n_b,
              "packed MLP does not match its widths");
  TORCH_CHECK(out.size(0) == x.size(0) && out.size(1) == d.widths[d.n_layers],
              "logits must be [B, C]");
  C10_CUDA_CHECK(launch_fused_mlp(
      x.data_ptr<float>(), (int)x.size(0), d, w_flat.data_ptr<float>(),
      b_flat.data_ptr<float>(), out.data_ptr<float>(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// widths: every model's layer widths back to back, n_layers[i] + 1 each;
// program: the plan's (op, arg) pairs back to back.
void fused_dag(at::Tensor x, at::Tensor w_flat, at::Tensor b_flat,
               std::vector<int64_t> n_layers, std::vector<int64_t> widths,
               std::vector<int64_t> program, at::Tensor out) {
  c10::cuda::CUDAGuard guard(x.device());
  const int n_models = (int)n_layers.size();
  TORCH_CHECK(n_models >= 1 && n_models <= RT_DAG_MAX_MODELS,
              "a fused DAG takes 1..", RT_DAG_MAX_MODELS, " models");
  TORCH_CHECK(program.size() % 2 == 0 &&
                  (int64_t)program.size() <= 2 * RT_DAG_MAX_OPS,
              "a DAG plan takes at most ", RT_DAG_MAX_OPS, " instructions");
  DagArgs g{};
  g.n_models = n_models;
  g.n_ops = (int)program.size() / 2;
  g.n_feat = (int)x.size(1);
  size_t at = 0;
  int64_t n_w = 0, n_b = 0;
  for (int i = 0; i < n_models; ++i) {
    TORCH_CHECK(at + n_layers[i] + 1 <= widths.size(), "DAG widths");
    std::vector<int64_t> wi(widths.begin() + at,
                            widths.begin() + at + n_layers[i] + 1);
    at += n_layers[i] + 1;
    g.m[i] = mlp_dims(wi);
    TORCH_CHECK(g.m[i].widths[0] == g.n_feat,
                "every DAG model reads the whole input row");
    n_w += g.m[i].n_w;
    n_b += g.m[i].n_b;
  }
  TORCH_CHECK(at == widths.size() && n_w == w_flat.numel() &&
                  n_b == b_flat.numel(),
              "packed DAG does not match its widths");
  int depth = 0;
  for (int k = 0; k < g.n_ops; ++k) {
    g.op[k] = (int)program[2 * k];
    g.arg[k] = (int)program[2 * k + 1];
    if (g.op[k] == DAG_MODEL) {
      TORCH_CHECK(g.arg[k] >= 0 && g.arg[k] < n_models, "DAG model index");
      ++depth;
    } else {
      TORCH_CHECK(g.op[k] >= DAG_SEQ && g.op[k] <= DAG_AND && g.arg[k] >= 1 &&
                      g.arg[k] <= depth,
                  "malformed DAG plan");
      depth -= g.arg[k] - 1;
    }
  }
  TORCH_CHECK(depth == 1, "a DAG plan must leave one verdict");
  C10_CUDA_CHECK(launch_fused_dag(
      x.data_ptr<float>(), (int)x.size(0), g, w_flat.data_ptr<float>(),
      b_flat.data_ptr<float>(), out.data_ptr<int>(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

MatDims mat_dims(const at::Tensor& edges, const at::Tensor& tables,
                 const at::Tensor& lmap, bool use_min) {
  MatDims m;
  m.F = (int)edges.size(0);
  m.E = (int)edges.size(1);
  m.C = (int)tables.size(2);
  m.use_min = use_min ? 1 : 0;
  TORCH_CHECK(tables.size(0) == m.F && tables.size(1) == m.E + 1,
              "MAT tables do not fit the edges");
  TORCH_CHECK(m.F >= 1 && m.F <= RT_MAT_MAX_FEATURES, "MAT features");
  TORCH_CHECK(m.C >= 1 && m.C <= 32 * RT_CLS_PER_LANE, "MAT classes");
  TORCH_CHECK(lmap.numel() >= m.C, "label map shorter than the classes");
  return m;
}

// K4 stages its edges and the tables with 16-byte bulk copies: each
// buffer starts 16-byte aligned and its storage runs on to a multiple of
// 4 floats (pack_mat pads the end of each).
void check_bulk_padded(const at::Tensor& t, const char* what) {
  const int64_t n4 = (t.numel() + 3) & ~int64_t(3);
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0 &&
                  (int64_t)t.storage().nbytes() >=
                      (t.storage_offset() + n4) * (int64_t)t.element_size(),
              "K4 takes MAT ", what, " packed by pack_mat (16-byte "
              "aligned, storage padded to 4 floats)");
}

// K4: k4_edges [F, ep] is pack_mat's copy of the edges for K4 (the edges
// themselves at most RT_MAT_SPLIT_EDGES wide, else rows padded with +inf
// to a multiple of 32); E comes from the tables.
void mat_lut_classify(at::Tensor x, at::Tensor k4_edges, at::Tensor tables,
                      at::Tensor lmap, at::Tensor out, bool use_min) {
  c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(tables.dim() == 3 && k4_edges.dim() == 2 &&
                  k4_edges.size(0) == tables.size(0),
              "MAT tables do not fit the edges");
  MatDims m;
  m.F = (int)tables.size(0);
  m.E = (int)tables.size(1) - 1;
  m.C = (int)tables.size(2);
  m.use_min = use_min ? 1 : 0;
  TORCH_CHECK(m.F >= 1 && m.F <= RT_MAT_MAX_FEATURES, "MAT features");
  TORCH_CHECK(m.C >= 1 && m.C <= 32 * RT_CLS_PER_LANE, "MAT classes");
  TORCH_CHECK(lmap.numel() >= m.C, "label map shorter than the classes");
  TORCH_CHECK(x.size(1) == m.F, "x width != MAT features");
  check_bulk_padded(k4_edges, "edges");
  check_bulk_padded(tables, "tables");
  C10_CUDA_CHECK(launch_mat_lut_classify(
      x.data_ptr<float>(), (int)x.size(0), m, k4_edges.data_ptr<float>(),
      (int)k4_edges.size(1), tables.data_ptr<float>(), lmap.data_ptr<int>(),
      out.data_ptr<int>(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// kind 0 (MLP): params = [w_flat, b_flat], dims = the layer widths;
// kind 1 (MAT): params = [edges, tables, lmap], dims = [use_min];
// kind 2 (centroid): params = [cent, fidx, lmap], dims = [use_min]
// (fidx empty: no FeatureSelect).
SuffixArgs suffix_args(int64_t kind, const std::vector<at::Tensor>& params,
                       const std::vector<int64_t>& dims) {
  SuffixArgs s{};
  s.kind = (int)kind;
  if (kind == 0) {
    TORCH_CHECK(params.size() == 2, "MLP suffix takes w_flat, b_flat");
    s.mlp = mlp_dims(dims);
    TORCH_CHECK(params[0].numel() == s.mlp.n_w &&
                    params[1].numel() == s.mlp.n_b,
                "packed MLP does not match its widths");
    s.p0 = params[0].data_ptr<float>();
    s.p1 = params[1].data_ptr<float>();
  } else if (kind == 1) {
    TORCH_CHECK(params.size() == 3 && dims.size() == 1,
                "MAT suffix takes edges, tables, lmap and use_min");
    s.mat = mat_dims(params[0], params[1], params[2], dims[0] != 0);
    s.p0 = params[0].data_ptr<float>();
    s.p1 = params[1].data_ptr<float>();
    s.lmap = params[2].data_ptr<int>();
  } else if (kind == 2) {
    TORCH_CHECK(params.size() == 3 && dims.size() == 1,
                "centroid suffix takes cent, fidx, lmap and use_min");
    const at::Tensor& cent = params[0];
    s.cent.K = (int)cent.size(0);
    s.cent.D = (int)cent.size(1);
    s.cent.n_sel = (int)params[1].numel();
    s.cent.use_min = dims[0] != 0 ? 1 : 0;
    TORCH_CHECK(s.cent.K >= 1 && s.cent.K <= 32 * RT_CLS_PER_LANE,
                "centroid count");
    TORCH_CHECK(s.cent.n_sel == 0 || s.cent.n_sel == s.cent.D,
                "feature index does not match the centroid width");
    TORCH_CHECK(params[2].numel() >= s.cent.K,
                "label map shorter than the centroids");
    s.p0 = cent.data_ptr<float>();
    s.fidx = s.cent.n_sel ? params[1].data_ptr<int>() : nullptr;
    s.lmap = params[2].data_ptr<int>();
  } else {
    TORCH_CHECK(false, "suffix kind must be 0, 1 or 2");
  }
  return s;
}

// mit: empty, or [mit_keys, mit_regs, order, seg_first, seg_len,
// seg_slot] with mit_policy = [threshold, keep_every, attack_class, drop]
// -> whether there is an action table.
bool mit_args(const std::vector<at::Tensor>& mit,
              const std::vector<double>& mit_policy, MitArgs* m) {
  if (mit.empty()) return false;
  TORCH_CHECK(mit.size() == 6 && mit_policy.size() == 4,
              "mitigation takes 6 tensors and 4 policy values");
  m->keys = mit[0].data_ptr<int>();
  m->regs = mit[1].data_ptr<float>();
  m->order = mit[2].data_ptr<int>();
  m->seg_first = mit[3].data_ptr<int>();
  m->seg_len = mit[4].data_ptr<int>();
  m->seg_slot = mit[5].data_ptr<int>();
  m->threshold = (float)mit_policy[0];
  m->keep_every = (float)mit_policy[1];
  m->attack_class = (int)mit_policy[2];
  m->drop = mit_policy[3] != 0.0 ? 1 : 0;
  return true;
}

// K1, one table or several.  tables: per table [keys, regs, pkt_keys,
// upd, bins, order, seg_first, seg_len, seg_slot]; dims: per table
// [n_counters, n_ewma, readout mode]; alphas: per table; z: the scratch
// of post-update rows, [B, sum of the widths each rounded up to 32].
void fused_flow_serve(std::vector<at::Tensor> tables, at::Tensor valid,
                      std::vector<int64_t> dims, std::vector<double> alphas,
                      int64_t kind, std::vector<at::Tensor> params,
                      std::vector<int64_t> sdims, at::Tensor z,
                      at::Tensor verdicts, std::vector<at::Tensor> mit,
                      std::vector<double> mit_policy) {
  c10::cuda::CUDAGuard guard(valid.device());
  const int nt = (int)alphas.size();
  TORCH_CHECK(nt >= 1 && nt <= RT_MAX_TABLES, "a K1 launch takes 1..",
              RT_MAX_TABLES, " tables");
  TORCH_CHECK(tables.size() == 9 * (size_t)nt && dims.size() == 3 * (size_t)nt,
              "9 tensors and 3 dims per table");
  std::vector<TableArgs> tabs(nt);
  int col = 0, n_in = 0;
  for (int t = 0; t < nt; ++t) {
    at::Tensor* u = &tables[9 * t];
    const int64_t mode = dims[3 * t + 2];
    TORCH_CHECK(mode >= 0 && mode <= 2, "readout mode must be 0, 1 or 2");
    tabs[t].a = flow_args(u[0], u[1], u[2], u[3], u[4], valid, u[5], u[6],
                          u[7], u[8], dims[3 * t], dims[3 * t + 1],
                          alphas[t]);
    TORCH_CHECK(tabs[t].a.B == (int)valid.size(0),
                "every table takes the whole batch");
    tabs[t].mode = (int)mode;
    tabs[t].col = col;
    col += (tabs[t].a.W + 31) & ~31;         // rows start on 128-byte lines
    n_in += mode == 1 ? tabs[t].a.W - tabs[t].a.C - tabs[t].a.E
                      : tabs[t].a.W;
  }
  TORCH_CHECK(z.size(0) == valid.size(0) && z.size(1) == col,
              "z must be [B, sum of the register widths rounded up to 32]");
  SuffixArgs s = suffix_args(kind, params, sdims);
  MitArgs m{};
  const MitArgs* mp = mit_args(mit, mit_policy, &m) ? &m : nullptr;
  C10_CUDA_CHECK(launch_fused_flow(tabs.data(), nt, z.data_ptr<float>(), col,
                                   n_in, s, verdicts.data_ptr<int>(), mp,
                                   stream_of(valid)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K7: o = attention(q, k, v) over the first skv keys; the wrapper has
// checked the shapes, dtypes, contiguity and alignment.  A bf16 call
// with Sq <= FA_DECODE_MAX_SQ is a split-KV decode over keys [kv_lo,
// kv_hi) in n_chunks chunks of ``chunk`` keys, its partials in ``ws``
// (f32, B * K * n_chunks * R * (D + 2), R = Sq * H / K); other calls
// ignore those arguments.
void flash_attention(at::Tensor q, at::Tensor k, at::Tensor v, at::Tensor o,
                     at::Tensor ws, int64_t skv, int64_t q_offset,
                     bool causal, int64_t window, int64_t kv_lo,
                     int64_t kv_hi, int64_t chunk, int64_t n_chunks) {
  c10::cuda::CUDAGuard guard(q.device());
  const bool bf16 = q.scalar_type() == at::kBFloat16;
  TORCH_CHECK(bf16 || q.scalar_type() == at::kFloat,
              "K7 takes bf16 or f32 operands");
  TORCH_CHECK(k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type() &&
                  o.scalar_type() == q.scalar_type(),
              "q, k, v and o must share one dtype");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && v.sizes() == k.sizes() &&
                  o.sizes() == q.sizes(),
              "q, o [B, Sq, H, D]; k, v [B, Skv, K, D]");
  TORCH_CHECK(q.is_contiguous() && k.is_contiguous() && v.is_contiguous() &&
                  o.is_contiguous(),
              "K7 takes contiguous tensors");
  for (const at::Tensor* t : {&q, &k, &v, &o})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "K7's loads need 16-byte aligned tensors");
  const int64_t D = q.size(3);
  TORCH_CHECK(k.size(0) == q.size(0) && k.size(3) == D,
              "q and k differ in batch or head width");
  TORCH_CHECK(k.size(2) >= 1 && q.size(2) % k.size(2) == 0,
              "query heads must group over the kv heads");
  TORCH_CHECK(skv >= 1 && skv <= k.size(1), "skv outside 1..Skv");
  TORCH_CHECK(q.size(0) <= 65535 && q.size(2) <= 65535,
              "batch and heads index the grid's y and z");
  TORCH_CHECK(q_offset >= 0 && window >= 0 &&
                  q_offset + q.size(1) < INT_MAX && k.size(1) < INT_MAX,
              "positions must fit an int");
  FlashArgs a;
  a.B = (int)q.size(0);
  a.Sq = (int)q.size(1);
  a.Skv = (int)k.size(1);
  a.H = (int)q.size(2);
  a.K = (int)k.size(2);
  a.skv = (int)skv;
  a.q_offset = (int)q_offset;
  a.causal = causal ? 1 : 0;
  a.window = (int)window;
  a.scale = (float)(1.0 / std::sqrt((double)D));
  a.kv_lo = a.kv_hi = a.chunk = a.n_chunks = 0;
  a.ws_acc = a.ws_ml = nullptr;
  if (a.Sq <= FA_DECODE_MAX_SQ && a.B > 0) {
    const int64_t R = q.size(1) * (q.size(2) / k.size(2));
    TORCH_CHECK(0 <= kv_lo && kv_lo < kv_hi && kv_hi <= skv && chunk >= 1 &&
                    n_chunks >= 1 && (n_chunks - 1) * chunk < kv_hi - kv_lo &&
                    n_chunks * chunk >= kv_hi - kv_lo,
                "split-KV plan does not cover keys [kv_lo, kv_hi)");
    TORCH_CHECK((k.size(2) * ((R + FA_DECODE_ROWS - 1) / FA_DECODE_ROWS)) <=
                    65535 && n_chunks < INT_MAX,
                "kv heads x row groups index the grid's y");
    const int64_t n_acc = q.size(0) * k.size(2) * n_chunks * R * D;
    TORCH_CHECK(ws.scalar_type() == at::kFloat && ws.is_contiguous() &&
                    ws.device() == q.device() &&
                    ws.numel() >= n_acc + n_acc / D * 2,
                "split-KV workspace: f32, B * K * n_chunks * R * (D + 2)");
    a.kv_lo = (int)kv_lo;
    a.kv_hi = (int)kv_hi;
    a.chunk = (int)chunk;
    a.n_chunks = (int)n_chunks;
    a.ws_acc = ws.data_ptr<float>();
    a.ws_ml = a.ws_acc + n_acc;
  }
  C10_CUDA_CHECK(launch_flash_attention(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(), a,
                                        (int)D, bf16 ? 1 : 0, stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K7b: dq, dk, dv = the gradient of K7's output over the first skv keys
// against dout; lse and delta f32 [B, H, Sq] scratch.  The wrapper has
// checked shapes, dtypes, contiguity and alignment.
void flash_attention_bwd(at::Tensor q, at::Tensor k, at::Tensor v,
                         at::Tensor dout, at::Tensor lse, at::Tensor delta,
                         at::Tensor dq, at::Tensor dk, at::Tensor dv,
                         int64_t skv, int64_t q_offset, bool causal,
                         int64_t window) {
  c10::cuda::CUDAGuard guard(q.device());
  const bool bf16 = q.scalar_type() == at::kBFloat16;
  TORCH_CHECK(bf16 || q.scalar_type() == at::kFloat,
              "K7b takes bf16 or f32 operands");
  for (const at::Tensor* t : {&k, &v, &dout, &dq, &dk, &dv})
    TORCH_CHECK(t->scalar_type() == q.scalar_type(),
                "q, k, v, dout and the gradients must share one dtype");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && v.sizes() == k.sizes() &&
                  dout.sizes() == q.sizes() && dq.sizes() == q.sizes() &&
                  dk.sizes() == k.sizes() && dv.sizes() == k.sizes(),
              "q, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, K, D]");
  for (const at::Tensor* t : {&q, &k, &v, &dout, &dq, &dk, &dv, &lse, &delta})
    TORCH_CHECK(t->is_contiguous() &&
                    reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "K7b takes contiguous tensors aligned to 16 bytes");
  const int64_t D = q.size(3);
  TORCH_CHECK(k.size(0) == q.size(0) && k.size(3) == D,
              "q and k differ in batch or head width");
  TORCH_CHECK(k.size(2) >= 1 && q.size(2) % k.size(2) == 0,
              "query heads must group over the kv heads");
  TORCH_CHECK(skv >= 1 && skv <= k.size(1), "skv outside 1..Skv");
  TORCH_CHECK(q.size(0) <= 65535 && q.size(2) <= 65535,
              "batch and heads index the grid's y and z");
  TORCH_CHECK((q.size(1) + FA_BWD_TILE - 1) / FA_BWD_TILE <= 65535 &&
                  (k.size(1) + FA_BWD_TILE - 1) / FA_BWD_TILE <= 65535,
              "K7b's grids index 64-row tiles by z");
  TORCH_CHECK(q_offset >= 0 && window >= 0 &&
                  q_offset + q.size(1) + window < INT_MAX &&
                  k.size(1) < INT_MAX,
              "positions must fit an int");
  const int64_t n_stat = q.size(0) * q.size(2) *
                         ((q.size(1) + FA_BWD_TILE - 1) / FA_BWD_TILE *
                          FA_BWD_TILE);
  TORCH_CHECK(lse.scalar_type() == at::kFloat &&
                  delta.scalar_type() == at::kFloat &&
                  lse.numel() == n_stat && delta.numel() == n_stat,
              "lse and delta: f32 [B, H, Sq padded to FA_BWD_TILE]");
  FlashArgs a;
  a.B = (int)q.size(0);
  a.Sq = (int)q.size(1);
  a.Skv = (int)k.size(1);
  a.H = (int)q.size(2);
  a.K = (int)k.size(2);
  a.skv = (int)skv;
  a.q_offset = (int)q_offset;
  a.causal = causal ? 1 : 0;
  a.window = (int)window;
  a.scale = (float)(1.0 / std::sqrt((double)D));
  a.kv_lo = a.kv_hi = a.chunk = a.n_chunks = 0;
  a.ws_acc = a.ws_ml = nullptr;
  C10_CUDA_CHECK(launch_flash_attention_bwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      dk.data_ptr(), dv.data_ptr(), a, (int)D, bf16 ? 1 : 0, stream_of(q)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K8: y, h_out = the selective scan of (dA, dBx, C, h0); the wrapper has
// checked the shapes, dtypes, contiguity and N.
void selective_scan(at::Tensor dA, at::Tensor dBx, at::Tensor C,
                    at::Tensor h0, at::Tensor y, at::Tensor h_out) {
  c10::cuda::CUDAGuard guard(dA.device());
  for (const at::Tensor* t : {&dA, &dBx, &C, &h0, &y, &h_out}) {
    TORCH_CHECK(t->scalar_type() == at::kFloat && t->is_contiguous(),
                "K8 takes contiguous float32 tensors");
  }
  TORCH_CHECK(dA.dim() == 4 && dBx.sizes() == dA.sizes(),
              "dA, dBx [B, S, di, N]");
  const int64_t B = dA.size(0), S = dA.size(1), di = dA.size(2),
                N = dA.size(3);
  TORCH_CHECK(C.dim() == 3 && C.size(0) == B && C.size(1) == S &&
                  C.size(2) == N,
              "C [B, S, N]");
  TORCH_CHECK(h0.dim() == 3 && h0.size(0) == B && h0.size(1) == di &&
                  h0.size(2) == N && h_out.sizes() == h0.sizes(),
              "h0, h_out [B, di, N]");
  TORCH_CHECK(y.dim() == 3 && y.size(0) == B && y.size(1) == S &&
                  y.size(2) == di,
              "y [B, S, di]");
  TORCH_CHECK(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
              "N must be a power of two <= 32");
  for (const at::Tensor* t : {&dA, &dBx, &h0, &h_out})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "K8's row loads need 16-byte aligned dA, dBx, h0 and h_out");
  TORCH_CHECK(B <= 65535, "the batch indexes the grid's y");
  TORCH_CHECK(S < INT_MAX && di * N < INT_MAX, "sizes must fit an int");
  ScanArgs a;
  a.B = (int)B;
  a.S = (int)S;
  a.di = (int)di;
  a.N = (int)N;
  C10_CUDA_CHECK(launch_selective_scan(
      dA.data_ptr<float>(), dBx.data_ptr<float>(), C.data_ptr<float>(),
      h0.data_ptr<float>(), y.data_ptr<float>(), h_out.data_ptr<float>(), a,
      stream_of(dA)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K8's discretizing entry: y, h_out = the selective scan of dA = exp(dt
// A), dBx = dt Bm x and C from h0; with a non-empty ckpt (under
// autograd) also h entering every chunk of SSB_CHUNK(N) steps.  The
// wrapper has checked the shapes, dtypes, contiguity, alignment and N.
void selective_scan_discretized(at::Tensor dt, at::Tensor A, at::Tensor Bm,
                                at::Tensor C, at::Tensor x, at::Tensor h0,
                                at::Tensor y, at::Tensor h_out,
                                at::Tensor ckpt) {
  c10::cuda::CUDAGuard guard(dt.device());
  for (const at::Tensor* t : {&dt, &A, &Bm, &C, &h0, &y, &h_out}) {
    TORCH_CHECK(t->scalar_type() == at::kFloat && t->is_contiguous(),
                "K8 takes contiguous float32 dt, A, Bm, C and h0");
  }
  const bool xbf = x.scalar_type() == at::kBFloat16;
  TORCH_CHECK((xbf || x.scalar_type() == at::kFloat) && x.is_contiguous(),
              "K8's x: contiguous float32 or bfloat16");
  TORCH_CHECK(dt.dim() == 3 && x.sizes() == dt.sizes() &&
                  y.sizes() == dt.sizes(),
              "dt, x, y [B, S, di]");
  const int64_t B = dt.size(0), S = dt.size(1), di = dt.size(2),
                N = A.size(1);
  TORCH_CHECK(A.dim() == 2 && A.size(0) == di, "A [di, N]");
  TORCH_CHECK(Bm.dim() == 3 && Bm.size(0) == B && Bm.size(1) == S &&
                  Bm.size(2) == N && C.sizes() == Bm.sizes(),
              "Bm, C [B, S, N]");
  TORCH_CHECK(h0.dim() == 3 && h0.size(0) == B && h0.size(1) == di &&
                  h0.size(2) == N && h_out.sizes() == h0.sizes(),
              "h0, h_out [B, di, N]");
  TORCH_CHECK(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
              "N must be a power of two <= 32");
  for (const at::Tensor* t : {&A, &h0, &h_out})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "K8's row loads need 16-byte aligned A, h0 and h_out");
  TORCH_CHECK(B <= 65535, "the batch indexes the grid's y");
  TORCH_CHECK(S < INT_MAX && di * N < INT_MAX, "sizes must fit an int");
  ScanArgs a;
  a.B = (int)B;
  a.S = (int)S;
  a.di = (int)di;
  a.N = (int)N;
  if (ckpt.numel() == 0) {
    C10_CUDA_CHECK(launch_selective_scan_discretized(
        dt.data_ptr<float>(), A.data_ptr<float>(), Bm.data_ptr<float>(),
        C.data_ptr<float>(), x.data_ptr(), xbf ? 1 : 0, h0.data_ptr<float>(),
        y.data_ptr<float>(), h_out.data_ptr<float>(), a, stream_of(dt)));
  } else {
    const int64_t T = SSB_CHUNK(N);
    TORCH_CHECK(ckpt.scalar_type() == at::kFloat && ckpt.is_contiguous() &&
                    ckpt.dim() == 4 && ckpt.size(0) == B &&
                    ckpt.size(1) == (S + T - 1) / T && ckpt.size(2) == di &&
                    ckpt.size(3) == N &&
                    reinterpret_cast<uintptr_t>(ckpt.data_ptr()) % 16 == 0,
                "K8's checkpoints: contiguous aligned float32 [B, ceil(S / ",
                T, "), di, N]");
    C10_CUDA_CHECK(launch_selective_scan_discretized_ckpt(
        dt.data_ptr<float>(), A.data_ptr<float>(), Bm.data_ptr<float>(),
        C.data_ptr<float>(), x.data_ptr(), xbf ? 1 : 0, h0.data_ptr<float>(),
        y.data_ptr<float>(), h_out.data_ptr<float>(),
        ckpt.data_ptr<float>(), a, stream_of(dt)));
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K8b: the gradient of K8's discretizing entry from its inputs, the
// checkpoints K8 wrote under autograd, dy and dh_final (empty: zero) into
// ddt, dA, dBm, dC, dx and dh0 (empty: not wanted); ws_b, ws_c and ws_a
// are the partial sums' scratch.  The wrapper has checked the shapes,
// dtypes, contiguity and alignment.
void selective_scan_bwd(at::Tensor dt, at::Tensor A, at::Tensor Bm,
                        at::Tensor C, at::Tensor x, at::Tensor ckpt,
                        at::Tensor dy, at::Tensor dh_final, at::Tensor ddt,
                        at::Tensor dA, at::Tensor dBm, at::Tensor dC,
                        at::Tensor dx, at::Tensor dh0, at::Tensor ws_b,
                        at::Tensor ws_c, at::Tensor ws_a) {
  c10::cuda::CUDAGuard guard(dt.device());
  for (const at::Tensor* t : {&dt, &A, &Bm, &C, &ckpt, &dy, &dh_final, &ddt,
                              &dA, &dBm, &dC, &dh0, &ws_b, &ws_c, &ws_a}) {
    TORCH_CHECK(t->scalar_type() == at::kFloat && t->is_contiguous() &&
                    reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "K8b takes contiguous 16-byte aligned float32 tensors");
  }
  const bool xbf = x.scalar_type() == at::kBFloat16;
  TORCH_CHECK(x.scalar_type() == dx.scalar_type() &&
                  (xbf || x.scalar_type() == at::kFloat) &&
                  x.is_contiguous() && dx.is_contiguous(),
              "K8b's x and dx: contiguous, one dtype of float32, bfloat16");
  const int64_t B = dt.size(0), S = dt.size(1), di = dt.size(2),
                N = A.size(1), T = SSB_CHUNK(N);
  const int64_t nblk = (di + SSB_CHANNELS(N) - 1) / SSB_CHANNELS(N);
  TORCH_CHECK(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
              "N must be a power of two <= 32");
  TORCH_CHECK(dt.dim() == 3 && x.sizes() == dt.sizes() &&
                  dy.sizes() == dt.sizes() && ddt.sizes() == dt.sizes() &&
                  dx.sizes() == dt.sizes(),
              "dt, x, dy, ddt, dx [B, S, di]");
  TORCH_CHECK(A.dim() == 2 && A.size(0) == di && dA.sizes() == A.sizes(),
              "A, dA [di, N]");
  TORCH_CHECK(Bm.dim() == 3 && Bm.size(0) == B && Bm.size(1) == S &&
                  Bm.size(2) == N && C.sizes() == Bm.sizes() &&
                  dBm.sizes() == Bm.sizes() && dC.sizes() == Bm.sizes(),
              "Bm, C, dBm, dC [B, S, N]");
  TORCH_CHECK(ckpt.dim() == 4 && ckpt.size(0) == B &&
                  ckpt.size(1) == (S + T - 1) / T && ckpt.size(2) == di &&
                  ckpt.size(3) == N,
              "ckpt [B, ceil(S / ", T, "), di, N]");
  for (const at::Tensor* t : {&dh_final, &dh0})
    TORCH_CHECK(t->numel() == 0 || (t->dim() == 3 && t->size(0) == B &&
                                    t->size(1) == di && t->size(2) == N),
                "dh_final, dh0 [B, di, N] or empty");
  TORCH_CHECK(ws_b.numel() == nblk * B * S * N &&
                  ws_c.numel() == ws_b.numel() && ws_a.numel() == B * di * N,
              "K8b's scratch: ws_b, ws_c [", nblk, ", B, S, N], ws_a "
              "[B, di, N]");
  TORCH_CHECK(B >= 1 && S >= 1 && di >= 1, "K8b needs B, S, di >= 1");
  TORCH_CHECK(B <= 65535, "the batch indexes the grid's y");
  TORCH_CHECK(S < INT_MAX && di * N < INT_MAX, "sizes must fit an int");
  ScanBwdArgs a{};
  a.dt = dt.data_ptr<float>();
  a.A = A.data_ptr<float>();
  a.Bm = Bm.data_ptr<float>();
  a.C = C.data_ptr<float>();
  a.x = x.data_ptr();
  a.ckpt = ckpt.data_ptr<float>();
  a.dy = dy.data_ptr<float>();
  a.dh_final = dh_final.numel() ? dh_final.data_ptr<float>() : nullptr;
  a.ddt = ddt.data_ptr<float>();
  a.dA = dA.data_ptr<float>();
  a.dBm = dBm.data_ptr<float>();
  a.dC = dC.data_ptr<float>();
  a.dx = dx.data_ptr();
  a.dh0 = dh0.numel() ? dh0.data_ptr<float>() : nullptr;
  a.ws_b = ws_b.data_ptr<float>();
  a.ws_c = ws_c.data_ptr<float>();
  a.ws_a = ws_a.data_ptr<float>();
  a.B = (int)B;
  a.S = (int)S;
  a.di = (int)di;
  a.N = (int)N;
  C10_CUDA_CHECK(launch_selective_scan_bwd(a, xbf ? 1 : 0, stream_of(dt)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K9: out = sign(x) @ sign(w) in int32; xs [B, Kp] and wt [N, Kp] int8
// are the signs' scratch; the wrapper has checked shapes, dtypes and
// contiguity.
void binarized_gemm(at::Tensor x, at::Tensor w, at::Tensor xs,
                    at::Tensor wt, at::Tensor out) {
  c10::cuda::CUDAGuard guard(x.device());
  for (const at::Tensor* t : {&x, &w}) {
    TORCH_CHECK(t->scalar_type() == at::kFloat ||
                    t->scalar_type() == at::kBFloat16,
                "K9 takes f32 or bf16 operands");
  }
  for (const at::Tensor* t : {&x, &w, &xs, &wt, &out}) {
    TORCH_CHECK(t->is_contiguous(), "K9 takes contiguous tensors");
  }
  TORCH_CHECK(x.dim() == 2 && w.dim() == 2 && x.size(1) == w.size(0),
              "x [B, K], w [K, N]");
  const int64_t B = x.size(0), K = x.size(1), N = w.size(1);
  TORCH_CHECK(B >= 1 && K >= 1 && N >= 1, "B, K and N must be >= 1");
  const int64_t Kp = (K + BG_KTILE - 1) / BG_KTILE * BG_KTILE;
  TORCH_CHECK(B < INT_MAX && Kp < INT_MAX && N < INT_MAX &&
                  (B + 127) / 128 <= 65535,
              "sizes must fit an int and B / 128 the grid's y");
  TORCH_CHECK(xs.scalar_type() == at::kChar && xs.dim() == 2 &&
                  xs.size(0) == B && xs.size(1) == Kp &&
                  wt.scalar_type() == at::kChar && wt.dim() == 2 &&
                  wt.size(0) == N && wt.size(1) == Kp,
              "xs [B, Kp] and wt [N, Kp] int8, Kp = K rounded up to ",
              BG_KTILE);
  TORCH_CHECK(out.scalar_type() == at::kInt && out.dim() == 2 &&
                  out.size(0) == B && out.size(1) == N,
              "out [B, N] int32");
  C10_CUDA_CHECK(launch_binarized_gemm(
      x.data_ptr(), x.scalar_type() == at::kBFloat16 ? 1 : 0, w.data_ptr(),
      w.scalar_type() == at::kBFloat16 ? 1 : 0, xs.data_ptr<int8_t>(),
      wt.data_ptr<int8_t>(), out.data_ptr<int>(), (int)B, (int)K, (int)N,
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flow_update", &flow_update, "K2: flow-register update");
  m.def("fused_mlp_classify", &fused_mlp_classify, "K3: MLP + argmax");
  m.def("fused_mlp", &fused_mlp, "K5: MLP -> logits");
  m.def("fused_dag", &fused_dag, "K6: Seq/Par DAG of MLP classifiers");
  m.def("fused_flow_serve", &fused_flow_serve,
        "K1: every table's update + readout, one classifier "
        "[+ mitigation]");
  m.def("mat_lut_classify", &mat_lut_classify,
        "K4: MAT quantize + LUT sum + arg-reduce + LabelMap");
  m.def("flash_attention", &flash_attention,
        "K7: online-softmax attention (causal, window, GQA, q offset)");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "K7b: K7's backward (dq, dk, dv)");
  m.def("selective_scan", &selective_scan,
        "K8: the Mamba S6 recurrence (y, h_final)");
  m.def("selective_scan_discretized", &selective_scan_discretized,
        "K8: the Mamba S6 recurrence, discretizing dt, A, B and x itself "
        "(and checkpointing h for K8b under autograd)");
  m.def("selective_scan_bwd", &selective_scan_bwd,
        "K8b: the gradient of K8's discretizing entry");
  m.def("binarized_gemm", &binarized_gemm,
        "K9: sign(x) @ sign(w), int32 (int8 signs on wgmma)");
}
