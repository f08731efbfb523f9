// Plain C++ interface between the CUDA sources (*.cu, compiled by nvcc
// without PyTorch's headers) and the one PyTorch binding (binding.cpp).
#pragma once

#include <cuda_runtime_api.h>
#include <stdint.h>

#define RT_WARPS 8             // warps per block in every kernel
#define RT_COLS 8              // register columns per lane: W <= 256
#define RT_MAX_LAYERS 16       // MLP layers the kernels take
#define RT_MAX_MLP_WIDTH 256   // widest MLP layer the kernels take
#define RT_CLS_PER_LANE 4      // MAT classes / centroids per lane: <= 128
#define RT_MAT_MAX_FEATURES 64 // MAT features
#define RT_MAT_MAX_BINS 1024   // MAT bins: edges + 1 per feature
#define RT_MAT_SPLIT_EDGES 32  // K4 splits a count over the warp above this
#define RT_MAX_HISTS 8         // bins columns of a flow table
#define RT_MITIGATED (-1)      // verdict of a packet the action table drops
#define RT_CHAIN_CHUNK 32      // slot-chain steps K1 and K2 stage at a time
#define RT_DAG_MAX_MODELS 8    // distinct models in one fused DAG (K6)
#define RT_DAG_MAX_OPS 32      // instructions of a DAG plan (K6)
// K3, K5 and K6: a model (a DAG's models) of at most RT_MLP_CHUNK weights
// is staged whole and runs one warp a row; a larger one streams its
// weights in chunks of up to RT_MLP_CHUNK floats through tiles of up to
// RT_MLP_TILE_ROWS rows a block (mlp_tile.cuh).
#define RT_MLP_CHUNK 8192
#define RT_MLP_TILE_ROWS 32
// Flow tables of one K1 launch: their descriptors ride by
// value in the kernel parameter space (32,764 bytes on Hopper from CUDA
// 12.1 on), so the count is bounded by that space, not by the kernel.
#define RT_MAX_TABLES 256
// K7: calls with at most this many query rows take the split-KV decode
// kernel, longer ones a prefill kernel (bf16: tensor cores; f32: CUDA
// cores).
#define FA_DECODE_MAX_SQ 4
// K7's split-KV decode: query rows (Sq x the GQA group) per block, and
// keys per staged tile (a chunk is a whole number of tiles).
#define FA_DECODE_ROWS 64
#define FA_DECODE_TILE 32
// K7b: rows of its tiles (q rows or keys); lse and delta are [B, H, Sq]
// with Sq padded to a whole number of them.
#define FA_BWD_TILE 64
// K9: the int8 product's K tile (one 128-byte swizzled row of int8 signs);
// the sign scratch's rows are K rounded up to it, zero past K.
#define BG_KTILE 128
// K8b, the selective scan's backward: threads per block; the states a
// channel keeps for one chunk's walk (SSB_HIST / N steps of N), and the
// longest chunk: K8's forward under autograd checkpoints h every
// SSB_CHUNK(N) steps, and K8b recomputes and walks one such chunk at a
// time.  A channel's N states are split over SSB_LANES(N) lanes of
// SSB_LANE_N states each (all N on one lane below that), so a block holds
// SSB_CHANNELS(N) channels and its partial sums over channels are
// [di / SSB_CHANNELS(N) blocks, B, S, N].
#define SSB_THREADS 256
#define SSB_HIST 64
#define SSB_MAX_T 16
#define SSB_LANE_N 4
// the threads an SM holds: K8b's registers are capped to let this many
// in (64 a thread), which at N = 16 also fills the card in two whole
// waves at 4 x 16,384 channels
#define SSB_SM_THREADS 1024
#define SSB_CHUNK(N) (SSB_HIST / (N) < SSB_MAX_T ? SSB_HIST / (N) : SSB_MAX_T)
#define SSB_LANES(N) ((N) < SSB_LANE_N ? 1 : (N) / SSB_LANE_N)
#define SSB_CHANNELS(N) (SSB_THREADS / SSB_LANES(N))

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

// One table of a K1 launch: its flow table and segmented batch, its
// readout mode (0 "all", 1 "hist", 2 "raw") and the first column of its
// rows in the launch's scratch z.
struct TableArgs {
  FlowArgs a;
  int mode;
  int col;
};

// An MLP packed back to back: weights row-major [d_in, d_out] per layer,
// then (separately) the biases of every layer.
struct MlpDims {
  int n_layers;
  int widths[RT_MAX_LAYERS + 1];
  int n_w;                // weight floats
  int n_b;                // bias floats
};

// A Seq/Par DAG of MLP classifiers (K6): its models' widths (weights and
// biases packed back to back in model order) and its plan, a postfix
// program of n_ops (op, arg) pairs: DAG_MODEL i pushes model i's verdict;
// DAG_SEQ n, DAG_OR n and DAG_AND n pop n verdicts and push their fold.
enum { DAG_MODEL = 0, DAG_SEQ = 1, DAG_OR = 2, DAG_AND = 3 };

struct DagArgs {
  int n_models, n_ops, n_feat;
  MlpDims m[RT_DAG_MAX_MODELS];
  int op[RT_DAG_MAX_OPS];
  int arg[RT_DAG_MAX_OPS];
};

// A MAT classifier (Quantize -> LUTGather -> Reduce -> LabelMap): edges
// [F, E] sorted rows, tables [F, E + 1, C], label map [L] int (L >= C).
struct MatDims {
  int F, E, C, use_min;
};

// A centroid classifier ([FeatureSelect] -> CentroidDistance -> Reduce ->
// LabelMap): centroids [K, D]; ``n_sel`` = D with a feature index [D]
// into the readout row, 0 without one; label map [L] int (L >= K).
struct CentDims {
  int K, D, n_sel, use_min;
};

// K1's classifier: ``kind`` 0 = MLP (w, b), 1 = MAT (edges, tables,
// lmap), 2 = centroid (cent, fidx, lmap).
struct SuffixArgs {
  int kind;
  MlpDims mlp;
  MatDims mat;
  CentDims cent;
  const float* p0;        // MLP weights | MAT edges | centroids
  const float* p1;        // MLP biases | MAT tables
  const int* fidx;        // centroid feature index (n_sel entries)
  const int* lmap;        // MAT / centroid label map
};

// K1's folded action table and its own slot segmentation (the flow
// table's when both have the same slot count).  Updated in place.
struct MitArgs {
  int* keys;              // [Sm] stored keys, -1 = empty
  float* regs;            // [Sm, 2] [hits, since]
  const int* order;       // [B] arrival index of sorted position
  const int* seg_first;   // [B] per segment: first sorted position
  const int* seg_len;     // [B] per segment: packets (0 = no segment)
  const int* seg_slot;    // [B] per segment: action slot
  float threshold, keep_every;
  int attack_class, drop; // drop: 1 = "drop", 0 = "rate_limit"
};

// K7 flash attention: q [B, Sq, H, D], k and v [B, Skv, K, D] (H % K ==
// 0), o like q; keys at positions >= skv are masked; the query at row i
// sits at position q_offset + i.
struct FlashArgs {
  int B, Sq, Skv, H, K;
  int skv;
  int q_offset;
  int causal;             // 1: kv_pos <= q_pos
  int window;             // > 0: kv_pos > q_pos - window
  float scale;            // 1 / sqrt(D), rounded once from double
  // split-KV decode only: keys [kv_lo, kv_hi) in n_chunks chunks of
  // ``chunk`` keys (the last may be shorter); R = Sq * H / K rows
  int kv_lo, kv_hi, chunk, n_chunks;
  float* ws_acc;          // [B, K, n_chunks, R, D] partial acc
  float* ws_ml;           // [B, K, n_chunks, R, 2] partial (m, l)
};

// K8 selective scan: C [B, S, N], h0 and h_final [B, di, N], y [B, S,
// di]; N a power of two <= 32; the TPU interface takes dA and dBx [B, S,
// di, N], the discretizing entry dt [B, S, di], A [di, N], Bm [B, S, N]
// and x [B, S, di].
struct ScanArgs {
  int B, S, di, N;
};

// K8b: the gradient of the discretizing entry.  Inputs as K8's, plus
// ckpt [B, ceil(S / SSB_CHUNK(N)), di, N] (h entering each chunk, from
// K8's forward), dy [B, S, di] and dh_final [B, di, N] (null: zero);
// outputs ddt [B, S, di], dA [di, N], dBm and dC [B, S, N] f32, dx [B,
// S, di] in x's dtype and dh0 [B, di, N] (null: not wanted); ws_b and
// ws_c [di / SSB_CHANNELS(N) rounded up, B, S, N] and ws_a [B, di, N] are
// the caller's scratch for the partial sums.
struct ScanBwdArgs {
  const float* dt;
  const float* A;
  const float* Bm;
  const float* C;
  const void* x;
  const float* ckpt;
  const float* dy;
  const float* dh_final;
  float* ddt;
  float* dA;
  float* dBm;
  float* dC;
  void* dx;
  float* dh0;
  float* ws_b;
  float* ws_c;
  float* ws_a;
  int B, S, di, N;
};

cudaError_t launch_flow_update(const FlowArgs& a, float* feats,
                               cudaStream_t stream);
cudaError_t launch_fused_mlp_classify(const float* x, int B,
                                      const MlpDims& d, const float* w,
                                      const float* b, int* out,
                                      cudaStream_t stream);
cudaError_t launch_fused_mlp(const float* x, int B, const MlpDims& d,
                             const float* w, const float* b, float* out,
                             cudaStream_t stream);
cudaError_t launch_fused_dag(const float* x, int B, const DagArgs& g,
                             const float* w, const float* b, int* out,
                             cudaStream_t stream);
// K4: edges [F, ep], ep = E (E <= RT_MAT_SPLIT_EDGES) or E rounded up to
// 32 with +inf past E; each buffer's storage padded to 4 floats.
cudaError_t launch_mat_lut_classify(const float* x, int B, const MatDims& m,
                                    const float* edges, int ep,
                                    const float* tables, const int* lmap,
                                    int* out, cudaStream_t stream);
// K1: nt (1..RT_MAX_TABLES) tables over one batch, the post-update rows
// in the scratch z [B, zw] (table t's at its ``col``), the classifier row
// n_in wide; one cooperative launch, the action table (``mit`` not null)
// keyed by table 0's keys.
cudaError_t launch_fused_flow(const TableArgs* tables, int nt, float* z,
                              int zw, int n_in, const SuffixArgs& s,
                              int* verdicts, const MitArgs* mit,
                              cudaStream_t stream);
// K7: D in {16, 32, 64, 128}; bf16 1 takes __nv_bfloat16 operands, 0 f32.
// Sq <= FA_DECODE_MAX_SQ: the split-KV decode (two launches); longer:
// the tensor-core prefill (bf16) or the f32 CUDA-core prefill.
cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const FlashArgs& a, int D, int bf16,
                                   cudaStream_t stream);
cudaError_t launch_flash_prefill(const void* q, const void* k,
                                 const void* v, void* o, const FlashArgs& a,
                                 int D, cudaStream_t stream);
cudaError_t launch_flash_prefill_f32(const void* q, const void* k,
                                     const void* v, void* o,
                                     const FlashArgs& a, int D,
                                     cudaStream_t stream);
cudaError_t launch_flash_decode(const void* q, const void* k, const void* v,
                                void* o, const FlashArgs& a, int D, int bf16,
                                cudaStream_t stream);
// K7b, K7's backward: dq, dk, dv (each in its input's dtype) from q, k,
// v and dout; lse and delta are the caller's f32 scratch [B, H, Sq
// padded to FA_BWD_TILE].  Three launches (stats, dK/dV, dQ): bf16 on the
// tensor cores, f32 on the CUDA cores.
cudaError_t launch_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const FlashArgs& a,
                                       int D, int bf16, cudaStream_t stream);
// K8: y and h_out from the f32 inputs; N in {1, 2, 4, 8, 16, 32}.
cudaError_t launch_selective_scan(const float* dA, const float* dBx,
                                  const float* C, const float* h0, float* y,
                                  float* h_out, const ScanArgs& a,
                                  cudaStream_t stream);
// K8's discretizing entry: dA = expf(dt * A) and dBx = dt * Bm * x formed
// in registers; x f32 (x_bf16 0) or __nv_bfloat16 (1), the rest f32.
cudaError_t launch_selective_scan_discretized(
    const float* dt, const float* A, const float* Bm, const float* C,
    const void* x, int x_bf16, const float* h0, float* y, float* h_out,
    const ScanArgs& a, cudaStream_t stream);
// The same under autograd: also h entering every chunk of SSB_CHUNK(N)
// steps into ckpt [B, ceil(S / SSB_CHUNK(N)), di, N] (chunk 0's is h0).
cudaError_t launch_selective_scan_discretized_ckpt(
    const float* dt, const float* A, const float* Bm, const float* C,
    const void* x, int x_bf16, const float* h0, float* y, float* h_out,
    float* ckpt, const ScanArgs& a, cudaStream_t stream);
// K8b: two launches, the backward walk (partial sums into the scratch)
// and the fixed-order sum of the partials; x_bf16 as K8's.
cudaError_t launch_selective_scan_bwd(const ScanBwdArgs& a, int x_bf16,
                                      cudaStream_t stream);
// K9: out [B, N] int32 = sign(x) @ sign(w); x [B, K] and w [K, N] each
// f32 (0) or bf16 (1); xs [B, Kp] and wt [N, Kp] int8 are the caller's
// scratch for the signs, Kp = K rounded up to BG_KTILE.
cudaError_t launch_binarized_gemm(const void* x, int x_bf16, const void* w,
                                  int w_bf16, int8_t* xs, int8_t* wt,
                                  int* out, int B, int K, int N,
                                  cudaStream_t stream);
