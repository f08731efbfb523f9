// K7b flash_attention_bwd: the gradient of K7's forward (dq, dk, dv from
// q, k, v and dO), exactly the function whose gradient autograd takes
// through ref.attention_ref: the same masks (kv_pos < skv; with causal
// kv_pos <= q_pos; with a window kv_pos > q_pos - window), GQA with H %
// K == 0, the scale after the dot, f32 accumulation, each gradient in
// its input's dtype (bf16 or f32).  A row whose keys are all masked (only
// a window past skv makes one) behaves as attention_ref's autograd does:
// its softmax is uniform over the skv keys, so dv takes 1 / skv of its dO
// and dq and dk take nothing (the mask's where blocks them).
//
// It replaces no TPU kernel: repro/kernels/flash_attention/kernel.py:35
// (_flash_kernel) has no VJP, and the JAX package trains through XLA's
// gradient of models/attention.chunked_attention.  The port's training
// path runs K7 forward, so it needs K7's backward; a plain-PyTorch one
// would hold [B, H, S, S] scores per layer.
//
// Bound.  Five products of 2 * D operations per live (q, kv) pair per head
// (S = Q K^T recomputed, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ +=
// dS K), over 989 TFLOP/s for bf16 or 67 TFLOP/s for f32; or the bytes of
// q, k, v, dO read once and dq, dk, dv written once over 3.35 TB/s.  At
// the training shapes the operations bind.
//
// Design (a simple first kernel: every product an f32 FMA chain on the
// CUDA cores, no tensor core, no atomics, so repeated calls are bit for
// bit the same).  Three launches of 256-thread blocks; every tile is 64
// rows, staged in dynamic shared memory as f32 (bf16 converted on load),
// its 16-byte chunks XOR-swizzled by row so that both product shapes
// below read free of bank conflicts:
//   1. stats, one block per (64-row q tile, q head, batch): K7's online
//      softmax over the live key tiles, O recomputed in f32, then per
//      row lse = m + log(l) and delta = sum_d dO * O (the f32 O: the
//      rounded output would put its rounding into delta); +inf and 0 for
//      a fully masked row, so that its p below is 0.
//   2. dK/dV, one block per (64-key tile, kv head, batch): for each q
//      head of the group and each q tile that can see the keys, P =
//      exp(s - lse) and dS = P * (dP - delta) recomputed, dV += P^T dO and
//      dK += dS^T Q in registers; dK scaled once at the end.  The group
//      is summed inside the block, so no two blocks write one key.
//   3. dQ, one block per (64-row q tile, q head, batch): dQ += dS K over
//      the live key tiles, scaled once at the end.
// Scores are thread-tiled 4 x 4 (rows 4 ty + i, columns tx + 16 j), each
// one FMA chain over d in ascending order as in K7's kernels; the
// accumulating products give each thread RPT rows by 4 * CPT columns.
// Whole tiles outside the masks are skipped by bounding the loops with
// the forward's predicates; ragged rows are zero-filled and masked.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "rt_types.h"

namespace {

constexpr int BT = 64;        // rows of every tile (q rows or keys)
constexpr int NT = 256;       // threads per block

// float offset of (row r, column col) in a [rows][W] f32 tile whose
// 16-byte chunks are XOR-permuted by row (as flash_prefill_f32.cu's)
template <int W>
__device__ __forceinline__ int sw(int r, int col) {
  constexpr int CH = W / 4;
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  constexpr int SH = CH < 8 ? 1 : 0;
  return r * W + ((((col >> 2) ^ ((r >> SH) & MASK))) << 2) + (col & 3);
}

// four consecutive elements of an operand as floats, and back
template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// the accumulating products' layout: NCG column groups of 16-byte chunks
// (CPT chunks a thread, NCG apart), NRG row groups of RPT rows
template <int D>
struct Lay {
  static constexpr int CH = D / 4;
  static constexpr int NCG = CH < 16 ? CH : 16;
  static constexpr int CPT = CH / NCG;
  static constexpr int NRG = NT / NCG;
  static constexpr int RPT = BT / NRG;
};

// rows [row0, row0 + 64) of a [rows][rs] operand (rows >= n zero-filled)
// into a swizzled f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t rs, int row0, int n) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < BT * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) x = Io<T>::load4(src + (size_t)(row0 + r) * rs + 4 * c);
    *reinterpret_cast<float4*>(dst + sw<D>(r, 4 * c)) = x;
  }
}

// s[i][j] = sum_d A[4 ty + i][d] * Bm[tx + 16 j][d], one FMA chain over d
// in ascending order
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int dc = 0; dc < D / 4; ++dc) {
    float4 bb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(Bm + sw<D>(tx + 16 * j, 4 * dc));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 aa =
          *reinterpret_cast<const float4*>(A + sw<D>(4 * ty + i, 4 * dc));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(aa.x, bb[j].x, x);
        x = fmaf(aa.y, bb[j].y, x);
        x = fmaf(aa.z, bb[j].z, x);
        s[i][j] = fmaf(aa.w, bb[j].w, x);
      }
    }
  }
}

// the 4 x 4 thread tile s (rows 4 ty + i, columns tx + 16 j) into a
// swizzled [64 columns][64 rows] tile: column-major for tile_acc
__device__ __forceinline__ void store_t(float* P, int ty, int tx,
                                        const float s[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(P + sw<BT>(tx + 16 * j, 4 * ty)) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// acc[i][4 e + c] += sum_j P[j][RPT cy + i] * X[j][4 (cx + NCG e) + c]
// over j = 0..63 in ascending order; P [64][64] and X [64][D] swizzled
template <int D>
__device__ __forceinline__ void tile_acc(
    const float* P, const float* X, int cx, int cy,
    float (&acc)[Lay<D>::RPT][4 * Lay<D>::CPT]) {
  using L = Lay<D>;
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    float pr[L::RPT];
    if constexpr (L::RPT == 4) {
      const float4 x = *reinterpret_cast<const float4*>(P + sw<BT>(j, 4 * cy));
      pr[0] = x.x;
      pr[1] = x.y;
      pr[2] = x.z;
      pr[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) pr[i] = P[sw<BT>(j, L::RPT * cy + i)];
    }
#pragma unroll
    for (int e = 0; e < L::CPT; ++e) {
      const float4 xv =
          *reinterpret_cast<const float4*>(X + sw<D>(j, 4 * (cx + L::NCG * e)));
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        acc[i][4 * e] = fmaf(pr[i], xv.x, acc[i][4 * e]);
        acc[i][4 * e + 1] = fmaf(pr[i], xv.y, acc[i][4 * e + 1]);
        acc[i][4 * e + 2] = fmaf(pr[i], xv.z, acc[i][4 * e + 2]);
        acc[i][4 * e + 3] = fmaf(pr[i], xv.w, acc[i][4 * e + 3]);
      }
    }
  }
}

__device__ __forceinline__ bool live(const FlashArgs& a, int q_pos,
                                     int kv_pos) {
  bool ok = kv_pos < a.skv;
  if (a.causal) ok = ok && kv_pos <= q_pos;
  if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
  return ok;
}

// every key of the row at q_pos is masked: only a window past skv does it
__device__ __forceinline__ bool fully_masked(const FlashArgs& a, int q_pos) {
  return a.window > 0 && q_pos >= a.skv + a.window - 1;
}

// the key tiles [t0, t1) some row of q rows [row0, row0 + 64) may attend
__device__ __forceinline__ void key_tiles(const FlashArgs& a, int row0,
                                          int& t0, int& t1) {
  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + BT) - 1;
  t0 = a.window > 0 ? max(q_lo - a.window + 1, 0) / BT : 0;
  t1 = ((a.causal ? min(a.skv, q_hi + 1) : a.skv) + BT - 1) / BT;
}

template <int D>
struct Smem {
  static constexpr int TILE = BT * D;
  // stats: Q, K, V, P^T, alpha, m, l
  static constexpr size_t STATS = sizeof(float) * (3 * TILE + BT * BT + 3 * BT);
  // dK/dV: K, V, Q, dO, P, dS, lse, delta
  static constexpr size_t DKDV = sizeof(float) * (4 * TILE + 2 * BT * BT + 2 * BT);
  // dQ: Q, dO, K, V, dS, lse, delta
  static constexpr size_t DQ = sizeof(float) * (4 * TILE + BT * BT + 2 * BT);
};

// pass 1: lse and delta of every q row, [B, H, Sq] each
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        float* __restrict__ lse, float* __restrict__ delta,
                        FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Qs = fb_smem;
  float* Ks = Qs + BT * D;
  float* Vs = Ks + BT * D;
  float* Ps = Vs + BT * D;
  float* As = Ps + BT * BT;
  float* Ms = As + BT;
  float* Ls = Ms + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int row0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const T* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const int q_lo = a.q_offset + row0;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  load_tile<T, D>(Qs, qb, q_rs, row0, a.Sq);
  float acc[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fa::NEG_INF;
    l[i] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    __syncthreads();                       // the last tile is read
    load_tile<T, D>(Ks, kb, kv_rs, t * BT, a.skv);
    load_tile<T, D>(Vs, vb, kv_rs, t * BT, a.skv);
    __syncthreads();
    float s[4][4];
    tile_dots<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + 4 * ty + i;
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = s[i][j] * a.scale;
        s[i][j] = live(a, q_pos, t * BT + tx + 16 * j) ? sv : fa::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tx == 0) As[4 * ty + i] = alpha;
    }
    store_t(Ps, ty, tx, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::RPT; ++i) {
      const float al = As[L::RPT * cy + i];
#pragma unroll
      for (int c = 0; c < 4 * L::CPT; ++c) acc[i][c] *= al;
    }
    tile_acc<D>(Ps, Vs, cx, cy, acc);
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ms[4 * ty + i] = m[i];
      Ls[4 * ty + i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int rr = L::RPT * cy + i;
    const int r = row0 + rr;
    const float den = fmaxf(Ls[rr], 1e-30f);
    float part = 0.f;
    if (r < a.Sq) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e) {
        const float4 g =
            Io<T>::load4(ob + (size_t)r * q_rs + 4 * (cx + L::NCG * e));
        part = fmaf(g.x, acc[i][4 * e] / den, part);
        part = fmaf(g.y, acc[i][4 * e + 1] / den, part);
        part = fmaf(g.z, acc[i][4 * e + 2] / den, part);
        part = fmaf(g.w, acc[i][4 * e + 3] / den, part);
      }
    }
#pragma unroll
    for (int w = 1; w < L::NCG; w <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, w);
    if (cx == 0 && r < a.Sq) {
      const bool fm = fully_masked(a, a.q_offset + r);
      const size_t at = ((size_t)b * a.H + h) * a.Sq + r;
      lse[at] = fm ? INFINITY : Ms[rr] + logf(Ls[rr]);
      delta[at] = fm ? 0.f : part;
    }
  }
}

// pass 2: dk and dv of one 64-key tile of one kv head, the group summed
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Ks = fb_smem;
  float* Vs = Ks + BT * D;
  float* Qs = Vs + BT * D;
  float* Os = Qs + BT * D;
  float* Ps = Os + BT * D;
  float* Ss = Ps + BT * BT;
  float* Lr = Ss + BT * BT;
  float* Dr = Lr + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int key0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.K;
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const size_t kv_at = (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  float dva[L::RPT][4 * L::CPT], dka[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) dva[i][c] = dka[i][c] = 0.f;

  if (key0 < a.skv) {
    load_tile<T, D>(Ks, k + kv_at, kv_rs, key0, a.skv);
    load_tile<T, D>(Vs, v + kv_at, kv_rs, key0, a.skv);
    // the q rows that may see a key of this tile
    const int k_hi = min(key0 + BT, a.skv) - 1;
    const int r_lo = a.causal ? max(key0 - a.q_offset, 0) : 0;
    const int r_hi = a.window > 0
                         ? min(a.Sq - 1, k_hi + a.window - 1 - a.q_offset)
                         : a.Sq - 1;
    const int qt0 = r_lo / BT;
    const int qt1 = r_lo <= r_hi ? r_hi / BT + 1 : qt0;
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const T* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
      const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)h * D;
      const size_t st = ((size_t)b * a.H + h) * a.Sq;
      for (int qt = qt0; qt < qt1; ++qt) {
        const int row0 = qt * BT;
        __syncthreads();                   // the last tiles are read
        load_tile<T, D>(Qs, qb, q_rs, row0, a.Sq);
        load_tile<T, D>(Os, ob, q_rs, row0, a.Sq);
        if (tid < BT) {
          const int r = row0 + tid;
          Lr[tid] = r < a.Sq ? lse[st + r] : INFINITY;
          Dr[tid] = r < a.Sq ? delta[st + r] : 0.f;
        }
        __syncthreads();
        // s^T and dP^T: keys 4 ty + i, rows tx + 16 j
        float s[4][4], dp[4][4];
        tile_dots<D>(Ks, Qs, ty, tx, s);
        tile_dots<D>(Vs, Os, ty, tx, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kv_pos = key0 + 4 * ty + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = tx + 16 * j;
            const float p = live(a, a.q_offset + row0 + rr, kv_pos)
                                ? expf(s[i][j] * a.scale - Lr[rr])
                                : 0.f;
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - Dr[rr]);
          }
        }
        store_t(Ps, ty, tx, s);            // [row][key]
        store_t(Ss, ty, tx, dp);
        __syncthreads();
        tile_acc<D>(Ps, Os, cx, cy, dva);  // dV[t] += sum_r P[r][t] dO[r]
        tile_acc<D>(Ss, Qs, cx, cy, dka);  // dK[t] += sum_r dS[r][t] Q[r]
      }
    }
    // the fully masked rows' uniform softmax: dv[t] += sum of their dO /
    // skv for every key t < skv
    const int r_fm =
        a.window > 0 ? min(max(a.skv + a.window - 1 - a.q_offset, 0), a.Sq)
                     : a.Sq;
    if (r_fm < a.Sq) {
      float u[4 * L::CPT];
#pragma unroll
      for (int c = 0; c < 4 * L::CPT; ++c) u[c] = 0.f;
      for (int g = 0; g < G; ++g) {
        const T* ob = dout + (size_t)b * a.Sq * q_rs + (size_t)(kvh * G + g) * D;
        for (int r = r_fm; r < a.Sq; ++r)
#pragma unroll
          for (int e = 0; e < L::CPT; ++e) {
            const float4 x =
                Io<T>::load4(ob + (size_t)r * q_rs + 4 * (cx + L::NCG * e));
            u[4 * e] += x.x;
            u[4 * e + 1] += x.y;
            u[4 * e + 2] += x.z;
            u[4 * e + 3] += x.w;
          }
      }
      const float inv = 1.f / (float)a.skv;
#pragma unroll
      for (int i = 0; i < L::RPT; ++i)
        if (key0 + L::RPT * cy + i < a.skv)
#pragma unroll
          for (int c = 0; c < 4 * L::CPT; ++c)
            dva[i][c] = fmaf(inv, u[c], dva[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int t = key0 + L::RPT * cy + i;
    if (t < a.Skv) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e) {
        const size_t at = kv_at + (size_t)t * kv_rs + 4 * (cx + L::NCG * e);
        Io<T>::store4(dk + at, make_float4(dka[i][4 * e] * a.scale,
                                           dka[i][4 * e + 1] * a.scale,
                                           dka[i][4 * e + 2] * a.scale,
                                           dka[i][4 * e + 3] * a.scale));
        Io<T>::store4(dv + at, make_float4(dva[i][4 * e], dva[i][4 * e + 1],
                                           dva[i][4 * e + 2],
                                           dva[i][4 * e + 3]));
      }
    }
  }
}

// pass 3: dq of one 64-row q tile of one q head
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     FlashArgs a) {
  using L = Lay<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Qs = fb_smem;
  float* Os = Qs + BT * D;
  float* Ks = Os + BT * D;
  float* Vs = Ks + BT * D;
  float* Ss = Vs + BT * D;
  float* Lr = Ss + BT * BT;
  float* Dr = Lr + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cx = tid % L::NCG, cy = tid / L::NCG;
  const int row0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const size_t q_at = (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const size_t st = ((size_t)b * a.H + h) * a.Sq;
  const int q_lo = a.q_offset + row0;
  int t0, t1;
  key_tiles(a, row0, t0, t1);

  load_tile<T, D>(Qs, q + q_at, q_rs, row0, a.Sq);
  load_tile<T, D>(Os, dout + q_at, q_rs, row0, a.Sq);
  if (tid < BT) {
    const int r = row0 + tid;
    Lr[tid] = r < a.Sq ? lse[st + r] : INFINITY;
    Dr[tid] = r < a.Sq ? delta[st + r] : 0.f;
  }
  float dqa[L::RPT][4 * L::CPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CPT; ++c) dqa[i][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();                       // the last tiles are read
    load_tile<T, D>(Ks, kb, kv_rs, t * BT, a.skv);
    load_tile<T, D>(Vs, vb, kv_rs, t * BT, a.skv);
    __syncthreads();
    // s and dP: rows 4 ty + i, keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<D>(Qs, Ks, ty, tx, s);
    tile_dots<D>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(a, q_lo + rr, t * BT + tx + 16 * j)
                            ? expf(s[i][j] * a.scale - Lr[rr])
                            : 0.f;
        dp[i][j] = p * (dp[i][j] - Dr[rr]);
      }
    }
    store_t(Ss, ty, tx, dp);               // [key][row]
    __syncthreads();
    tile_acc<D>(Ss, Ks, cx, cy, dqa);      // dQ[r] += sum_t dS[r][t] K[t]
  }

#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    const int r = row0 + L::RPT * cy + i;
    if (r < a.Sq) {
#pragma unroll
      for (int e = 0; e < L::CPT; ++e)
        Io<T>::store4(dq + q_at + (size_t)r * q_rs + 4 * (cx + L::NCG * e),
                      make_float4(dqa[i][4 * e] * a.scale,
                                  dqa[i][4 * e + 1] * a.scale,
                                  dqa[i][4 * e + 2] * a.scale,
                                  dqa[i][4 * e + 3] * a.scale));
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, float* lse, float* delta, void* dq,
                       void* dk, void* dv, const FlashArgs& a,
                       cudaStream_t stream) {
  using S = Smem<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t e;
  if ((e = allow_smem(fa_bwd_stats_kernel<T, D>, S::STATS)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dkdv_kernel<T, D>, S::DKDV)) != cudaSuccess)
    return e;
  if ((e = allow_smem(fa_bwd_dq_kernel<T, D>, S::DQ)) != cudaSuccess)
    return e;
  const dim3 qgrid((a.Sq + BT - 1) / BT, a.H, a.B);
  const dim3 kgrid((a.Skv + BT - 1) / BT, a.K, a.B);
  fa_bwd_stats_kernel<T, D><<<qgrid, NT, S::STATS, stream>>>(
      qt, kt, vt, ot, lse, delta, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dkdv_kernel<T, D><<<kgrid, NT, S::DKDV, stream>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fa_bwd_dq_kernel<T, D><<<qgrid, NT, S::DQ, stream>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_d(const void* q, const void* k, const void* v,
                         const void* dout, float* lse, float* delta,
                         void* dq, void* dk, void* dv, const FlashArgs& a,
                         int D, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                               stream);
    case 32:
      return launch_bwd<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                               stream);
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                               stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, a,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       float* lse, float* delta, void* dq,
                                       void* dk, void* dv, const FlashArgs& a,
                                       int D, int bf16, cudaStream_t stream) {
  if (a.B == 0 || a.Sq == 0) return cudaSuccess;
  return bf16 ? launch_bwd_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq,
                                            dk, dv, a, D, stream)
              : launch_bwd_d<float>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    a, D, stream);
}
