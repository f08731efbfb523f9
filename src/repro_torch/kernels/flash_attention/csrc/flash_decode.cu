// K7's split-KV decode (Sq <= FA_DECODE_MAX_SQ), one template over the
// element type T, bf16 or f32 (see flash_attention.cu for what K7
// replaces and the numbers it keeps).
//
// Bound: bytes.  Each live key brings 2 * sizeof(T) * D bytes of K and V
// for 4 * G * Sq * D operations, far below the card's operations per
// byte, so the least time is the live K/V rows (plus Q and O) over 3.35
// TB/s.
//
// Design.  The products stay on the CUDA cores; the design is about
// bytes and parallelism.  The wrapper splits the live keys [kv_lo,
// kv_hi) (the causal and window limits of the call's rows, not the cache
// length) into n_chunks chunks, enough to put about two blocks on every
// SM.  fa_decode_kernel: one block of 4 warps per (chunk, kv head, batch)
// computes all R = Sq * G query rows of the GQA group (up to
// FA_DECODE_ROWS a block) from one read of its K/V chunk, streamed in
// 32-key tiles through two shared-memory stages by 16-byte cp.async
// copies (8 bf16 or 4 floats each).  Scores: lane j takes key j of the
// tile for the warp's rows (rows w, w + 4, ...), each one f32 FMA chain
// over d in ascending order, reading its K row from shared memory (rows
// padded by 16 bytes, free of bank conflicts) and the q rows, in f32, as
// broadcasts; the online softmax of the TPU kernel runs per row with
// warp shuffles.  The product with V: each thread takes a column pair of
// some rows, p from shared memory.  The block writes its partial (m, l,
// acc) to the wrapper's workspace.  fa_combine_kernel merges a group's
// chunks with the same expressions (alpha_c = exp(m_c - m), l = sum l_c
// alpha_c, acc = sum acc_c alpha_c) and writes acc / max(l, 1e-30) in T.
// Keys past a chunk's end take no part (p = 0); masked keys inside it
// take NEG_INF as in the TPU kernel.  An f32 call keeps every value in
// f32, so it holds the f32 reference within 1e-5.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "rt_types.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DC_THREADS = 128;
constexpr int DC_TK = FA_DECODE_TILE;      // keys per tile: one a lane
constexpr int DC_ROWS = FA_DECODE_ROWS;    // query rows per block
constexpr int DC_PST = DC_TK + 1;          // P row in shared memory

// shared memory of a block holding nrb query rows
template <typename T, int D>
size_t decode_smem(int nrb) {
  return sizeof(T) * 2 * DC_TK * (D + fa::Elem<T>::PER16 + D) +
         sizeof(float) * nrb * (D + DC_PST + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(DC_THREADS)
    fa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, FlashArgs a) {
  constexpr int EPC = fa::Elem<T>::PER16;  // elements per 16-byte chunk
  constexpr int KST = D + EPC;             // K row, padded by 16 bytes
  constexpr int CH = D / EPC;              // 16-byte chunks per row
  constexpr int RPW = DC_ROWS / 4;         // score rows per warp
  constexpr int PAIRS = D / 2;
  constexpr int NRG = DC_THREADS / PAIRS;  // row groups of the P V phase
  constexpr int RPT = DC_ROWS / NRG;       // rows per thread there
  extern __shared__ __align__(16) unsigned char dc_smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = a.H / a.K;
  const int R = a.Sq * G;
  const int n_rg = (R + DC_ROWS - 1) / DC_ROWS;
  const int nrb = min(R, DC_ROWS);         // rows the smem is sized for
  const int kvh = blockIdx.y / n_rg;
  const int r0 = (blockIdx.y % n_rg) * DC_ROWS;
  const int nr = min(R - r0, DC_ROWS);     // this block's rows
  const int b = blockIdx.z;
  const int c = blockIdx.x;
  const int c_lo = a.kv_lo + c * a.chunk;
  const int c_hi = min(c_lo + a.chunk, a.kv_hi);

  T* Ks = reinterpret_cast<T*>(dc_smem);        // [2][TK][KST]
  T* Vs = Ks + 2 * DC_TK * KST;                 // [2][TK][D]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * DC_TK * D);  // [nrb][D]
  float* Ps = Qs + nrb * D;                     // [nrb][PST]
  float* As = Ps + nrb * DC_PST;                // [nrb]

  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const T* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  auto load = [&](int k0, int s) {
    for (int i = tid; i < DC_TK * CH; i += DC_THREADS) {
      const int r = i / CH, cc = i % CH, key = k0 + r;
      const bool ok = key < c_hi;
      const size_t off = (size_t)(ok ? key : c_lo) * kv_rs + cc * EPC;
      fa::cp_async16(fa::smem_u32(Ks + (s * DC_TK + r) * KST + cc * EPC),
                     kb + off, ok);
      fa::cp_async16(fa::smem_u32(Vs + (s * DC_TK + r) * D + cc * EPC),
                     vb + off, ok);
    }
  };
  const int nt = (c_hi - c_lo + DC_TK - 1) / DC_TK;
  load(c_lo, 0);
  fa::cp_commit();

  // the block's query rows in f32: row r is (sq, g) = (r / G, r % G)
  for (int i = tid; i < nr * CH; i += DC_THREADS) {
    const int r = i / CH, cc = i % CH;
    const int sq = (r0 + r) / G, hh = kvh * G + (r0 + r) % G;
    const uint4 x = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * a.Sq + sq) * q_rs + (size_t)hh * D + cc * EPC);
    fa::Elem<T>::unpack(x, Qs + r * D + cc * EPC);
  }

  float m[RPW], l[RPW];                    // rows warp + 4 i
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = fa::NEG_INF;
    l[i] = 0.f;
  }
  const int cp = tid % PAIRS;              // P V: column pair
  const int prg = tid / PAIRS;             // and rows prg + NRG i
  float acc[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int s = t & 1;
    const int k0 = c_lo + t * DC_TK;
    if (t + 1 < nt) {
      load(k0 + DC_TK, s ^ 1);
      fa::cp_commit();
      fa::cp_wait<1>();
    } else {
      fa::cp_wait<0>();
    }
    __syncthreads();

    // scores: lane j takes key k0 + j
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
    const T* kr = Ks + (s * DC_TK + lane) * KST;
#pragma unroll 4
    for (int dc = 0; dc < CH; ++dc) {
      float kf[EPC];
      fa::Elem<T>::unpack(*reinterpret_cast<const uint4*>(kr + dc * EPC),
                          kf);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + 4 * i;
        if (r >= nr) break;
        float x = sc[i];
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qv = *reinterpret_cast<const float4*>(
              Qs + r * D + dc * EPC + 4 * e4);
          x = fmaf(qv.x, kf[4 * e4], x);
          x = fmaf(qv.y, kf[4 * e4 + 1], x);
          x = fmaf(qv.z, kf[4 * e4 + 2], x);
          x = fmaf(qv.w, kf[4 * e4 + 3], x);
        }
        sc[i] = x;
      }
    }
    const int key = k0 + lane;
    const bool in = key < c_hi;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + 4 * i;
      if (r >= nr) break;
      const int q_pos = a.q_offset + (r0 + r) / G;
      bool ok = in;                        // c_hi <= kv_hi <= skv
      if (a.causal) ok = ok && key <= q_pos;
      if (a.window > 0) ok = ok && key > q_pos - a.window;
      const float sv = ok ? sc[i] * a.scale : fa::NEG_INF;
      const float m_new = fmaxf(m[i], fa::warp_max(sv));
      const float alpha = expf(m[i] - m_new);
      const float p = in ? expf(sv - m_new) : 0.f;
      l[i] = l[i] * alpha + fa::warp_sum(p);
      m[i] = m_new;
      Ps[r * DC_PST + lane] = p;
      if (lane == 0) As[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
    const T* vt = Vs + s * DC_TK * D + 2 * cp;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = prg + NRG * i;
      if (r >= nr) break;
      acc[i][0] *= As[r];
      acc[i][1] *= As[r];
    }
#pragma unroll 4
    for (int j = 0; j < DC_TK; ++j) {
      const float2 vv = fa::Elem<T>::load2(vt + j * D);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = prg + NRG * i;
        if (r >= nr) break;
        const float p = Ps[r * DC_PST + j];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
      }
    }
    __syncthreads();                       // the stage and P are free
  }

  const size_t part = ((size_t)b * a.K + kvh) * a.n_chunks + c;
  float* ml = a.ws_ml + part * R * 2;
  float* wacc = a.ws_acc + part * R * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 4 * i;
    if (r >= nr) break;
    if (lane == 0) {
      ml[(r0 + r) * 2] = m[i];
      ml[(r0 + r) * 2 + 1] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = prg + NRG * i;
    if (r >= nr) break;
    *reinterpret_cast<float2*>(wacc + (size_t)(r0 + r) * D + 2 * cp) =
        make_float2(acc[i][0], acc[i][1]);
  }
}

// one thread per output element (row r, column d) of a (kv head, batch)
template <typename T, int D>
__global__ void __launch_bounds__(DC_THREADS)
    fa_combine_kernel(T* __restrict__ o, FlashArgs a) {
  const int G = a.H / a.K;
  const int R = a.Sq * G;
  const int idx = blockIdx.x * DC_THREADS + threadIdx.x;
  if (idx >= R * D) return;
  const int r = idx / D, d = idx % D;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const size_t part = ((size_t)b * a.K + kvh) * a.n_chunks;
  const float* ml = a.ws_ml + part * R * 2 + r * 2;
  const float* wacc = a.ws_acc + part * R * D + (size_t)r * D + d;
  float mx = fa::NEG_INF;
  for (int c = 0; c < a.n_chunks; ++c) mx = fmaxf(mx, ml[(size_t)c * R * 2]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const float alpha = expf(ml[(size_t)c * R * 2] - mx);
    l += ml[(size_t)c * R * 2 + 1] * alpha;
    acc += wacc[(size_t)c * R * D] * alpha;
  }
  o[((size_t)b * a.Sq + r / G) * a.H * D + (size_t)(kvh * G + r % G) * D +
    d] = fa::Elem<T>::from_float(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          void* o, const FlashArgs& a, cudaStream_t stream) {
  const int R = a.Sq * (a.H / a.K);
  const int n_rg = (R + DC_ROWS - 1) / DC_ROWS;
  const size_t smem = decode_smem<T, D>(R < DC_ROWS ? R : DC_ROWS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fa_decode_kernel<T, D>
      <<<dim3(a.n_chunks, a.K * n_rg, a.B), DC_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fa_combine_kernel<T, D>
      <<<dim3((R * D + DC_THREADS - 1) / DC_THREADS, a.K, a.B), DC_THREADS,
         0, stream>>>(static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_t(const void* q, const void* k, const void* v,
                            void* o, const FlashArgs& a, int D,
                            cudaStream_t stream) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, o, a, stream);
    case 32: return launch_decode<T, 32>(q, k, v, o, a, stream);
    case 64: return launch_decode<T, 64>(q, k, v, o, a, stream);
    case 128: return launch_decode<T, 128>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_flash_decode(const void* q, const void* k, const void* v,
                                void* o, const FlashArgs& a, int D, int bf16,
                                cudaStream_t stream) {
  return bf16 ? launch_decode_t<__nv_bfloat16>(q, k, v, o, a, D, stream)
              : launch_decode_t<float>(q, k, v, o, a, D, stream);
}
