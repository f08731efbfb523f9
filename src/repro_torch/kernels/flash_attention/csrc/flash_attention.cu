// K7 flash_attention: online-softmax attention with causal masking, a
// sliding window, GQA and a q position offset; f32 accumulation, the
// output in q's dtype (bf16 or f32).  Three designs, chosen by dtype and
// by Sq alone (launch_flash_attention below):
//
//   bf16, Sq > FA_DECODE_MAX_SQ: fa_prefill_kernel (flash_prefill.cu),
//     P V on the tensor cores (wgmma), the scores on the CUDA cores;
//   bf16, Sq <= FA_DECODE_MAX_SQ: fa_decode_kernel + fa_combine_kernel
//     (flash_decode.cu), a split-KV decode on the CUDA cores;
//   f32: fa_simt_kernel (this file), f32 FMAs on the CUDA cores.
//
// All three replace the TPU kernel repro/kernels/flash_attention/
// kernel.py:35 (_flash_kernel, launched by flash_attention_padded :113),
// which computes what models/attention.chunked_attention computes.  The
// port's LM path runs K7 for prefill (q_offset 0) and for every decode
// step (Sq = 1, q_offset = the cache index, skv = the cache length) of
// every layer.  Its expressions fix the numbers in every kernel: the
// scale after the dot (computed once on the host in double), the finite
// NEG_INF, the element masks kv_pos < skv, kv_pos <= q_pos and kv_pos >
// q_pos - window, alpha = exp(m_prev - m_new), acc / max(l, 1e-30), expf
// (no fast math).  Ragged q rows and kv rows past skv are masked in the
// kernels, so the wrapper pads nothing.
//
// Bounds.  Prefill is bound by bytes at 512 tokens and by operations at
// 2,048 (4 * D per live (q, kv) pair per head over 989 TFLOP/s of bf16
// tensor cores); its design puts P V on wgmma, runs the scores as f32
// FMA chains in the reference's order (the tensor cores' sums are too
// coarse for them; see flash_prefill.cu) and overlaps the next K/V
// tile's load with this one's products.  Decode is bound by bytes: each
// live key brings 4 * D bytes of K and V for 4 * G * D operations, far
// below the card's 295 operations per byte, over 3.35 TB/s; its design
// reads each live K/V row once per GQA group, with enough chunks to fill
// the SMs.
// f32 operands (the int8-cache configs and the f32 Jamba run, which the
// models cast to f32) keep the SIMT kernel: its 1e-5 parity cannot hold
// through bf16 tensor cores.
//
// The SIMT kernel.  One block of 4 warps per (64-row q tile, q head,
// batch); a loop inside the block over 32-row kv tiles takes the place
// of the TPU's sequential innermost grid dimension.  The q tile and each
// K/V tile are staged in shared memory (K rows padded by one float so
// that lane j reading row j is free of bank conflicts).  Each warp owns
// 16 q rows: for the scores lane j takes kv column j of every row; the
// row max and sum are warp shuffles; the probabilities go through shared
// memory and for the product with V each lane takes the output columns
// lane + 32 c.  The running (m, l, acc) stay in registers.  The kv head
// is h / (H / K).  A kv tile is skipped with the TPU kernel's predicates
// (causal: k_lo > q_hi; window: k_hi <= q_lo - window, over the block's
// real rows).  Rows past Sq in a warp are skipped.

#include "flash_common.cuh"
#include "rt_types.h"

namespace {

constexpr int FA_BQ = 64;                  // q rows per block
constexpr int FA_BK = 32;                  // kv rows per tile: one a lane
constexpr int FA_WARPS = 4;
constexpr int FA_RPW = FA_BQ / FA_WARPS;   // q rows per warp

template <int D>
constexpr size_t fa_smem_floats() {
  // Qs [BQ][D], Ks [BK][D + 1], Vs [BK][D], Ps [BQ][BK]
  return FA_BQ * D + FA_BK * (D + 1) + FA_BK * D + FA_BQ * FA_BK;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int D>
__global__ void __launch_bounds__(FA_WARPS * 32)
    fa_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   FlashArgs a) {
  constexpr int DPL = (D + 31) / 32;       // output columns per lane
  constexpr int KST = D + 1;               // padded K row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * D;
  float* Vs = Ks + FA_BK * KST;
  float* Ps = Vs + FA_BK * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * FA_BQ;     // the block's first q row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;     // q / o row stride
  const size_t kv_rs = (size_t)a.K * D;    // k / v row stride
  const float* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const float* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const float* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  for (int i = tid; i < FA_BQ * D / 2; i += FA_WARPS * 32) {
    const int r = (2 * i) / D;
    const int d = (2 * i) % D;
    float2 x = make_float2(0.f, 0.f);
    if (row0 + r < a.Sq) x = load2(qb + (size_t)(row0 + r) * q_rs + d);
    Qs[r * D + d] = x.x;
    Qs[r * D + d + 1] = x.y;
  }

  const int wrow = warp * FA_RPW;          // the warp's first row
  const int nr = min(max(a.Sq - row0 - wrow, 0), FA_RPW);  // real rows
  float acc[FA_RPW][DPL];
  float m[FA_RPW];
  float l[FA_RPW];
#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    m[r] = fa::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + FA_BQ) - 1;
  const int n_tiles = (a.skv + FA_BK - 1) / FA_BK;
  const float* qw = Qs + wrow * D;
  float* pw = Ps + wrow * FA_BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = t * FA_BK;
    const int k_hi = k_lo + FA_BK - 1;
    if (a.causal && k_lo > q_hi) break;    // so is every later tile
    if (a.window > 0 && k_hi <= q_lo - a.window) continue;
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < FA_BK * D / 2; i += FA_WARPS * 32) {
      const int r = (2 * i) / D;
      const int d = (2 * i) % D;
      float2 kx = make_float2(0.f, 0.f);
      float2 vx = kx;
      if (k_lo + r < a.skv) {
        kx = load2(kb + (size_t)(k_lo + r) * kv_rs + d);
        vx = load2(vb + (size_t)(k_lo + r) * kv_rs + d);
      }
      Ks[r * KST + d] = kx.x;
      Ks[r * KST + d + 1] = kx.y;
      Vs[r * D + d] = vx.x;
      Vs[r * D + d + 1] = vx.y;
    }
    __syncthreads();
    if (nr == 0) continue;

    // scores: lane j takes kv column j of every row
    float s[FA_RPW];
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * KST;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < FA_RPW; ++r)
        if (r < nr) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }

    // masks and the online softmax, row by row
    const int kv_pos = k_lo + lane;
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) {
      if (r < nr) {
        const int q_pos = q_lo + wrow + r;
        bool ok = kv_pos < a.skv;
        if (a.causal) ok = ok && kv_pos <= q_pos;
        if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
        const float sv = ok ? s[r] * a.scale : fa::NEG_INF;
        const float m_new = fmaxf(m[r], fa::warp_max(sv));
        const float alpha = expf(m[r] - m_new);
        const float p = expf(sv - m_new);
        l[r] = l[r] * alpha + fa::warp_sum(p);
        m[r] = m_new;
        pw[r * FA_BK + lane] = p;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      }
    }
    __syncwarp();

    // acc += P V: lane takes output columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < FA_BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < FA_RPW; ++r) {
        if (r < nr) {
          const float p = pw[r * FA_BK + j];
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    if (r < nr) {
      const float den = fmaxf(l[r], 1e-30f);
      float* orow = o + ((size_t)b * a.Sq + row0 + wrow + r) * q_rs +
                    (size_t)h * D;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < D) orow[d] = acc[r][c] / den;
      }
    }
  }
}

template <int D>
cudaError_t launch_fa_simt(const void* q, const void* k, const void* v,
                           void* o, const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fa_smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + FA_BQ - 1) / FA_BQ, a.H, a.B);
  fa_simt_kernel<D><<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o,
                                   const FlashArgs& a, int D, int bf16,
                                   cudaStream_t stream) {
  if (a.B == 0 || a.Sq == 0) return cudaSuccess;
  if (bf16)
    return a.Sq <= FA_DECODE_MAX_SQ
               ? launch_flash_decode(q, k, v, o, a, D, stream)
               : launch_flash_prefill(q, k, v, o, a, D, stream);
  switch (D) {
    case 16: return launch_fa_simt<16>(q, k, v, o, a, stream);
    case 32: return launch_fa_simt<32>(q, k, v, o, a, stream);
    case 64: return launch_fa_simt<64>(q, k, v, o, a, stream);
    case 128: return launch_fa_simt<128>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}
