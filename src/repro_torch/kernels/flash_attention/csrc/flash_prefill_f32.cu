// K7's f32 prefill (f32 operands, Sq > FA_DECODE_MAX_SQ; see
// flash_attention.cu for what K7 replaces and the numbers it keeps).
//
// Bound: the larger of the bytes (Q, K, V and O once) over 3.35 TB/s and
// the operations (4 * D per live (q, kv) pair per head) over 67 TFLOP/s
// (f32 on the CUDA cores): operations at a 512-token prefill.  No tensor
// core: an f32 call holds the f32 reference within 1e-5, which bf16
// operands cannot, and TF32 stays off.
//
// Design.  One block of 4 warps (128 threads) owns 64 q rows of one (q
// head, batch); a loop over 64-row kv tiles takes the place of the TPU's
// sequential innermost grid dimension.  Q stays in shared memory for the
// whole loop; each K tile and V tile comes by 16-byte cp.async copies
// into one buffer each, K_{t+1} while tile t's softmax and P V run and
// V_{t+1} while tile t + 1's scores run, and two blocks fit an SM.
//   S = Q K^T: each thread owns an 8 x 4 block of the 64 x 64 scores
//   (rows 8 ty + i, keys tx + 16 j) and computes each score as one f32
//   FMA chain over d in ascending order, the bf16 prefill's and the
//   decode's order: per four d, twelve 16-byte shared loads (Q rows as
//   broadcasts, K rows XOR-swizzled by 16-byte chunk so that eight
//   consecutive rows are free of bank conflicts) feed 128 FMAs.
//   Online softmax in registers: the scale after the dot, the TPU
//   kernel's masks (skipped for tiles wholly inside them), row max and
//   sum across the 16 threads of a row (four shuffles each); P goes to
//   shared memory transposed (P^T, swizzled like K), each row's alpha
//   beside it.
//   O += P V, a register-tiled f32 FMA product: each thread owns a block
//   of the 64 x D output (8 rows x 8 columns at D = 128), rescales it by
//   its rows' alpha and adds p v over the tile's 64 keys in ascending
//   order, p from P^T and v from V in 16-byte shared loads (16 FMAs a
//   load at D = 128).
// Whole tiles are skipped with the TPU kernel's predicates (causal: k_lo
// > q_hi; window: k_hi <= q_lo - window) by bounding the tile loop.  Q
// rows past Sq and kv rows past skv are zero-filled by the copies and
// masked, so nothing is padded.

#include <stdint.h>

#include "flash_common.cuh"
#include "rt_types.h"

namespace {

constexpr int PF_BQ = 64;        // q rows per block
constexpr int PF_BK = 64;        // kv rows per tile
constexpr int PF_THREADS = 128;

// float offset of (row r, column col) in a [rows][W] f32 tile whose
// 16-byte chunks are XOR-permuted by row: eight consecutive rows read at
// one chunk index land on 32 distinct banks
template <int W>
__device__ __forceinline__ int sw(int r, int col) {
  constexpr int CH = W / 4;                // chunks per row
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  constexpr int SH = CH < 8 ? 1 : 0;       // CH = 4: two rows a bank line
  return r * W + ((((col >> 2) ^ ((r >> SH) & MASK))) << 2) + (col & 3);
}

// shared memory of a block, in floats: Q [64][D], K [64][D] (swizzled), V
// [64][D], P^T [64 keys][64 rows] (swizzled), alpha [64], l [64]
template <int D>
struct Pf32Smem {
  static constexpr int Q = 0;
  static constexpr int K = Q + PF_BQ * D;
  static constexpr int V = K + PF_BK * D;
  static constexpr int P = V + PF_BK * D;
  static constexpr int A = P + PF_BK * PF_BQ;
  static constexpr int L = A + PF_BQ;
  static constexpr size_t BYTES = sizeof(float) * (L + PF_BQ);
};

template <int D>
__global__ void __launch_bounds__(PF_THREADS, 2)
    fa_prefill_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ o, FlashArgs a) {
  using L = Pf32Smem<D>;
  constexpr int CH = D / 4;                // 16-byte chunks per row
  // the P V layout: NCG column groups of 16-byte chunks (CPT chunks a
  // thread, NCG apart), NRG row groups of RPT consecutive rows
  constexpr int NCG = CH < 16 ? CH : 16;
  constexpr int CPT = CH / NCG;
  constexpr int NRG = PF_THREADS / NCG;
  constexpr int RPT = PF_BQ / NRG;
  extern __shared__ __align__(16) float pf32_smem[];
  float* Qs = pf32_smem + L::Q;
  float* Ks = pf32_smem + L::K;
  float* Vs = pf32_smem + L::V;
  float* Ps = pf32_smem + L::P;
  float* As = pf32_smem + L::A;
  float* Ls = pf32_smem + L::L;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // scores: rows 8 ty + i, keys
                                           // tx + 16 j
  const int cx = tid % NCG, cy = tid / NCG;  // P V: rows RPT cy + i,
                                             // chunks cx + NCG e
  // the last q tiles first: under a causal mask they hold the most kv
  // tiles, so the short ones fill the card's tail
  const int row0 = (gridDim.x - 1 - blockIdx.x) * PF_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const float* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const float* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const float* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + PF_BQ) - 1;
  // the tiles the TPU kernel's predicates keep
  const int t0 = a.window > 0 ? max(q_lo - a.window + 1, 0) / PF_BK : 0;
  const int t1 = ((a.causal ? min(a.skv, q_hi + 1) : a.skv) + PF_BK - 1) /
                 PF_BK;

  // one tile of K (swizzled) or V (plain) rows [k_lo, k_lo + 64)
  auto load = [&](const float* src, float* dst, bool swz, int t) {
    const int k_lo = t * PF_BK;
    for (int i = tid; i < PF_BK * CH; i += PF_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = k_lo + r < a.skv;
      fa::cp_async16(
          fa::smem_u32(dst + (swz ? sw<D>(r, 4 * c) : r * D + 4 * c)),
          src + (size_t)(ok ? k_lo + r : 0) * kv_rs + 4 * c, ok);
    }
  };
  for (int i = tid; i < PF_BQ * CH; i += PF_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < a.Sq;
    fa::cp_async16(fa::smem_u32(Qs + r * D + 4 * c),
                   qb + (size_t)(ok ? row0 + r : 0) * q_rs + 4 * c, ok);
  }
  if (t0 < t1) load(kb, Ks, true, t0);
  fa::cp_commit();                         // Q and K_t0
  if (t0 < t1) load(vb, Vs, false, t0);
  fa::cp_commit();                         // V_t0

  float acc[RPT][4 * CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CPT; ++c) acc[i][c] = 0.f;
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = fa::NEG_INF;
    l[i] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const bool more = t + 1 < t1;
    fa::cp_wait<1>();                      // K_t (and Q) have landed
    __syncthreads();

    // S = Q K^T: each score one f32 FMA chain over d = 0, 1, ..., D - 1
    float sb[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sb[i][j] = 0.f;
#pragma unroll 2
    for (int dc = 0; dc < CH; ++dc) {
      float4 kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks +
                                                 sw<D>(tx + 16 * j, 4 * dc));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (8 * ty + i) * D + 4 * dc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sb[i][j];
          x = fmaf(qv.x, kk[j].x, x);
          x = fmaf(qv.y, kk[j].y, x);
          x = fmaf(qv.z, kk[j].z, x);
          sb[i][j] = fmaf(qv.w, kk[j].w, x);
        }
      }
    }
    __syncthreads();                       // K is read: K_{t+1} may come
    if (more) {
      load(kb, Ks, true, t + 1);
      fa::cp_commit();
    }

    // the scale, the masks and the online softmax, row by row
    const int k_lo = t * PF_BK;
    const bool inside = k_lo + PF_BK <= a.skv &&
                        (!a.causal || k_lo + PF_BK - 1 <= q_lo) &&
                        (a.window == 0 || k_lo > q_hi - a.window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q_pos = q_lo + 8 * ty + i;
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sv = sb[i][j] * a.scale;
        if (!inside) {
          const int kv_pos = k_lo + tx + 16 * j;
          bool ok = kv_pos < a.skv;
          if (a.causal) ok = ok && kv_pos <= q_pos;
          if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
          sv = ok ? sv : fa::NEG_INF;
        }
        sb[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sb[i][j] - m_new);
        sb[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tx == 0) As[8 * ty + i] = alpha;
    }
    // P^T: key tx + 16 j, rows 8 ty .. 8 ty + 7
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i4 = 0; i4 < 2; ++i4)
        *reinterpret_cast<float4*>(Ps +
                                   sw<PF_BQ>(tx + 16 * j, 8 * ty + 4 * i4)) =
            make_float4(sb[4 * i4][j], sb[4 * i4 + 1][j], sb[4 * i4 + 2][j],
                        sb[4 * i4 + 3][j]);
    if (more)
      fa::cp_wait<1>();                    // V_t has landed (K_{t+1} may not)
    else
      fa::cp_wait<0>();
    __syncthreads();

    // O = O * alpha + P V over the tile's keys in ascending order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float al = As[RPT * cy + i];
#pragma unroll
      for (int c = 0; c < 4 * CPT; ++c) acc[i][c] *= al;
    }
#pragma unroll 4
    for (int j = 0; j < PF_BK; ++j) {
      float pr[RPT];
      if constexpr (RPT >= 4) {
#pragma unroll
        for (int i4 = 0; i4 < RPT / 4; ++i4) {
          const float4 x = *reinterpret_cast<const float4*>(
              Ps + sw<PF_BQ>(j, RPT * cy + 4 * i4));
          pr[4 * i4] = x.x;
          pr[4 * i4 + 1] = x.y;
          pr[4 * i4 + 2] = x.z;
          pr[4 * i4 + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) pr[i] = Ps[sw<PF_BQ>(j, RPT * cy + i)];
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + j * D + 4 * (cx + NCG * e));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][4 * e] = fmaf(pr[i], vv.x, acc[i][4 * e]);
          acc[i][4 * e + 1] = fmaf(pr[i], vv.y, acc[i][4 * e + 1]);
          acc[i][4 * e + 2] = fmaf(pr[i], vv.z, acc[i][4 * e + 2]);
          acc[i][4 * e + 3] = fmaf(pr[i], vv.w, acc[i][4 * e + 3]);
        }
      }
    }
    __syncthreads();                       // V and P^T are read
    if (more) {
      load(vb, Vs, false, t + 1);
      fa::cp_commit();
    }
  }
  fa::cp_wait<0>();

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) Ls[8 * ty + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + RPT * cy + i;
    if (r < a.Sq) {
      const float den = fmaxf(Ls[RPT * cy + i], 1e-30f);
      float* orow = o + ((size_t)b * a.Sq + r) * q_rs + (size_t)h * D;
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        *reinterpret_cast<float4*>(orow + 4 * (cx + NCG * e)) =
            make_float4(acc[i][4 * e] / den, acc[i][4 * e + 1] / den,
                        acc[i][4 * e + 2] / den, acc[i][4 * e + 3] / den);
    }
  }
}

template <int D>
cudaError_t launch_prefill_f32(const void* q, const void* k, const void* v,
                               void* o, const FlashArgs& a,
                               cudaStream_t stream) {
  const int smem = (int)Pf32Smem<D>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_prefill_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // the largest shared-memory carveout, so that two blocks fit an SM
  cudaError_t e = cudaFuncSetAttribute(
      fa_prefill_f32_kernel<D>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + PF_BQ - 1) / PF_BQ, a.H, a.B);
  fa_prefill_f32_kernel<D><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_prefill_f32(const void* q, const void* k,
                                     const void* v, void* o,
                                     const FlashArgs& a, int D,
                                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_prefill_f32<16>(q, k, v, o, a, stream);
    case 32: return launch_prefill_f32<32>(q, k, v, o, a, stream);
    case 64: return launch_prefill_f32<64>(q, k, v, o, a, stream);
    case 128: return launch_prefill_f32<128>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}
