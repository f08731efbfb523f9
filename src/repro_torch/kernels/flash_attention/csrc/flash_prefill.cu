// K7's bf16 prefill, its P V product on Hopper's tensor cores (Sq >
// FA_DECODE_MAX_SQ; see flash_attention.cu for what K7 replaces and the
// numbers it keeps).
//
// Bound: the larger of the bytes (Q, K, V and O once) over 3.35 TB/s and
// the operations (4 * D per live (q, kv) pair per head) over 989 TFLOP/s
// (bf16 dense): bytes at a 512-token Qwen3-1.7B prefill, operations at
// 2,048 tokens.
//
// Design.  One warpgroup (4 warps, 128 threads) owns 64 q rows of one
// (q head, batch); a loop over 64-row kv tiles takes the place of the
// TPU's sequential innermost grid dimension.  Q is loaded once and kept
// transposed in f32 (Q^T); each K tile and V tile comes by 16-byte
// cp.async copies, tile t + 1 while tile t computes (V in a ring of two
// stages in the swizzled layout wgmma's descriptors read: rows of min(2 D,
// 128) bytes, 16-byte chunks XOR-permuted by row; K in one staging buffer
// turned into f32 K^T at the top of each tile).  Two blocks fit an SM.
//   S = Q K^T on the CUDA cores: each thread computes an 8 x 4 block of
//   the 64 x 64 scores as f32 FMA chains over d in ascending order, the
//   reference's own order (three 16-byte shared loads feed 32 FMAs), and
//   the block goes through shared memory into the wgmma accumulator
//   layout.  Hopper's tensor cores do not hold this product: they sum a
//   k-step's products to far less than f32 precision, and on the seeded
//   Jamba attention (no QK-norm, scores spread near 360, outputs decided
//   by near-ties) bf16 scores on wgmma missed path_hybrid_serve's
//   per-block gate in chip_smoke.py; mma.sync in bf16 and tf32, and
//   exact int8 products of a 22-bit fixed point, missed it too.  Only
//   f32 FMA chains in the reference's order land within one bf16 step.
//   Online softmax in registers: the scale after the dot, the TPU
//   kernel's masks (skipped for tiles wholly inside them), row max and
//   sum across the 4 threads of a row (two shuffles), alpha rescales the
//   output accumulator.
//   O += P V on the tensor cores: wgmma m64nDk16 (bf16 in, f32
//   accumulate) with P as the A operand from registers (the score
//   layout is the A fragment's) and V the B operand from shared memory,
//   transposed by wgmma's own flag (MN-major).  P stays f32 as in the
//   reference: it goes in as p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//   two products into one f32 accumulator, within about 2^-16 of the f32
//   product; the products' sum is bounded by the largest |v|, so the
//   tensor cores' coarse sums hold here.
// Whole tiles are skipped with the TPU kernel's predicates (causal: k_lo
// > q_hi; window: k_hi <= q_lo - window) by bounding the tile loop.  Q
// rows past Sq and kv rows past skv are zero-filled by the copies and
// masked, so nothing is padded.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"
#include "rt_types.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PF_BQ = 64;        // q rows per block: wgmma's M
constexpr int PF_BK = 64;        // kv rows per tile: the score product's N
constexpr int PF_THREADS = 128;  // one warpgroup

using fa::make_desc;
using fa::proxy_fence;
using fa::reg_fence;
using fa::Tile;
using fa::wg_commit;
using fa::wg_fence;
using fa::wg_wait0;
using fa::wgmma_pv;

// shared memory of a block, in bytes: V's two stages and K's staging
// (bf16, swizzled), Q^T in f32, then one region that holds Q's bf16
// staging, K^T in f32 and the score tile S in f32 by turns
template <int D>
struct PfSmem {
  static constexpr int SST = PF_BK + 4;    // S row, padded 16 bytes
  static constexpr uint32_t V0 = 0;
  static constexpr uint32_t KST = 2 * Tile<D>::BYTES;
  static constexpr uint32_t QT = 3 * Tile<D>::BYTES;
  static constexpr uint32_t R = QT + 4 * D * PF_BQ;
  static constexpr uint32_t R_BYTES =
      4 * D * PF_BK > 4 * PF_BQ * SST ? 4 * D * PF_BK : 4 * PF_BQ * SST;
  static constexpr uint32_t BYTES = R + R_BYTES + 1024;  // + alignment
};

// a bf16 [64][D] tile in the swizzled layout -> f32 [D][64] (transposed):
// thread i takes row i % 64 of chunk i / 64, so a warp's stores are 32
// consecutive floats
template <int D>
__device__ __forceinline__ void to_f32_t(const unsigned char* tile,
                                         float* out, int tid) {
  for (int i = tid; i < 64 * (D / 8); i += PF_THREADS) {
    const int r = i % 64, c = i / 64;
    float f[8];
    fa::unpack8(*reinterpret_cast<const uint4*>(tile + Tile<D>::offset(r, c)),
                f);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[(8 * c + e) * 64 + r] = f[e];
  }
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS)
    fa_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      FlashArgs a) {
  using T = Tile<D>;
  using L = PfSmem<D>;
  constexpr int CH = D / 8;                // 16-byte chunks per row
  constexpr int NS = PF_BK / 8;            // n8 column groups of S
  extern __shared__ unsigned char pf_smem[];
  const uint32_t base = (fa::smem_u32(pf_smem) + 1023u) & ~1023u;
  unsigned char* smem = pf_smem + (base - fa::smem_u32(pf_smem));
  const float* QT = reinterpret_cast<const float*>(smem + L::QT);
  float* KT = reinterpret_cast<float*>(smem + L::R);
  float* Sf = KT;                          // by turns

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // fragment rows: g, g + 8
  const int tq = lane & 3;                 // of the warp's 16
  const int tx = tid % 16, ty = tid / 16;  // score block: rows 8 ty + i,
                                           // columns 4 tx + j
  // the last q tiles first: under a causal mask they hold the most
  // kv tiles, so the short ones fill the card's tail
  const int row0 = (gridDim.x - 1 - blockIdx.x) * PF_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const size_t q_rs = (size_t)a.H * D;
  const size_t kv_rs = (size_t)a.K * D;
  const bf16* qb = q + (size_t)b * a.Sq * q_rs + (size_t)h * D;
  const bf16* kb = k + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * a.Skv * kv_rs + (size_t)kvh * D;

  const int q_lo = a.q_offset + row0;
  const int q_hi = a.q_offset + min(a.Sq, row0 + PF_BQ) - 1;
  // the tiles the TPU kernel's predicates keep
  const int t0 = a.window > 0 ? max(q_lo - a.window + 1, 0) / PF_BK : 0;
  const int t1 = ((a.causal ? min(a.skv, q_hi + 1) : a.skv) + PF_BK - 1) /
                 PF_BK;

  auto load_kv = [&](int t, int s) {
    const int k_lo = t * PF_BK;
    for (int i = tid; i < PF_BK * CH; i += PF_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = k_lo + r < a.skv;
      const size_t off = (size_t)(ok ? k_lo + r : 0) * kv_rs + c * 8;
      const uint32_t so = T::offset(r, c);
      fa::cp_async16(base + L::KST + so, kb + off, ok);
      fa::cp_async16(base + L::V0 + s * T::BYTES + so, vb + off, ok);
    }
  };
  for (int i = tid; i < PF_BQ * CH; i += PF_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < a.Sq;
    fa::cp_async16(base + L::R + T::offset(r, c),
                   qb + (size_t)(ok ? row0 + r : 0) * q_rs + c * 8, ok);
  }
  if (t0 < t1) load_kv(t0, 0);
  fa::cp_commit();
  fa::cp_wait<0>();
  __syncthreads();
  to_f32_t<D>(smem + L::R, reinterpret_cast<float*>(smem + L::QT), tid);

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {fa::NEG_INF, fa::NEG_INF};
  float l[2] = {0.f, 0.f};
  const int rA = warp * 16 + g;            // tile row of m[0]; m[1]: rA + 8

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    fa::cp_wait<0>();                      // K_t and V_t have landed
    proxy_fence();
    __syncthreads();
    to_f32_t<D>(smem + L::KST, KT, tid);
    __syncthreads();
    if (t + 1 < t1) {                      // K's staging is free again
      load_kv(t + 1, s ^ 1);
      fa::cp_commit();
    }

    // S = Q K^T: each score one f32 FMA chain over d = 0, 1, ..., D - 1
    float sb[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sb[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(QT + d * 64 + 8 * ty);
      const float4 qc =
          *reinterpret_cast<const float4*>(QT + d * 64 + 8 * ty + 4);
      const float4 kk = *reinterpret_cast<const float4*>(KT + d * 64 + 4 * tx);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sb[i][j] = fmaf(qv[i], kv[j], sb[i][j]);
    }
    __syncthreads();                       // K^T is read: S takes its place
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(Sf + (8 * ty + i) * L::SST + 4 * tx) =
          make_float4(sb[i][0], sb[i][1], sb[i][2], sb[i][3]);
    __syncthreads();
    // the wgmma accumulator layout: register 4 j + 2 hr + e is row rA + 8
    // hr, column 8 j + 2 tq + e
    float sacc[PF_BK / 2];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 x = *reinterpret_cast<const float2*>(
            Sf + (rA + 8 * hr) * L::SST + 8 * j + 2 * tq);
        sacc[4 * j + 2 * hr] = x.x;
        sacc[4 * j + 2 * hr + 1] = x.y;
      }

    // the scale, the masks and the online softmax
    const int k_lo = t * PF_BK;
    const bool inside = k_lo + PF_BK <= a.skv &&
                        (!a.causal || k_lo + PF_BK - 1 <= q_lo) &&
                        (a.window == 0 || k_lo > q_hi - a.window);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q_pos = q_lo + rA + 8 * hr;
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sv = sacc[4 * j + 2 * hr + e] * a.scale;
          if (!inside) {
            const int kv_pos = k_lo + 8 * j + 2 * tq + e;
            bool ok = kv_pos < a.skv;
            if (a.causal) ok = ok && kv_pos <= q_pos;
            if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
            sv = ok ? sv : fa::NEG_INF;
          }
          sacc[4 * j + 2 * hr + e] = sv;
          mx = fmaxf(mx, sv);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sacc[4 * j + 2 * hr + e] - m_new);
          sacc[4 * j + 2 * hr + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 2 * hr] *= alpha;
        oacc[4 * j + 2 * hr + 1] *= alpha;
      }
    }

    // P as A fragments, hi and lo: register e of k-step kk is row rA + 8
    // (e & 1), columns 16 kk + 8 (e >> 1) + 2 tq and + 1
    uint32_t ph[PF_BK / 16][4], pl[PF_BK / 16][4];
    fa::split_a64(sacc, ph, pl);

    // O += P_hi V + P_lo V
    reg_fence<D / 2>(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PF_BK / 16; ++kk) {
      const uint64_t dv = make_desc(base + L::V0 + s * T::BYTES +
                                        kk * 16 * T::RB,
                                    64 * T::RB, T::SBO, T::MODE);
      wgmma_pv<D>(oacc, ph[kk], dv);
      wgmma_pv<D>(oacc, pl[kk], dv);
    }
    wg_commit();
    wg_wait0();
    reg_fence<D / 2>(oacc);
    __syncthreads();                       // S and the V stage are free
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + rA + 8 * hr;
    if (r < a.Sq) {
      const float den = fmaxf(l[hr], 1e-30f);
      bf16* orow = o + ((size_t)b * a.Sq + r) * q_rs + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * hr] / den,
                                  oacc[4 * j + 2 * hr + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           void* o, const FlashArgs& a, cudaStream_t stream) {
  const int smem = PfSmem<D>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + PF_BQ - 1) / PF_BQ, a.H, a.B);
  fa_prefill_kernel<D><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_prefill(const void* q, const void* k,
                                 const void* v, void* o, const FlashArgs& a,
                                 int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_prefill<16>(q, k, v, o, a, stream);
    case 32: return launch_prefill<32>(q, k, v, o, a, stream);
    case 64: return launch_prefill<64>(q, k, v, o, a, stream);
    case 128: return launch_prefill<128>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}
