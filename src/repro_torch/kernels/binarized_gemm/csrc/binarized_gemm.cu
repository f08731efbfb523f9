// K9 binarized_gemm: the BNN primitive out = sign(x) @ sign(w), exact,
//   sign(v) = +1 where v >= 0, else -1 (so -0.0 gives +1 and NaN -1),
// x [B, K] and w [K, N] f32 or bf16 -> out [B, N] int32.
//
// Replaces the TPU kernel repro/kernels/binarized_gemm/kernel.py:29
// (_kernel, launched by binarized_gemm_padded :50 at :62), which takes
// the signs as int8 and runs an int8 MXU matmul.  No path of the JAX
// package or of the port runs it; it is ported as an op.
//
// Bound: bytes at the shapes this repository times.  x and w are read
// once (B*K and K*N elements) and out written once (4*B*N bytes), over
// 3.35 TB/s; the 2*B*K*N int8 operations over 1,979 TOP/s take about as
// long at 4,096^3 and less at smaller K.
//
// Design: XNOR-popcount on bit-packed signs, in three launches.
//   1. bgemm_pack_rows: one warp per 32 elements of an x row; each lane
//      tests one element and __ballot_sync packs the warp's 32 signs
//      into one word of xbits [KW, B] (KW = ceil(K / 32), word-major).
//   2. bgemm_pack_cols: one thread per (word, column) of w; it reads 32
//      rows of its column (neighbouring threads read neighbouring
//      columns) and writes wbits [KW, N].
//   Bits at k >= K are 0 on both sides, so they never differ: that is
//   the mask of the last partial word, and no padded copy of x or w is
//   made.  B, K and N are ragged inside the kernels.
//   3. bgemm_xor_popc: a block of 16 x 16 threads computes a 64 x 64
//      output tile, each thread 4 x 4 outputs (rows ty + 16 i, columns
//      tx + 16 j).  Chunks of 32 words of both operands are staged in
//      shared memory, word-major, so the loads and the reads are
//      conflict-free, and each output counts the differing signs with
//      __popc(a ^ b).  out = K - 2 * differing: the integer dot product
//      of the +-1 vectors (matches - mismatches), in int32.

#include <cuda_bf16.h>
#include <stdint.h>

#include "rt_types.h"

namespace {

constexpr int BG_TILE = 64;     // output rows and columns of a block
constexpr int BG_THREADS = 16;  // threads per block side (4 x 4 each)
constexpr int BG_KT = 32;       // words of K staged per chunk

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x [B, K] row-major -> xbits [KW, B]: bit l of word (kw, b) is
// x[b, 32 kw + l] >= 0.  One warp per word; the grid covers B * KW warps.
template <typename T>
__global__ void bgemm_pack_rows(const T* __restrict__ x,
                                uint32_t* __restrict__ xbits, int B, int K,
                                int KW) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * KW) return;  // whole warps leave together
  const int b = (int)(warp / KW), kw = (int)(warp % KW);
  const int k = kw * 32 + lane;
  const bool pos = k < K && as_float(x[(size_t)b * K + k]) >= 0.f;
  const uint32_t word = __ballot_sync(0xffffffffu, pos);
  if (lane == 0) xbits[(size_t)kw * B + b] = word;
}

// w [K, N] row-major -> wbits [KW, N]: bit l of word (kw, n) is
// w[32 kw + l, n] >= 0.  One thread per word.
template <typename T>
__global__ void bgemm_pack_cols(const T* __restrict__ w,
                                uint32_t* __restrict__ wbits, int K, int N,
                                int KW) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)KW * N) return;
  const int kw = (int)(i / N), n = (int)(i % N);
  const int k0 = kw * 32, nk = min(32, K - k0);
  uint32_t word = 0;
  for (int l = 0; l < nk; ++l)
    word |= (uint32_t)(as_float(w[(size_t)(k0 + l) * N + n]) >= 0.f) << l;
  wbits[i] = word;
}

__global__ void __launch_bounds__(BG_THREADS* BG_THREADS)
    bgemm_xor_popc(const uint32_t* __restrict__ xbits,
                   const uint32_t* __restrict__ wbits, int* __restrict__ out,
                   int B, int K, int N, int KW) {
  __shared__ uint32_t xs[BG_KT][BG_TILE];
  __shared__ uint32_t ws[BG_KT][BG_TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BG_THREADS + tx;
  const int b0 = blockIdx.y * BG_TILE, n0 = blockIdx.x * BG_TILE;
  int cnt[4][4] = {};
  for (int k0 = 0; k0 < KW; k0 += BG_KT) {
    // 2,048 words of each operand, 8 per thread; consecutive threads
    // take consecutive rows (columns) of one word: coalesced, no conflict
    for (int e = tid; e < BG_KT * BG_TILE; e += BG_THREADS * BG_THREADS) {
      const int kk = e / BG_TILE, c = e % BG_TILE;
      const bool kin = k0 + kk < KW;
      xs[kk][c] = kin && b0 + c < B ? xbits[(size_t)(k0 + kk) * B + b0 + c]
                                    : 0u;
      ws[kk][c] = kin && n0 + c < N ? wbits[(size_t)(k0 + kk) * N + n0 + c]
                                    : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BG_KT; ++kk) {
      uint32_t a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + BG_THREADS * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[kk][tx + BG_THREADS * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[i][j] += __popc(a[i] ^ bw[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty + BG_THREADS * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + BG_THREADS * j;
      if (n < N) out[(size_t)b * N + n] = K - 2 * cnt[i][j];
    }
  }
}

template <typename T>
cudaError_t pack_rows(const void* x, uint32_t* xbits, int B, int K, int KW,
                      cudaStream_t stream) {
  const long long threads = (long long)B * KW * 32;
  const int block = 256;
  bgemm_pack_rows<T><<<(unsigned)((threads + block - 1) / block), block, 0,
                       stream>>>(static_cast<const T*>(x), xbits, B, K, KW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pack_cols(const void* w, uint32_t* wbits, int K, int N, int KW,
                      cudaStream_t stream) {
  const long long words = (long long)KW * N;
  const int block = 256;
  bgemm_pack_cols<T><<<(unsigned)((words + block - 1) / block), block, 0,
                       stream>>>(static_cast<const T*>(w), wbits, K, N, KW);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_binarized_gemm(const void* x, int x_bf16, const void* w,
                                  int w_bf16, uint32_t* xbits,
                                  uint32_t* wbits, int* out, int B, int K,
                                  int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int KW = (K + 31) / 32;
  cudaError_t err =
      x_bf16 ? pack_rows<__nv_bfloat16>(x, xbits, B, K, KW, stream)
             : pack_rows<float>(x, xbits, B, K, KW, stream);
  if (err != cudaSuccess) return err;
  err = w_bf16 ? pack_cols<__nv_bfloat16>(w, wbits, K, N, KW, stream)
               : pack_cols<float>(w, wbits, K, N, KW, stream);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BG_TILE - 1) / BG_TILE, (B + BG_TILE - 1) / BG_TILE);
  dim3 block(BG_THREADS, BG_THREADS);
  bgemm_xor_popc<<<grid, block, 0, stream>>>(xbits, wbits, out, B, K, N, KW);
  return cudaGetLastError();
}
