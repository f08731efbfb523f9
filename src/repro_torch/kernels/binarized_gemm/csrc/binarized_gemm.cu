// K9 binarized_gemm: the BNN primitive out = sign(x) @ sign(w), exact,
//   sign(v) = +1 where v >= 0, else -1 (so -0.0 gives +1 and NaN -1),
// x [B, K] and w [K, N] f32 or bf16 -> out [B, N] int32.
//
// Replaces the TPU kernel repro/kernels/binarized_gemm/kernel.py:29
// (_kernel, launched by binarized_gemm_padded :50 at :62), which takes
// the signs as int8 and runs an int8 MXU matmul.  No path of the JAX
// package or of the port runs it; it is ported as an op.
//
// Bound: x and w read once (B*K and K*N elements) and out written once
// (4*B*N bytes) over 3.35 TB/s, or the 2*B*K*N int8 operations over the
// tensor cores' 1,979 TOP/s, whichever is longer: the operations at
// 4,096^3 (0.069 ms against 0.057 for the bytes).
//
// Design: the TPU kernel's own form, int8 signs on the matrix unit, in
// two launches.
//   1. bgemm_sign_pack<TX, TW>: one launch over both operands.  Its first
//      blocks write xs [B, Kp] int8 (+1 / -1), 8 elements a thread (16-byte
//      loads where the rows allow it); the rest write wt [N, Kp] int8, w's
//      signs transposed: a 128 (k) x 32 (n) tile goes through shared memory
//      as words of 4 signs (a padded row of 33 words: conflict-free both
//      ways) and leaves in 16-byte stores along k.  int8 wgmma takes both
//      operands K-major, hence the transpose.  Kp is K rounded up to
//      the product's K tile (BG_KTILE) and the columns k >= K hold 0: a zero
//      adds nothing, so no correction term is needed (the JAX op pads
//      with -1e-9 and subtracts the padding's share afterwards).
//   2. bgemm_wgmma_kernel: the product on the int8 tensor cores,
//      wgmma.mma_async m64n256k32 .s32.s8.s8 with both operands in shared
//      memory and int32 accumulators.  A block owns a 128 x 256 output
//      tile: one producer warp (of a warpgroup that gives its registers
//      away, setmaxnreg) brings 128 x 128 tiles of xs and 256 x 128 tiles
//      of wt by TMA (cp.async.bulk.tensor.2d, 128-byte swizzle) into a
//      ring of BG_STAGES stages on mbarriers; two consumer warpgroups
//      each multiply 64 rows by the 256 columns, four k-steps a stage,
//      keep one stage's products in flight while the next is issued, and
//      free a stage once its products are done.  Ragged B and N: the TMA
//      fills rows past the tensor's edge with zeros on the way in, and
//      the stores are masked on the way out.
// Why it is exact: each product of +-1 (or 0) values is +-1 (or 0), and
// int32 sums of them are exact in any order for K < 2^31.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "rt_types.h"
#include "tma_map.h"

namespace {

// ------------------------------------------------------ pass 1: the signs

constexpr int SP_THREADS = 256;
constexpr int SP_X_ELEMS = 8;          // xs elements a thread writes
constexpr int SP_TK = 128;             // w tile: k rows (= BG_KTILE)
constexpr int SP_TN = 32;              // w tile: n columns
static_assert(SP_TK == BG_KTILE, "a w tile spans one K tile of wt");

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the sign as an int8 bit pattern: +1 = 0x01, -1 = 0xff
__device__ __forceinline__ uint32_t sign8(float v) {
  return v >= 0.f ? 0x01u : 0xffu;
}

// 8 signs of x[b, k0 .. k0 + 8) (0 past K) as two words
template <typename T>
__device__ __forceinline__ uint2 x_signs(const T* __restrict__ x, size_t row,
                                         int k0, int K, bool vec) {
  uint32_t lo = 0, hi = 0;
  if (vec && k0 + SP_X_ELEMS <= K) {
    float v[8];
    if constexpr (sizeof(T) == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + row + k0));
      const float4 c =
          __ldg(reinterpret_cast<const float4*>(x + row + k0 + 4));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + row + k0));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= sign8(v[i]) << (8 * i);
      hi |= sign8(v[4 + i]) << (8 * i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + i;
      const uint32_t s = k < K ? sign8(as_float(x[row + k])) : 0u;
      if (i < 4) lo |= s << (8 * i);
      else hi |= s << (8 * (i - 4));
    }
  }
  return make_uint2(lo, hi);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(SP_THREADS)
    bgemm_sign_pack(const TX* __restrict__ x, const TW* __restrict__ w,
                    int8_t* __restrict__ xs, int8_t* __restrict__ wt, int B,
                    int K, int N, int Kp, int x_blocks, int x_vec) {
  __shared__ uint32_t tile[SP_TN][SP_TN + 1];   // [n][k / 4], padded
  if ((int)blockIdx.x < x_blocks) {
    const int per_row = Kp / SP_X_ELEMS;
    const long long c =
        (long long)blockIdx.x * SP_THREADS + threadIdx.x;
    if (c >= (long long)B * per_row) return;
    const int b = (int)(c / per_row);
    const int k0 = (int)(c % per_row) * SP_X_ELEMS;
    const uint2 s = x_signs(x, (size_t)b * K, k0, K, x_vec != 0);
    *reinterpret_cast<uint2*>(xs + (size_t)b * Kp + k0) = s;
    return;
  }
  const int nkt = Kp / SP_TK;
  const int t = (int)blockIdx.x - x_blocks;
  const int k0 = (t % nkt) * SP_TK, n0 = (t / nkt) * SP_TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = n0 + lane;
  // warp wi packs words wi, wi + 8, wi + 16, wi + 24 of column n: each
  // load reads 32 neighbouring columns of one row of w
#pragma unroll
  for (int p = 0; p < SP_TN / 8; ++p) {
    const int kw = warp + 8 * p;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * kw + j;
      const uint32_t s =
          k < K && n < N ? sign8(as_float(w[(size_t)k * N + n])) : 0u;
      word |= s << (8 * j);
    }
    tile[lane][kw] = word;
  }
  __syncthreads();
  // thread: row r of wt, 16 bytes (words 4q .. 4q + 3) of its 128
  const int r = threadIdx.x >> 3, q = threadIdx.x & 7;
  if (n0 + r < N) {
    const uint4 v = make_uint4(tile[r][4 * q], tile[r][4 * q + 1],
                               tile[r][4 * q + 2], tile[r][4 * q + 3]);
    *reinterpret_cast<uint4*>(wt + (size_t)(n0 + r) * Kp + k0 + 16 * q) = v;
  }
}

// ------------------------------------------- pass 2: the int8 wgmma GEMM

constexpr int BG_BM = 128;            // output rows a block: 2 x wgmma's M
constexpr int BG_BN = 256;            // output columns a block: wgmma's N
constexpr int BG_BK = BG_KTILE;       // k bytes a stage: one 128-byte row
constexpr int BG_STAGES = 4;
constexpr int BG_THREADS = 384;       // producer + two consumer warpgroups
constexpr uint32_t BG_A_BYTES = BG_BM * BG_BK;                 // 16 KB
constexpr uint32_t BG_B_BYTES = BG_BN * BG_BK;                 // 32 KB
constexpr uint32_t BG_STAGE_BYTES = BG_A_BYTES + BG_B_BYTES;
constexpr size_t BG_SMEM = (size_t)BG_STAGES * BG_STAGE_BYTES + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a box of the tensor at (inner c0, outer c1) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle (the TMA's layout): rows of 128 bytes, 8-row groups 1,024 bytes
// apart (SBO), layout type 1; LBO is not read in this mode
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define BG_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define BG_D16(i) BG_D4(i), BG_D4(i + 4), BG_D4(i + 8), BG_D4(i + 12)

// d (64 x 256 int32 across the warpgroup) += A (64 x 32) B^T (256 x 32),
// or = when accumulate is 0
__device__ __forceinline__ void wgmma_s8_m64n256k32(int* d, uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : BG_D16(0), BG_D16(16), BG_D16(32), BG_D16(48), BG_D16(64),
        BG_D16(80), BG_D16(96), BG_D16(112)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef BG_D16
#undef BG_D4

// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
__device__ __forceinline__ void reg_fence(int* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__global__ void __launch_bounds__(BG_THREADS, 1)
    bgemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       int* __restrict__ out, int B, int N, int nk) {
  extern __shared__ uint8_t bg_raw[];
  __shared__ __align__(8) uint64_t full[BG_STAGES], empty[BG_STAGES];
  // the 128-byte swizzle repeats every 1,024 bytes: stage bases on it
  const uint32_t base = (smem_u32(bg_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * BG_BM, n0 = blockIdx.x * BG_BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BG_STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);        // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % BG_STAGES;
        if (kt >= BG_STAGES) bar_wait(empty + s, (kt / BG_STAGES - 1) & 1);
        bar_expect(full + s, BG_STAGE_BYTES);
        const uint32_t dst = base + s * BG_STAGE_BYTES;
        tma_load(dst, &ta, kt * BG_BK, m0, full + s);
        tma_load(dst + BG_A_BYTES, &tb, kt * BG_BK, n0, full + s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;               // rows m0 + 64 c .. + 64
  const int t = threadIdx.x & 127;
  int d[128];                         // the first product overwrites d
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % BG_STAGES;
    bar_wait(full + s, (kt / BG_STAGES) & 1);
    const uint32_t a = base + s * BG_STAGE_BYTES + c * 64 * BG_BK;
    const uint32_t b = base + s * BG_STAGE_BYTES + BG_A_BYTES;
    // no other instruction touches d until the last wait: anything that
    // did would serialize the asynchronous products
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BG_BK / 32; ++kk)
      wgmma_s8_m64n256k32(d, desc_sw128(a + 32 * kk),
                          desc_sw128(b + 32 * kk), kt > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt > 0) {                     // stage kt - 1's products are done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if ((t & 31) == 0) bar_arrive(empty + (kt - 1) % BG_STAGES);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  reg_fence(d);
  // the accumulator layout: d[4 j + 2 h + e] is row 16 (t / 32) + t % 32
  // / 4 + 8 h, column 8 j + 2 (t % 4) + e
  const int row0 = m0 + 64 * c + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= B) continue;
    int* o = out + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      const int v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<int2*>(o + col) = make_int2(v0, v1);
      } else {
        if (col < N) o[col] = v0;
        if (col + 1 < N) o[col + 1] = v1;
      }
    }
  }
}

// ------------------------------------------------------------- host side

// rows x Kp int8, row-major -> a map of (box_rows x 128)-byte boxes in
// the 128-byte swizzle; rows past the edge read as zeros.  Encoding costs
// host time on every call, so the last map of each operand (slot) is
// kept: the caching allocator hands the wrapper the same scratch call
// after call, and a map depends on nothing but these arguments.
bool int8_map(CUtensorMap* map, EncodeTiled enc, void* ptr, int rows,
              int Kp, int box_rows, int slot) {
  struct Key {
    void* ptr;
    int rows, Kp, box_rows;
  };
  static Key keys[2] = {};
  static CUtensorMap maps[2];
  static std::mutex lock;
  const std::lock_guard<std::mutex> hold(lock);
  Key& k = keys[slot];
  if (k.ptr == ptr && k.rows == rows && k.Kp == Kp &&
      k.box_rows == box_rows) {
    *map = maps[slot];
    return true;
  }
  const cuuint64_t dim[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)BG_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dim, stride, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  k = Key{ptr, rows, Kp, box_rows};
  maps[slot] = *map;
  return true;
}

template <typename TX, typename TW>
cudaError_t sign_pack(const void* x, const void* w, int8_t* xs, int8_t* wt,
                      int B, int K, int N, int Kp, cudaStream_t stream) {
  const long long x_threads = (long long)B * (Kp / SP_X_ELEMS);
  const long long xb = (x_threads + SP_THREADS - 1) / SP_THREADS;
  const long long wb = (long long)(Kp / SP_TK) * ((N + SP_TN - 1) / SP_TN);
  if (xb + wb > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (K * (int)sizeof(TX)) % 16 == 0;
  bgemm_sign_pack<TX, TW><<<(unsigned)(xb + wb), SP_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), xs, wt, B, K,
      N, Kp, (int)xb, vec);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_binarized_gemm(const void* x, int x_bf16, const void* w,
                                  int w_bf16, int8_t* xs, int8_t* wt,
                                  int* out, int B, int K, int N,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int Kp = (K + BG_KTILE - 1) / BG_KTILE * BG_KTILE;
  if ((B + BG_BM - 1) / BG_BM > 65535) return cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap ta, tb;
  if (!int8_map(&ta, enc, xs, B, Kp, BG_BM, 0) ||
      !int8_map(&tb, enc, wt, N, Kp, BG_BN, 1))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  cudaError_t err =
      x_bf16 ? (w_bf16 ? sign_pack<bf, bf>(x, w, xs, wt, B, K, N, Kp, stream)
                       : sign_pack<bf, float>(x, w, xs, wt, B, K, N, Kp,
                                              stream))
             : (w_bf16 ? sign_pack<float, bf>(x, w, xs, wt, B, K, N, Kp,
                                              stream)
                       : sign_pack<float, float>(x, w, xs, wt, B, K, N, Kp,
                                                 stream));
  if (err != cudaSuccess) return err;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(bgemm_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BG_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((N + BG_BN - 1) / BG_BN, (B + BG_BM - 1) / BG_BM);
  bgemm_wgmma_kernel<<<grid, BG_THREADS, BG_SMEM, stream>>>(
      ta, tb, out, B, N, Kp / BG_BK);
  return cudaGetLastError();
}
