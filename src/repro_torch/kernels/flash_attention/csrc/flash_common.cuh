// Device helpers shared by K7's kernels (flash_prefill.cu,
// flash_prefill_f32.cu, flash_decode.cu): 16-byte asynchronous copies
// into shared memory, the warp reductions of the online softmax and the
// element types' loads.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

constexpr float NEG_INF = -1e30f;    // the TPU kernel's finite mask value

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; ``full`` false zero-fills them
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 8 bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void unpack8(const uint4& x, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// what the split-KV decode reads and writes of an element type: the
// elements of a 16-byte chunk in f32, a column pair in f32, an output
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER16 = 8;
  __device__ static __forceinline__ void unpack(const uint4& x, float* f) {
    unpack8(x, f);
  }
  __device__ static __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Elem<float> {
  static constexpr int PER16 = 4;
  __device__ static __forceinline__ void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
  __device__ static __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static __forceinline__ float from_float(float x) { return x; }
};

}  // namespace fa
