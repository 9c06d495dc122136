// Pieces shared by the banded kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace banded {

// Dynamic shared memory one block may use on sm_90.
constexpr int kSmemLimit = 232448;

// Compute type of the H-pass rows kept in shared memory: bf16 or fp32,
// the TPU kernels' cast point between the two passes.
template <bool F32> struct Mid;
template <> struct Mid<true> {
  using T = float;
  static __device__ __forceinline__ T put(float x) { return x; }
  static __device__ __forceinline__ float get(T x) { return x; }
};
template <> struct Mid<false> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T put(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float get(T x) {
    return __bfloat162float(x);
  }
};

// Sets the dynamic shared memory limit of `kern` when `bytes` needs more
// than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The labs' sinks: what a knock-out must not drop is XORed into a few
// int32 words, so that no load or result is dead code.

// XOR of every 32-bit word of rows [r0, r1) of `len`-byte rows at `src`
// (16-byte loads when vec; else bytes shifted to their place in the word).
// Every thread of the block calls it with its share.
__device__ inline unsigned stream_rows(const uint8_t* src, long long rs,
                                       int r0, int r1, int len, bool vec) {
  unsigned acc = 0;
  if (r1 <= r0) return acc;
  if (vec) {
    const int vpr = len / 16;
    const long long n = static_cast<long long>(r1 - r0) * vpr;
    for (long long e = threadIdx.x; e < n; e += blockDim.x) {
      const long long r = e / vpr;
      const int g = static_cast<int>(e - r * vpr);
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          src + (r0 + r) * rs + g * 16));
      acc ^= q.x ^ q.y ^ q.z ^ q.w;
    }
  } else {
    const long long n = static_cast<long long>(r1 - r0) * len;
    for (long long e = threadIdx.x; e < n; e += blockDim.x) {
      const long long r = e / len;
      const int c = static_cast<int>(e - r * len);
      acc ^= static_cast<unsigned>(__ldg(src + (r0 + r) * rs + c))
             << (8 * (c & 3));
    }
  }
  return acc;
}

// XOR each thread's `acc` into one word of the sink, sink[slot % words].
// Every thread of the block calls it.
__device__ inline void sink_xor(unsigned acc, unsigned* sink, int words,
                                long long slot) {
  __shared__ unsigned warp_acc[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned x = 0;
    for (int i = 0; i < (blockDim.x + 31) / 32; ++i) x ^= warp_acc[i];
    atomicXor(sink + slot % words, x);
  }
}

}  // namespace banded
