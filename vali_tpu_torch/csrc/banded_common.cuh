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

}  // namespace banded
