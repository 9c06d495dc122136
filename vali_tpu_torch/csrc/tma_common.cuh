// Hopper copy machinery shared by the lab kernels of this directory
// (nv12_streamed.cu, nv12_slabs.cu, nv12_staged.cu,
// nv12_convert_staged.cu): tensor maps of uint8 frames encoded on the
// host, TMA box and bulk copies into shared memory, and the mbarriers
// that report their arrival; TMA box stores from shared memory and the
// bulk groups that track them. sm_90 (the kernels that include it build
// for sm_90a).
//
// A tensor map is encoded on the host (cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPoint, so no -lcuda) and passed
// to the kernel as a __grid_constant__ parameter. One elected thread
// issues a copy; the hardware does the addressing, zero-fills what lies
// outside the tensor, and counts the box's bytes (all of them, the
// zero-filled ones too) against the transaction count of an mbarrier.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

// ---- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once; null where the
// driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Whether rows at `base` with row and batch strides `rs`, `bs` (bytes) can
// be a tensor map's: a 16-byte aligned start and strides that are
// multiples of 16 bytes.
inline bool rows_mappable(const void* base, long long rs, long long bs) {
  return (reinterpret_cast<uintptr_t>(base) & 15u) == 0 && rs % 16 == 0 &&
         bs % 16 == 0 && rs > 0 && bs > 0;
}

// A 3-D uint8 map of `batch` frames of `rows` rows of `bytes` bytes
// (strides `rs`, `bs`) read in boxes of [box_rows, 128 bytes] of one
// frame, by default swizzled by 128 bytes (16-byte chunk k of box row r
// lands at chunk k ^ (r mod 8) of its 128-byte row in shared memory);
// with CU_TENSOR_MAP_SWIZZLE_NONE box row r lands at r * 128. Returns a
// cudaError_t.
inline int encode_rows(
    CUtensorMap* map, const void* base, int bytes, int rows, int batch,
    long long rs, long long bs, int box_rows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bytes),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rs),
                                 static_cast<cuuint64_t>(bs)};
  const cuuint32_t box[3] = {128u, static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---- device ----------------------------------------------------------------

// Spins a wait may take before it traps: ~2 s of SM clock. A wait that
// never ends becomes a launch error instead of a hung card.
constexpr long long kSpinCycles = 1LL << 32;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset `x` within a 1024-byte aligned region as the 128-byte swizzle
// places it: its 16-byte chunk (bits 4-6) XORed with its row mod 8 (bits
// 7-9).
__device__ __forceinline__ int swizzle128(int x) {
  return x ^ ((x >> 3) & 0x70);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the phase's expected transactions.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the phase of parity `parity` has completed (phase k of a
// barrier has parity k & 1); traps after kSpinCycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > kSpinCycles) __trap();
}

// Box (x, y, z) of `map` into shared memory at `dst` (1024-byte aligned
// for the 128-byte swizzle), reported to `bar`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from `src` to `dst` (both
// 16-byte aligned), reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Box (x, y, z) of `map` from shared memory at `src` (1024-byte aligned
// for the 128-byte swizzle) to device memory, in the issuing thread's
// current bulk group; what lies outside the tensor is not written.
__device__ __forceinline__ void store_box(const CUtensorMap* map,
                                          const void* src, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Closes the issuing thread's bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of the issuing thread's bulk groups still read
// their shared memory (their sources may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of the issuing thread's bulk groups are
// incomplete (their writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1 to 15) of the first `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace tma
