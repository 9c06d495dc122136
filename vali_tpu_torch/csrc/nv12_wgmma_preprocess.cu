// The fused NV12 preprocess on the tensor cores (sm_90a): the uint8 ->
// uint8, bfloat16-compute route of ops/nv12_preprocess.py, on the block of
// static2_passes.cuh at 16-row strips with the chroma H rows kept
// interleaved (the labs' T16, nv12_chains.cu nv12_tchroma_launch at tile
// 16, bit for bit). Every other input of nv12_preprocess (uint16 samples,
// float32 compute, float outputs, normalisation, a geometry the block
// refuses) runs the FMA kernel of banded_preprocess.cu; the two share the
// product's tail (banded_preprocess.cuh csc_store) and ops/banded.py's
// band tables.
//
// What bounds it: the bytes (199 MB in, 9.6 MB out per 64 x 1080p -> 224
// batch: 0.062 ms at 3.35 TB/s); its products, zeros included, take 0.020
// ms at 989 TFLOP/s bf16 (20.1 GFLOP issued).
//
// Design (nv12_static2.cu describes the block, nv12_chains.cu its chroma
// layout): one block per (output tile of 64 columns, strip of 16 rows,
// frame), 256 threads in two warpgroups, two blocks an SM. The host builds
// once per geometry and method (ops/banded.py static2_device_tables at
// strip 16, windows aligned to 8 rows): per strip its luma and chroma
// windows and B = the strip's bf16 row weights in wgmma's core matrices;
// per tile the chunks of 64 frame bytes its columns read and their bf16 W
// weights as register fragments. The block streams its tile's bytes of
// both windows through a 3-stage cp.async ring; per chunk two H chains
// (m64n16k16, A built in registers from the raw bytes by S2's magic add)
// round to bf16 into the warpgroup's H rows, the chroma sums left
// interleaved and read MN-major by the chroma W product (m64n32k16, one A
// for U and V), the luma W product m64n16k16; the W sums stay in
// registers over the stages, the two warpgroups trade their partial sums
// at the end and each runs the CSC, round and clip on half the tile.
//
// The kernel's name is part of the benchmark's yardstick: its profiler
// name, preprocess_kernel<16, 0> (strip rows, then the chroma layout
// banded::kNV12 as a plain int), is what
// perfbench/metrics/nv12_preprocess_roofline.py finds, one launch a call.
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order and the warpgroups' W sums meet
// at the end, so a sum may round apart from the FMA kernel's chain: within
// the kernels' uint8 envelope (1 LSB on fewer than 1e-3 of the samples).
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "static2_passes.cuh"

namespace nv12_wgmma {
// Internal linkage, as static2_passes.cuh's: the labs' library runs the
// same block.
namespace {

using banded::Geometry;
using banded::Tail;

constexpr int kStrip = 16;

// The block at N = STRIP, T's chroma layout, S2's cast chain; L is the
// chroma layout (banded::kNV12 only), a plain int so that the profiler's
// name of the kernel holds no cast.
template <int STRIP, int L>
__global__ void __launch_bounds__(static2::kThreads, 2)
preprocess_kernel(const uint8_t* __restrict__ src, long long bs,
                  long long rs, int vec, Tail tl, Geometry g,
                  const uint4* __restrict__ b_tiles,
                  const int2* __restrict__ starts, int ky, int kc,
                  const int4* __restrict__ heads,
                  const uint4* __restrict__ frags,
                  uint8_t* __restrict__ out) {
  static_assert(L == banded::kNV12, "NV12's interleaved chroma rows only");
  static2::block<STRIP, STRIP, static2::kFull, 0, wgmma::kMagic,
                 static2::kTransposed>(src, bs, rs, vec, tl, g, b_tiles,
                                       starts, ky, kc, heads, frags,
                                       nullptr, 0, out);
}

}  // namespace
}  // namespace nv12_wgmma

extern "C" {

// nv12_preprocess's tensor-core route over `src`, frame 0 of a [batch,
// buf_rows, src_w] uint8 NV12 buffer with the given batch and row strides
// (bytes), into `out`, a contiguous [batch, 3, dst_h, dst_w] uint8 tensor.
// tail: the 18 floats of ops/banded.py tail_params (uint8 output, no
// normalisation). The tables are ops/banded.py static2_device_tables at
// strip 16 on the device: b_tiles [strips, (k_luma + k_chroma) * 16] bf16,
// per strip B_y then B_c in wgmma core-matrix order, strips =
// ceil(dst_h / 16); starts [strips, 2] int32, the first row of each
// strip's luma window (k_luma rows) and chroma window (k_chroma
// interleaved chroma rows); w_heads [ceil(dst_w / 64), 4] int32 and
// w_frags [chunks, 6, 128] 16-byte words, the W pass.
int nv12_wgmma_preprocess_launch(const void* src, long long batch_stride,
                                 long long row_stride, int buf_rows,
                                 int batch, int src_h, int src_w, int dst_h,
                                 int dst_w, const float* tail,
                                 const void* b_tiles, const int* starts,
                                 int k_luma, int k_chroma, const int* w_heads,
                                 const void* w_frags, void* out,
                                 void* stream) {
  using nv12_wgmma::kStrip;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  static2::Launch l;
  if (!static2::setup(l, src, batch_stride, row_stride, buf_rows, batch,
                      src_h, src_w, dst_h, dst_w, tail, kStrip, b_tiles,
                      starts, k_luma, k_chroma, w_heads, w_frags, out,
                      stream))
    return static_cast<int>(cudaErrorInvalidValue);
  return static2::launch_full<kStrip>(
      nv12_wgmma::preprocess_kernel<kStrip, banded::kNV12>, l);
}

}  // extern "C"
