// Lab kernel S2 of the NV12 preprocess lab for Hopper (sm_90a): the
// preprocess on tall strips over aligned windows, both resize passes on
// the tensor cores with the strip height as wgmma's N, fed by a cp.async
// ring.
//
// Replaces static_kernel2 of bench_kernel_variants.py: on the TPU each
// strip of `tile` output rows multiplies [tile, win] weight blocks with a
// window of frame rows that starts on a multiple of `align` rows and has
// the plane's common length (every row of the strip runs over the whole
// window, zero taps included), then a dense W product. Its sweep asks
// what the strip height and the alignment cost the matrix unit; here the
// strip height T is N of both products, so the sweep also asks whether
// the tensor-core W pass pays per wgmma or per output tile.
//
// What bounds it on this card: the bytes (199 MB in, 9.6 MB out per
// 64 x 1080p -> 224 batch: 0.062 ms at 3.35 TB/s). The products it issues,
// zeros included, take 0.02-0.04 ms at 989 TFLOP/s bf16
// (lab/kernel_variants.py static2_work).
//
// Design. One block per (output tile of 64 columns, strip of T rows,
// frame), 256 threads: two warpgroups. The host builds once per geometry
// (ops/banded.py static2_tables, static2_w_tables):
//   - per strip, its luma window of ky rows and its chroma window of kc
//     interleaved chroma rows (the notebook's windows, each widened with
//     zero rows to a multiple of 16; rows past a plane read its last row
//     and weigh 0), and B_y = [ky, T], B_c = [kc, T] bf16 of the strip's
//     weights in wgmma's K-major core matrices;
//   - per tile, its first byte column x0 (a multiple of 32) and an even
//     number of chunks of 64 frame bytes that cover the luma and chroma
//     bands of its columns, and per chunk the tile's bf16 W weights in
//     register-fragment order: 4 luma k-steps (its 64 luma columns) and 2
//     chroma k-steps (its 32 chroma pixels), zeros outside the bands.
// The block streams its tile's bytes of both windows, stacked (ky + kc
// rows), through a ring of kStages stages of 128 columns by 16-byte
// cp.async copies issued two stages ahead (element loads where the rows
// are not 16-byte aligned); each warpgroup takes one chunk of a stage.
//   - H pass, the transposed product, two chains a chunk: D [64 columns,
//     T] = A [64, ky] x B_y and D [64 interleaved columns, T] = A [64, kc]
//     x B_c, wgmma m64nTk16 bf16 -> fp32, A built in registers from the
//     raw bytes (wgmma_common.cuh ring_step), kHBatch k-steps a batch and
//     one wait a batch, the rest one k-step a batch (no zero k-steps
//     issued). The sums round to bf16 (the notebook's cast point) into
//     the warpgroup's H rows of the chunk: T luma rows of 64 columns, T U
//     rows and T V rows of 32 pixels (the chroma sums deinterleaved as
//     they are stored), as 8 x 8 core matrices.
//   - W pass, streamed: right after a chunk's H rows, D_y [64 output
//     columns, T] += A (the chunk's 4 luma k-steps) x the luma H rows
//     (m64nTk16) and D_uv [64, 2T] += A (its 2 chroma k-steps) x the U
//     and V rows (m64n(2T)k16: one A of chroma weights serves both). The
//     accumulators stay in registers over the stages, so the H rows of a
//     whole band are never kept: a chunk's rows take 2.2-12.5 KB a
//     warpgroup, and the W pass runs while the ring's next stages are in
//     flight. The chunk's W weights are loaded before its H chains.
// Each warpgroup sums its own chunks; at the end each hands the other,
// through shared memory, the partial sums of the pixels the other
// finishes, adds the other's to its own, and runs the product's CSC,
// round and clip (banded_preprocess.cuh csc_store) on half the tile.
// The block's code is static2_passes.cuh's (the lab's prod_like,
// nv12_prodlike.cu, runs it too). The kernel is compiled per T (8 to 48
// in steps of 8); the k-step counts are run-time loops, so that no wgmma
// sits under a branch (ptxas serializes wgmmas whose A registers are
// written under one).
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order, and the two warpgroups' W sums
// meet at the end, so a sum may round apart from nv12_preprocess's FMA
// chain. The lab holds S2 to the kernels' uint8 envelope and counts its
// differing samples.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "static2_passes.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/static2_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass's conversion and products
// (3: the staging ring alone).
#ifndef NV12_STATIC2_KNOCKOUT
#define NV12_STATIC2_KNOCKOUT 0
#endif

namespace {

using banded::Geometry;
using banded::Tail;

constexpr int kKnockout = NV12_STATIC2_KNOCKOUT;
constexpr int kThreads = static2::kThreads;

// The block of static2_passes.cuh at N = the strip height T.
template <int T>
__global__ void __launch_bounds__(kThreads, T <= 16 ? 2 : 1)
nv12_static2_kernel(const uint8_t* __restrict__ src, long long bs,
                    long long rs, int vec, Tail tl, Geometry g,
                    const uint4* __restrict__ b_tiles,
                    const int2* __restrict__ starts, int ky, int kc,
                    const int4* __restrict__ heads,
                    const uint4* __restrict__ frags,
                    uint8_t* __restrict__ out) {
  static2::block<T, T, static2::kFull, kKnockout>(
      src, bs, rs, vec, tl, g, b_tiles, starts, ky, kc, heads, frags,
      nullptr, 0, out);
}

}  // namespace

extern "C" {

// S2 over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12 buffer
// with the given batch and row strides (bytes), on strips of `tile` output
// rows (8 to 48, a multiple of 8). tail: the 18 floats of ops/banded.py
// tail_params. b_tiles: [strips, (k_luma + k_chroma) * tile] bf16 on the
// device, per strip B_y then B_c in wgmma core-matrix order, strips =
// ceil(dst_h / tile); starts: [strips, 2] int32 on the device, the first
// row of each strip's luma window (k_luma rows) and chroma window (k_chroma
// interleaved chroma rows), both multiples of 16. w_heads: [ceil(dst_w /
// 64), 4] int32 on the device, per tile its first chunk, first byte column
// (a multiple of 32), chunks (even) and 0; w_frags: [chunks, 6, 128]
// 16-byte words on the device, the W weights (ops/banded.py
// static2_w_tables). out is a contiguous [batch, 3, dst_h, dst_w] uint8
// tensor.
int nv12_static2_launch(const void* src, long long batch_stride,
                        long long row_stride, int buf_rows, int batch,
                        int src_h, int src_w, int dst_h, int dst_w,
                        const float* tail, int tile, const void* b_tiles,
                        const int* starts, int k_luma, int k_chroma,
                        const int* w_heads, const void* w_frags, void* out,
                        void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  static2::Launch l;
  if (!static2::setup(l, src, batch_stride, row_stride, buf_rows, batch,
                      src_h, src_w, dst_h, dst_w, tail, tile, b_tiles,
                      starts, k_luma, k_chroma, w_heads, w_frags, out,
                      stream))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
#define NV12_STATIC2_TILE(t) \
  case t:                    \
    return static2::launch_full<t>(nv12_static2_kernel<t>, l);
    NV12_STATIC2_TILE(8) NV12_STATIC2_TILE(16) NV12_STATIC2_TILE(24)
    NV12_STATIC2_TILE(32) NV12_STATIC2_TILE(40) NV12_STATIC2_TILE(48)
#undef NV12_STATIC2_TILE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
