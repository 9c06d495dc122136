// NV12 -> packed RGB / BGR at full resolution for Hopper (sm_90a).
//
// Replaces pallas_nv12_to_rgb / _pallas_nv12_to_rgb_jit
// (vali_tpu/ops/pallas_fused.py). For every pixel: chroma upsampled by
// nearest neighbour on both axes (pixel (x, y) reads the UV pair of
// (x/2, y/2)), the 3x3 CSC, round half to even, clip, three bytes out.
// The TPU kernel folds the upsample and the RGB interleave into selection-
// matrix products because Mosaic has no strided lane stores; the bf16
// route here runs the CSC itself on the tensor cores.
//
// What bounds it on this card: bytes. One 64 x 1080p batch reads 199 MB
// and writes 398 MB for ~9 FLOP per output byte, so the floor is 597 MB at
// 3.35 TB/s (~0.18 ms); one 1080p frame 9.3 MB, ~2.8 us.
//
// Routes, chosen here from the geometry alone before any launch:
//   - where TMA can describe the buffer and the output (width a multiple
//     of 16, 16-byte aligned starts, strides that are multiples of 16
//     bytes: convert_staged::tma_ok), the staged block of
//     convert_staged.cuh: persistent blocks walking 64-row x 128-pixel
//     tiles side by side, a TMA ring in, the packed output stored by TMA;
//     with bf16 coefficients (the default) the CSC as two m64n48k16 wgmma
//     a 16-pixel span (V = 1, the convert lab's V1), with f32 ones
//     channel()'s arithmetic on the CUDA cores (V = 0): f32 coefficients
//     times a uint8 sample are not exact in bf16, so they take no
//     tensor-core operand;
//   - any other geometry (an odd pitch, a width of 40): one thread a pixel
//     (nv12_to_rgb_scalar).
// A failed tensor-map encode or launch returns its error; nothing falls
// back to the other route.
//
// Arithmetic, in the order of the TPU kernel's matrix products: for output
// channel c, ((Y*m0 + (U*m1 + V*m2)) + off) with explicit __fmul_rn /
// __fadd_rn (no FMA contraction), then rintf and a clip to [0, 255]. The
// host passes m already in the compute type (bf16-rounded by default, so
// every product is exact in fp32) and the per-channel offset
// -(m0*y_off + (m1+m2)*128) computed from the unrounded matrix, rows
// already in output order (BGR swaps them). The bf16 route's products sum
// the same exact terms, so every route gives the same bits.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <limits.h>

#include "banded_common.cuh"
#include "convert_staged.cuh"

namespace {

constexpr int kThreads = 256;

struct Coef {
  convert_staged::Csc k;
  float off[3];
};

// One thread: one pixel; any even width and any strides.
__global__ void __launch_bounds__(kThreads)
nv12_to_rgb_scalar(const uint8_t* __restrict__ src, long long bs,
                   long long rs, int batch, int h, int w, Coef k,
                   uint8_t* __restrict__ out) {
  const long long total = static_cast<long long>(batch) * h * w;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = static_cast<int>(i % w);
  const long long fr = i / w;
  const int y = static_cast<int>(fr % h);
  const uint8_t* frame = src + (fr / h) * bs;
  const uint8_t* crow = frame + static_cast<long long>(h + y / 2) * rs;
  const float yv = static_cast<float>(
      __ldg(frame + static_cast<long long>(y) * rs + x));
  const float uv = static_cast<float>(__ldg(crow + (x & ~1)));
  const float vv = static_cast<float>(__ldg(crow + (x | 1)));
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * i + c] = static_cast<uint8_t>(
        convert_staged::channel(yv, uv, vv, k.k, k.off, c));
}

}  // namespace

extern "C" {

// Whether nv12_to_rgb_launch takes the staged TMA route for these
// arguments (1) or the per-pixel kernel (0).
int nv12_to_rgb_tma_route(const void* src, long long batch_stride,
                          long long row_stride, int w, const void* out) {
  return convert_staged::tma_ok(src, row_stride, batch_stride, w, out) ? 1
                                                                       : 0;
}

// `src` is frame 0 of a uint8 [B, rows, W] NV12 plane (rows >= H*3/2)
// with the given batch and row strides (bytes); `out` a contiguous uint8
// [B, H, 3W]. `coef` is a host array of 12 floats: the 3x3 matrix (row c =
// output channel c) in the compute type, then the three offsets. `f32`
// selects the compute type (0 bf16, 1 f32) and `table` is its table on the
// device (ops/nv12_to_rgb.py device_table): bf16 the B of the products
// (b_image), f32 the nine coefficients; the per-pixel route reads neither.
int nv12_to_rgb_launch(const void* src, long long batch_stride,
                       long long row_stride, int rows, int batch, int h,
                       int w, const float* coef, int f32, const void* table,
                       void* out, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (((h | w) & 1) || rows < h / 2 * 3 || (f32 != 0 && f32 != 1) ||
      w > INT_MAX / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (convert_staged::tma_ok(src, row_stride, batch_stride, w, out)) {
    using convert_staged::kBand;
    using convert_staged::kTileW;
    if (!banded::aligned16(table))
      return static_cast<int>(cudaErrorInvalidValue);
    const int bands = (h + kBand - 1) / kBand;
    const int tiles_w = (w + kTileW - 1) / kTileW;
    const long long tiles = static_cast<long long>(batch) * bands * tiles_w;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap in_map{}, out_map{};
    const int e = convert_staged::encode_maps(&in_map, &out_map, src,
                                              row_stride, batch_stride, rows,
                                              batch, h, w, out);
    if (e != 0) return e;
    return f32 ? convert_staged::launch<0>(in_map, out_map, h, w, bands,
                                           tiles_w, static_cast<int>(tiles),
                                           table, coef + 9, s)
               : convert_staged::launch<1>(in_map, out_map, h, w, bands,
                                           tiles_w, static_cast<int>(tiles),
                                           table, coef + 9, s);
  }
  Coef k;
  for (int i = 0; i < 9; ++i) k.k.m[i] = coef[i];
  for (int i = 0; i < 3; ++i) k.off[i] = coef[9 + i];
  const long long total = static_cast<long long>(batch) * h * w;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  nv12_to_rgb_scalar<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(src), batch_stride, row_stride, batch, h,
      w, k, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
