// Lab kernels V1 and V2 of the NV12 -> RGB convert lab for Hopper
// (sm_90a): the bf16-staged convert, its colour-space conversion run as
// wgmma products with both operands in shared memory.
//
// Replaces variant_kernel of convert_lab.py (V1, V2; def :84, pallas_call
// :156 and :166). On the TPU each variant casts a frame's luma, and its
// chroma replicated to full height by a 0/1 product, into bf16 scratch
// once, then runs the CSC as matrix-unit products over 128-pixel groups:
// V1 as luma @ Ag + chroma @ Bg, V2 as one K = 256 product over [luma 128
// | chroma 128] against [Ag; Bg]; then round and clip. Its question: what
// does the staged copy cost against the per-pixel conversion of
// nv12_to_rgb? Here the same experiment meets the tensor cores' operand:
// each sample is widened once into the layout wgmma reads A from, and the
// products run at wgmma's k16.
//
// The block (TMA ring, the widened operand, the products, the epilogue,
// the TMA store) is convert_staged.cuh's at V = 1 and 2, which describes
// the design; the product's nv12_to_rgb (nv12_to_rgb.cu) runs it at V = 1.
// This file holds the lab's launcher and a one-wgmma probe of the
// instances the block issues.
//
// The launcher encodes the frames' and the output's tensor maps on the
// host, returns cudaGetLastError() after the launch, runs on the caller's
// stream, and neither synchronises nor allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "banded_common.cuh"
#include "convert_staged.cuh"

namespace {

using convert_staged::kBLayer;
using convert_staged::kOperandBytes;
using wgmma::desc;
using wgmma::fence_proxy_async;

constexpr int kProbeWords = kOperandBytes / 16;  // the probe's A image

// One m64nNk16 wgmma with both operands in shared memory, A and B K-major,
// the first with scale-d 0 over NaN accumulators, TWICE a second with
// scale-d 1: the test of the instances the kernel issues
// (nv12_convert_staged_probe_launch).
template <int N, int TWICE>
__global__ void __launch_bounds__(128)
convert_staged_probe_kernel(const uint4* __restrict__ a_img, int a_words,
                            const uint4* __restrict__ b_img, int b_words,
                            int lbo, int sbo, float* __restrict__ d_out) {
  __shared__ __align__(128) uint4 a_s[kProbeWords];
  __shared__ __align__(128) uint4 b_s[kBLayer / 16];
  const int t = threadIdx.x;
  for (int i = t; i < a_words; i += 128) a_s[i] = __ldg(a_img + i);
  for (int i = t; i < b_words; i += 128) b_s[i] = __ldg(b_img + i);
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = __int_as_float(0x7FC00000);
  const uint64_t a = desc(a_s, lbo, sbo), b = desc(b_s, 128, 256);
  wgmma::fence();
  wgmma::mma_ss<N, 0, 0>(d, a, b);
  if constexpr (TWICE) wgmma::mma_ss<N, 0, 1>(d, a, b);
  wgmma::commit();
  convert_staged::wgmma_wait<0>();
  const int warp = t >> 5, gq = (t & 31) >> 2, tq = t & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d_out[(16 * warp + gq + 8 * (e >> 1)) * N + 8 * j + 2 * tq + (e & 1)] =
          d[4 * j + e];
}

}  // namespace

extern "C" {

// V1 (variant 1) or V2 (variant 2) of the staged convert: `src` is frame 0
// of a uint8 [batch, rows, w] NV12 buffer (rows >= h * 3 / 2) with the
// given batch and row strides (bytes; start and strides multiples of 16
// bytes, as TMA needs), `coef` a host array of 12 floats (nv12_to_rgb's:
// the 3x3 matrix, then the three offsets, read here), `b_tiles` the
// variant's B on the device (lab/convert_staged.py b_image: V1 Ag16 then
// Bg16, V2 ABg8, columns permuted, in K-major core matrices), `out` a
// contiguous uint8 [batch, h, 3w]. w a multiple of 16. One launch.
int nv12_convert_staged_launch(const void* src, long long batch_stride,
                               long long row_stride, int rows, int batch,
                               int h, int w, const float* coef, int variant,
                               const void* b_tiles, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (h <= 0 || w <= 0 || (h & 1) || w % 16 != 0 || rows < h * 3 / 2 ||
      (variant != 1 && variant != 2) ||
      !convert_staged::tma_ok(src, row_stride, batch_stride, w, out) ||
      !banded::aligned16(b_tiles) || w > INT_MAX / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  using convert_staged::kBand;
  using convert_staged::kTileW;
  const int bands = (h + kBand - 1) / kBand;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(batch) * bands * tiles_w;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap in_map{}, out_map{};
  const int e = convert_staged::encode_maps(&in_map, &out_map, src,
                                            row_stride, batch_stride, rows,
                                            batch, h, w, out);
  if (e != 0) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  return variant == 1
             ? convert_staged::launch<1>(in_map, out_map, h, w, bands,
                                         tiles_w, static_cast<int>(tiles),
                                         b_tiles, coef + 9, s)
             : convert_staged::launch<2>(in_map, out_map, h, w, bands,
                                         tiles_w, static_cast<int>(tiles),
                                         b_tiles, coef + 9, s);
}

// One m64nNk16 wgmma (n 24 or 48) with A and B K-major in shared memory,
// as the staged convert issues them: a_img (a_words 16-byte words, at most
// an operand's 2056) is copied into shared memory as it is and read through a
// descriptor with the given leading and stride byte offsets; b_img (b_words
// words, at most 96) [16, n] bf16 in K-major core matrices (leading byte
// offset 128, stride 256). The product runs with scale-d 0 over NaN
// accumulators, and with `twice` once more with scale-d 1. d_out: [64, n]
// float32, row-major.
int nv12_convert_staged_probe_launch(const void* a_img, int a_words,
                                     const void* b_img, int b_words, int n,
                                     int twice, int lbo, int sbo,
                                     void* d_out, void* stream) {
  if (a_words < 1 || a_words > kProbeWords || b_words < 1 ||
      b_words > kBLayer / 16 || (n != 24 && n != 48) || lbo < 16 ||
      lbo % 16 != 0 || sbo < 16 || sbo % 16 != 0 ||
      !banded::aligned16(a_img) || !banded::aligned16(b_img))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern =
      n == 24 ? (twice ? convert_staged_probe_kernel<24, 1>
                       : convert_staged_probe_kernel<24, 0>)
              : (twice ? convert_staged_probe_kernel<48, 1>
                       : convert_staged_probe_kernel<48, 0>);
  kern<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_img), a_words,
      static_cast<const uint4*>(b_img), b_words, lbo, sbo,
      static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
