// Lab kernels S / Slong and T of the NV12 preprocess lab for Hopper
// (sm_90a): S2's tensor-core block (static2_passes.cuh) with the cast
// chain of its H chains' A fragments or the layout of its chroma H rows
// changed, each a template parameter of the block.
//
// Replaces two kernels of bench_kernel_variants.py:
//   static_kernel            -> nv12_chains_launch, S (short_chain 1) and
//                               Slong (0). On the TPU the window starts
//                               are trace-time constants and the frame
//                               rows are cast u8 -> i32 -> bf16 (S) or
//                               u8 -> i32 -> f32 -> bf16 (Slong) before
//                               the H product.
//   transposed_chroma_kernel -> nv12_tchroma_launch, T. On the TPU the
//                               interleaved chroma H rows are transposed,
//                               split into even and odd sublanes (U, V)
//                               and each multiplied by half the chroma W
//                               weights.
// Both ran on 32-row strips over windows aligned to 8 rows (the TPU's
// TILE and ALIGN): S2 t32a8's windows. Each launcher runs them at 32 rows
// and at S2's best strip, 16.
//
// What the TPU's questions become on this card. S2's block reads each
// strip's window start once a block (8 bytes) and its H weights as
// wgmma's B from shared memory, so static starts leave nothing to hold in
// a constant bank; what S and Slong vary is the chain that builds the H
// chains' A registers from the raw ring bytes (wgmma_common.cuh Chain):
// kShort, one cvt.rn.bf16.s32 an element and a prmt a pair; kLong,
// cvt.rn.f32.s32 an element and cvt.rn.bf16x2.f32 a pair. S2's own
// kMagic (an f32 add of 2^23 an element) stays S2's. S2's chroma W pass
// already runs the half contraction (one A of chroma weights for U and V,
// m64n(2N)k16); what T varies is the layout of the chroma H rows it
// reads: kept interleaved as the chroma chain leaves them, the W operand
// MN-major (imm-trans-b), where S2 deinterleaves them into K-major U and
// V rows with four 2-byte stores a thread a row group (T: two 4-byte
// stores). The epilogue changes only compile-time indices.
//
// What bounds them: the bytes (199 MB in, 9.6 MB out per 64 x 1080p ->
// 224 batch: 0.062 ms at 3.35 TB/s); the products, zeros included, take
// 0.020 ms (16 rows, 20.1 GFLOP) and 0.029 ms (32 rows, 28.6 GFLOP) at
// 989 TFLOP/s bf16 (lab/kernel_variants.py static2_work).
//
// Bits: every uint8 is exact in bf16, so the three chains give equal A
// registers; T's W operand holds the same bf16 values at other addresses.
// Each arm gives S2's bits at the same strip (nv12_static2.cu), within the
// kernels' uint8 envelope of nv12_preprocess.
//
// nv12_chains_probe_launch runs one m64nNk16 wgmma with A from registers
// and B from shared memory by descriptor, K-major or MN-major, so that a
// card test pins the descriptor's offsets of T's operand at N = 32 and 64.
//
// Each launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "static2_passes.cuh"

namespace {

using banded::aligned16;
using banded::Geometry;
using banded::Tail;
using static2::kFull;
using static2::kSplit;
using static2::kTransposed;
using static2::Launch;
using static2::launch_full;
using static2::setup;
using wgmma::kLong;
using wgmma::kMagic;
using wgmma::kShort;

constexpr int kThreads = static2::kThreads;

// S2's block at N = the strip height T with the cast chain CHAIN and the
// chroma layout CLAYOUT; two blocks an SM where S2 takes two (T <= 16).
template <int T, int CHAIN, int CLAYOUT>
__global__ void __launch_bounds__(kThreads, T <= 16 ? 2 : 1)
nv12_chains_kernel(const uint8_t* __restrict__ src, long long bs,
                   long long rs, int vec, Tail tl, Geometry g,
                   const uint4* __restrict__ b_tiles,
                   const int2* __restrict__ starts, int ky, int kc,
                   const int4* __restrict__ heads,
                   const uint4* __restrict__ frags,
                   uint8_t* __restrict__ out) {
  static2::block<T, T, kFull, 0, CHAIN, CLAYOUT>(
      src, bs, rs, vec, tl, g, b_tiles, starts, ky, kc, heads, frags,
      nullptr, 0, out);
}

// The strip heights each launcher runs.
template <int CHAIN, int CLAYOUT>
int launch_tile(const Launch& l) {
  switch (l.g.rows) {
    case 16:
      return launch_full<16>(nv12_chains_kernel<16, CHAIN, CLAYOUT>, l);
    case 32:
      return launch_full<32>(nv12_chains_kernel<32, CHAIN, CLAYOUT>, l);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One m64nNk16 wgmma: d_out [64, N] fp32 = A (a_frags: 128 16-byte
// register fragments, thread t's at t) x B (b_img: b_words 16-byte words
// copied to shared memory, read through desc(lbo, sbo), MN-major when
// TB).
constexpr int kProbeWords = 256;

template <int N, int TB>
__global__ void __launch_bounds__(128)
chains_probe_kernel(const uint4* __restrict__ a_frags,
                    const uint4* __restrict__ b_img, int b_words, int lbo,
                    int sbo, float* __restrict__ d_out) {
  __shared__ __align__(128) uint4 b_s[kProbeWords];
  const int t = threadIdx.x;
  for (int i = t; i < b_words; i += 128) b_s[i] = b_img[i];
  wgmma::fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  const uint4 a = a_frags[t];
  wgmma::fence();
  wgmma::mma<N, TB>(d, a, wgmma::desc(b_s, lbo, sbo));
  wgmma::commit();
  wgmma::wait_all();
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

// S (short_chain 1: u8 -> i32 -> bf16) or Slong (0: u8 -> i32 -> f32 ->
// bf16) over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes), on strips of
// `tile` output rows (16 or 32), with S2's tables at (tile, align 8) as
// nv12_static2_launch takes them: tail the 18 floats of ops/banded.py
// tail_params; b_tiles [strips, (k_luma + k_chroma) * tile] bf16 on the
// device, per strip B_y then B_c in wgmma core-matrix order; starts
// [strips, 2] int32 on the device, the first row of each strip's luma and
// chroma window; w_heads [ceil(dst_w / 64), 4] int32 and w_frags [chunks,
// 6, 128] 16-byte words on the device (ops/banded.py static2_w_tables).
// out is a contiguous [batch, 3, dst_h, dst_w] uint8 tensor.
int nv12_chains_launch(const void* src, long long batch_stride,
                       long long row_stride, int buf_rows, int batch,
                       int src_h, int src_w, int dst_h, int dst_w,
                       const float* tail, int short_chain, int tile,
                       const void* b_tiles, const int* starts, int k_luma,
                       int k_chroma, const int* w_heads, const void* w_frags,
                       void* out, void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  Launch l;
  if (!setup(l, src, batch_stride, row_stride, buf_rows, batch, src_h,
             src_w, dst_h, dst_w, tail, tile, b_tiles, starts, k_luma,
             k_chroma, w_heads, w_frags, out, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  return short_chain ? launch_tile<kShort, kSplit>(l)
                     : launch_tile<kLong, kSplit>(l);
}

// T over `src` as nv12_chains_launch takes it: S2's cast chain, the
// chroma H rows kept interleaved and read MN-major by the chroma W pass.
int nv12_tchroma_launch(const void* src, long long batch_stride,
                        long long row_stride, int buf_rows, int batch,
                        int src_h, int src_w, int dst_h, int dst_w,
                        const float* tail, int tile, const void* b_tiles,
                        const int* starts, int k_luma, int k_chroma,
                        const int* w_heads, const void* w_frags, void* out,
                        void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  Launch l;
  if (!setup(l, src, batch_stride, row_stride, buf_rows, batch, src_h,
             src_w, dst_h, dst_w, tail, tile, b_tiles, starts, k_luma,
             k_chroma, w_heads, w_frags, out, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<kMagic, kTransposed>(l);
}

// One m64nNk16 wgmma (n = 32 or 64, T's chroma W products at 16- and
// 32-row strips) into d_out [64, n] fp32 on the device: A from a_frags
// (128 16-byte words on the device, thread t's register fragment at t), B
// [16, n] bf16 from b_img (b_words <= 256 16-byte words on the device,
// copied to shared memory) through a descriptor of leading byte offset
// lbo and stride byte offset sbo, MN-major when trans_b (else K-major).
int nv12_chains_probe_launch(const void* a_frags, const void* b_img,
                             int b_words, int n, int trans_b, int lbo,
                             int sbo, void* d_out, void* stream) {
  if (b_words < 1 || b_words > kProbeWords || lbo < 16 || lbo % 16 != 0 ||
      sbo < 16 || sbo % 16 != 0 || !aligned16(a_frags) ||
      !aligned16(b_img) || (n != 32 && n != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = n == 32 ? (trans_b ? chains_probe_kernel<32, 1>
                                       : chains_probe_kernel<32, 0>)
                            : (trans_b ? chains_probe_kernel<64, 1>
                                       : chains_probe_kernel<64, 0>);
  kern<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_frags), static_cast<const uint4*>(b_img),
      b_words, lbo, sbo, static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
