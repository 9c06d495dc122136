// Lab kernel prod_like of the NV12 preprocess lab for Hopper (sm_90a):
// S2's tensor-core block (nv12_static2.cu) with its phases knocked out,
// each knock-out a defined function whose bits the lab checks.
//
// Replaces prod_like of bench_kernel_variants.py: on the TPU the product
// kernel's structure at an H-pass tile T (its windows under TILE = T and
// ALIGN = 8, zero taps included; the window starts scalar-prefetched) in
// three modes that divide its time between its phases (main_modes):
//   full   the whole function: S2 at (T, 8). At S2's strip heights the
//          wrapper launches S2 itself (nv12_static2.cu); this source
//          runs the one height S2 has no instance for, T = 4;
//   hpass  the H pass alone: out[c] = clip(round(yh[:DH, :DW] + ch[:DH,
//          :DW])) on all three channels, ch the interleaved chroma H row;
//   wpass  no H pass: yh = bf16(frame rows 0 .. DH - 1), ch = bf16(the
//          buffer's last DH rows, as given), then the W pass and tail.
//
// What bounds it on this card: the bytes. Per 64 x 1080p -> 224 batch
// (9.6 MB out): full reads the NV12 frames (199 MB in: 0.062 ms at 3.35
// TB/s); hpass's output needs only the luma and chroma bytes below
// column DW (23 MB: 0.0098 ms), though it issues every H chain of the
// frame; wpass reads two DH-row slabs (55 MB: 0.019 ms). The products
// the function needs, zeros included, take 0.001-0.03 ms at 989 TFLOP/s
// bf16 (lab/kernel_variants.py prodlike_work).
//
// Design: S2's block (static2_passes.cuh), one block per (64-column output
// tile, strip of T rows, frame), two warpgroups, the stacked windows
// through S2's cp.async ring, the transposed H product m64nNk16 with A
// built in registers from the raw ring, the W pass streamed chunk by chunk
// at N and 2 N. MODE selects what the block issues:
//   full   every instruction of S2, on 4-row strips at N = 8 (wgmma has
//          no N = 4): B_y and B_c widened with zero columns 4-7
//          (lab/prodlike.py prodlike_b), the sums of rows 4-7 zero and
//          never stored.
//   hpass  every H chain full issues (every chunk of every tile, every
//          k-step), no W product and no trade. The chroma sums stay
//          interleaved: a thread holds the luma and the chroma sums of the
//          same two byte columns, rounds each to bf16 and stores clip(round(
//          yh + ch)) from registers. A frame column p < DW is stored by the
//          block of the lowest tile whose chunks hold p (owned[tile], from
//          lab/prodlike.py hpass_owners), so every sample once.
//   wpass  no H chain and no B: the ring carries, for the tile's chunks,
//          the strip's T frame rows o0 .. and T rows from buf_rows - DH +
//          o0 (rows past the buffer read its last row and are not stored),
//          each byte read from the ring as the H chain's sums would sit
//          (exact in bf16) and stored as S2 stores its H rows: luma rows,
//          U from the even bytes and V from the odd. Then S2's W pass,
//          trade and tail.
// Instances: full at T = 4; hpass and wpass at 16 and 32. T = 64 does not
// fit a block (S2's layout needs 303,488 B at 1080p -> 224);
// lab/prodlike.py prodlike_refusal refuses it.
//
// Bits: each mode sums the same bf16 x uint8 products as its plain
// version (kernel_variants.prod_like_plain) in the tensor cores' order:
// full4 and wpass within the kernels' uint8 envelope, hpass, which adds
// two bf16 sums, within kernel_variants.hpass_tolerance.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "static2_passes.cuh"

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tail;
using static2::kFull;
using static2::kHpass;
using static2::kWpass;

constexpr int kThreads = static2::kThreads;

// The block of static2_passes.cuh at wgmma's N, strips of STRIP rows, in
// MODE; two blocks an SM where S2 takes two (N <= 16).
template <int N, int STRIP, int MODE>
__global__ void __launch_bounds__(kThreads, N <= 16 ? 2 : 1)
nv12_prodlike_kernel(const uint8_t* __restrict__ src, long long bs,
                     long long rs, int vec, Tail tl, Geometry g,
                     const uint4* __restrict__ b_tiles,
                     const int2* __restrict__ starts, int ky, int kc,
                     const int4* __restrict__ heads,
                     const uint4* __restrict__ frags,
                     const int2* __restrict__ owned, int buf_rows,
                     uint8_t* __restrict__ out) {
  static2::block<N, STRIP, MODE, 0>(src, bs, rs, vec, tl, g, b_tiles, starts,
                                    ky, kc, heads, frags, owned, buf_rows,
                                    out);
}

template <int N, int STRIP, int MODE>
cudaError_t launch_p(int tiles, int batch, cudaStream_t stream,
                     const uint8_t* src, long long bs, long long rs, int vec,
                     const Tail& tl, const Geometry& g, const uint4* b,
                     const int2* starts, int ky, int kc, const int4* heads,
                     const uint4* frags, const int2* owned, int buf_rows,
                     uint8_t* out) {
  const long long smem = static2::smem_bytes<N, MODE>(ky + kc);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const auto kern = nv12_prodlike_kernel<N, STRIP, MODE>;
  const cudaError_t e = allow_smem(kern, static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  const int strips = (g.dst_h + STRIP - 1) / STRIP;
  kern<<<dim3(tiles, strips, batch), kThreads, static_cast<size_t>(smem),
         stream>>>(src, bs, rs, vec, tl, g, b, starts, ky, kc, heads, frags,
                   owned, buf_rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// prod_like over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes), in `mode` (0 full,
// 1 hpass, 2 wpass) on strips of `tile` output rows: full at 4, hpass and
// wpass at 16 and 32. tail: the 18 floats of
// ops/banded.py tail_params. full and hpass: b_tiles [strips, (k_luma +
// k_chroma) * N] bf16 on the device (N = max(tile, 8)), per strip B_y then
// B_c in wgmma core-matrix order (lab/prodlike.py prodlike_b), starts
// [strips, 2] int32 on the device, the first row of each strip's luma
// window (k_luma rows) and chroma window (k_chroma interleaved chroma
// rows); wpass ignores them and k_luma, k_chroma. w_heads [ceil(dst_w /
// 64), 4] int32 and w_frags [chunks, 6, 128] 16-byte words on the device:
// S2's W tables (ops/banded.py static2_w_tables); hpass reads only the
// heads. owned (hpass only) [ceil(dst_w / 64), 2] int32 on the device: the
// frame columns [lo, hi) each tile's block stores. out is a contiguous
// [batch, 3, dst_h, dst_w] uint8 tensor.
int nv12_prodlike_launch(const void* src, long long batch_stride,
                         long long row_stride, int buf_rows, int batch,
                         int src_h, int src_w, int dst_h, int dst_w,
                         const float* tail, int mode, int tile,
                         const void* b_tiles, const int* starts, int k_luma,
                         int k_chroma, const int* w_heads,
                         const void* w_frags, const int* owned, void* out,
                         void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (mode == kWpass) k_luma = k_chroma = tile;
  const int strips = tile > 0 ? (dst_h + tile - 1) / tile : 0;
  if (batch > 65535 || strips > 65535 || src_w <= 0 || (src_w & 1) ||
      src_h < 2 || buf_rows < src_h * 3 / 2 || k_luma < 16 ||
      k_luma % 16 != 0 || k_chroma < 16 || k_chroma % 16 != 0 ||
      !aligned16(w_heads) ||
      (mode != kHpass && !aligned16(w_frags)) ||
      (mode != kWpass && (!aligned16(b_tiles) ||
                          (reinterpret_cast<uintptr_t>(starts) & 7))) ||
      (mode == kHpass &&
       (dst_w > src_w || (reinterpret_cast<uintptr_t>(owned) & 7) ||
        owned == nullptr)) ||
      (mode == kWpass && dst_h > buf_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = tile;
  const Tail tl = banded::unpack_tail(tail);
  const int vec = aligned16(src) && src_w % 16 == 0 &&
                  batch_stride % 16 == 0 && row_stride % 16 == 0;
  const int tiles = (dst_w + 63) / 64;
  auto go = [&](auto n, auto strip, auto m) {
    return static_cast<int>(
        launch_p<decltype(n)::value, decltype(strip)::value,
                 decltype(m)::value>(
            tiles, batch, static_cast<cudaStream_t>(stream),
            static_cast<const uint8_t*>(src), batch_stride, row_stride, vec,
            tl, g, static_cast<const uint4*>(b_tiles),
            reinterpret_cast<const int2*>(starts), k_luma, k_chroma,
            reinterpret_cast<const int4*>(w_heads),
            static_cast<const uint4*>(w_frags),
            reinterpret_cast<const int2*>(owned), buf_rows,
            static_cast<uint8_t*>(out)));
  };
  using std::integral_constant;
#define NV12_PRODLIKE(m, n, t)                                      \
  case 1000 * m + t:                                                \
    return go(integral_constant<int, n>(), integral_constant<int, t>(), \
              integral_constant<int, m>());
  switch (1000 * mode + tile) {
    NV12_PRODLIKE(kFull, 8, 4)
    NV12_PRODLIKE(kHpass, 16, 16)
    NV12_PRODLIKE(kHpass, 32, 32)
    NV12_PRODLIKE(kWpass, 16, 16)
    NV12_PRODLIKE(kWpass, 32, 32)
  }
#undef NV12_PRODLIKE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
