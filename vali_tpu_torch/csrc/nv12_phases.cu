// Lab kernel `variant` of the 4K NV12 resize lab for Hopper (sm_90a):
// aligned's tensor-core block (aligned_block.cuh, nv12_aligned.cu at
// h_align 8, w_align 32) with a phase knocked out, each mode a defined
// function whose bits the lab checks.
//
// Replaces variant of resize_diag.py: on the TPU the production kernel's
// structure with its H pass (banded MXU dots of luma and chroma into bf16
// scratch), its luma W pass, or both knocked out, so that the modes divide
// the kernel's time between the input DMA, the H pass and the W pass:
//   both      the luma resize: out = the luma rows of aligned8x32, while
//             the chroma H products are computed and dropped (the
//             notebook computes ch and writes no chroma);
//   h_only    both planes' H products, no W product: output lanes below
//             LANE_TILE hold the luma H rows truncated to int32 and cut to
//             their low byte, the rest 0;
//   w_only    no H product: the luma W pass over H rows equal to the
//             frame's first TILE buffer rows as bf16, then zeros;
//   dma_only  the frame's first TILE rows x LANE_TILE lanes, the rest 0.
// What a mode drops goes into a sink of int32 words, so that no load or
// product is dead code: the H values (h_only: both planes; both: chroma)
// or, in w_only and dma_only, the bytes of both planes, each byte by one
// block (the host's partition): after a call on a zeroed sink the XOR of
// its words is the XOR of every 32-bit word of the frames. So w_only -
// dma_only and h_only - dma_only are the W and H passes' costs over a
// stream of the same bytes.
//
// What bounds it on this card: the bytes, 199 MB of frames and 33 MB of
// luma rows a 16 x 4K -> 1080p batch (0.069 ms at 3.35 TB/s); the products
// each mode issues, zeros included (lab/resize_diag.py phases_work), take
// 0.013 (w_only) to 0.030 ms (both) at 989 TFLOP/s bf16.
//
// Design: aligned's block, one launch a plane, blocks of (column range,
// 32-row strip, frame), two blocks an SM, the window streamed by the
// cp.async ring; each mode is an instance of the block's template:
//   both      luma kFull (aligned's instructions), chroma kHOnly;
//   h_only    luma and chroma kHOnly: aligned's H pass into its bf16 H
//             rows, then every H value XORed into the sink; the blocks that
//             own the output pixels below LANE_TILE (the host's h_owned,
//             the lowest range whose H columns hold a pixel) store them
//             from those H rows, the other pixels of a range's tiles are 0;
//   w_only    luma kWOnly (the ring's owned bytes into the sink; H rows of
//             strip 0 the frame's first rows, of the others zeros; the W
//             tiles), chroma kDma;
//   dma_only  luma and chroma kDma: the ring and the sink; luma writes the
//             corner.
// The modes with H products are compiled per K / 16 (NK) and plane, so
// that no wgmma sits under a branch; the others once a plane, k_pad read
// at run time.
//
// Bits: both is aligned8x32's luma rows bit for bit; w_only sums the same
// bf16 products as its plain version in the tensor cores' order (the
// kernels' uint8 envelope); h_only's bf16 H sums may round one ulp apart
// from the plain version's, which the low byte turns into 1, or 255 for
// 255 against 256 (lab/resize_diag.py h_only_tolerance); dma_only copies.
//
// The launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_block.cuh"

namespace {

using aligned::Knock;
using aligned::kRows;
using aligned::kThreads;
using aligned::Plane;
using aligned::smem_bytes;
using aligned::Tables;

constexpr int kTile = 32;        // TILE: frame rows the knock-outs keep
constexpr int kLaneTile = 128;   // LANE_TILE: lanes of h_only, dma_only

template <int NK, int CH, int MODE>
__global__ void __launch_bounds__(kThreads, 2) phases_kernel(Plane p,
                                                             Knock kn) {
  aligned::block<NK, CH, MODE>(p, kn);
}

// One plane's launch in MODE; `resident` gets the blocks an SM can hold.
template <int NK, int CH, int MODE>
cudaError_t launch_nk(const Plane& p, const Knock& kn, int nranges,
                      int batch, int* resident, cudaStream_t stream) {
  const auto kern = phases_kernel<NK, CH, MODE>;
  const size_t smem = static_cast<size_t>(smem_bytes(CH, p.hcols, p.k_pad));
  cudaError_t e = banded::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  if (resident) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
  }
  if (batch <= 0) return cudaSuccess;
  const dim3 grid(nranges, (p.dst_rows + kRows - 1) / kRows, batch);
  kern<<<grid, kThreads, smem, stream>>>(p, kn);
  return cudaGetLastError();
}

// MODE's instance at the plane's K (MODE with H products), or its one.
template <int CH, int MODE>
cudaError_t launch_plane(const Plane& p, const Knock& kn, int nranges,
                         int batch, int* resident, cudaStream_t stream) {
  if constexpr (MODE == aligned::kWOnly || MODE == aligned::kDma) {
    return launch_nk<0, CH, MODE>(p, kn, nranges, batch, resident, stream);
  } else {
    switch (p.k_pad / 16) {
#define NV12_PHASES_NK(n) \
  case n:                 \
    return launch_nk<n, CH, MODE>(p, kn, nranges, batch, resident, stream);
      NV12_PHASES_NK(1) NV12_PHASES_NK(2) NV12_PHASES_NK(3)
      NV12_PHASES_NK(4) NV12_PHASES_NK(5) NV12_PHASES_NK(6)
      NV12_PHASES_NK(7) NV12_PHASES_NK(8) NV12_PHASES_NK(9)
      NV12_PHASES_NK(10) NV12_PHASES_NK(11) NV12_PHASES_NK(12)
      NV12_PHASES_NK(13) NV12_PHASES_NK(14) NV12_PHASES_NK(15)
      NV12_PHASES_NK(16)
#undef NV12_PHASES_NK
    }
    return cudaErrorInvalidValue;
  }
}

// The luma launch in YM, then the chroma launch in CM.
template <int YM, int CM>
cudaError_t launch_mode(const Plane& y, const Knock& ky, int y_nranges,
                        const Plane& c, const Knock& kc, int c_nranges,
                        int batch, int* resident, cudaStream_t stream) {
  const cudaError_t e = launch_plane<1, YM>(y, ky, y_nranges, batch,
                                            resident, stream);
  if (e != cudaSuccess) return e;
  return launch_plane<2, CM>(c, kc, c_nranges, batch,
                             resident ? resident + 1 : nullptr, stream);
}

}  // namespace

extern "C" {

// The notebook's `variant` knock-outs over frame 0 of a [batch, >= src_h *
// 3 / 2, src_w] uint8 NV12 buffer with the given batch and row strides
// (bytes) into a contiguous [batch, dst_h, dst_w] uint8 tensor (luma
// only): mode 0 both, 1 h_only, 2 w_only, 3 dma_only (lab/resize_diag.py
// resize_phases). Per plane aligned's tables at 8x32, as
// nv12_resize_aligned_launch takes them, then the sink's partition:
// own_rows [strips, 2] and own_cols [ranges, 2] int32 per plane, and
// h_owned [luma ranges, 2] int32 (lab/resize_diag.py phases_tables). Each
// block XORs what its mode drops into sink[block % sink_words] (int32
// words, not cleared here). `resident` (may be null) gets the blocks an SM
// holds of the luma and the chroma launch; batch 0 launches nothing. Two
// launches.
int nv12_resize_phases_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_ranges, int y_nranges,
    int y_hcols, const int* y_heads, const void* y_frags, const void* c_b,
    const int* c_starts, int c_k_pad, const int* c_ranges, int c_nranges,
    int c_hcols, const int* c_heads, const void* c_frags,
    const int* y_own_rows, const int* y_own_cols, const int* c_own_rows,
    const int* c_own_cols, const int* h_owned, int mode, void* sink,
    int sink_words, int* resident, void* out, void* stream) {
  if (batch < 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const Tables yt{y_b, y_starts, y_k_pad, y_ranges, y_nranges, y_hcols,
                  y_heads, y_frags};
  const Tables ct{c_b, c_starts, c_k_pad, c_ranges, c_nranges, c_hcols,
                  c_heads, c_frags};
  Plane y, c;
  if (batch > 65535 || mode < 0 || mode > 3 || sink == nullptr ||
      sink_words < 1 || y_own_rows == nullptr || y_own_cols == nullptr ||
      c_own_rows == nullptr || c_own_cols == nullptr || h_owned == nullptr ||
      !aligned::nv12_planes(y, c, src, batch_stride, row_stride, src_h,
                            src_w, dst_h, dst_w, yt, ct, out, nullptr,
                            static_cast<long long>(dst_h) * dst_w) ||
      !aligned::plane_ok(y, y_nranges, smem_bytes(1, y.hcols, y.k_pad)) ||
      !aligned::plane_ok(c, c_nranges, smem_bytes(2, c.hcols, c.k_pad)))
    return static_cast<int>(cudaErrorInvalidValue);
  Knock ky;
  ky.sink = static_cast<unsigned*>(sink);
  ky.sink_words = sink_words;
  ky.own_rows = reinterpret_cast<const int2*>(y_own_rows);
  ky.own_cols = reinterpret_cast<const int2*>(y_own_cols);
  ky.h_owned = reinterpret_cast<const int2*>(h_owned);
  ky.rows_out = min(kTile, min(dst_h, src_h * 3 / 2));
  ky.lanes_out = min(kLaneTile, min(dst_w, src_w));
  Knock kc = ky;
  kc.own_rows = reinterpret_cast<const int2*>(c_own_rows);
  kc.own_cols = reinterpret_cast<const int2*>(c_own_cols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using aligned::kDma;
  using aligned::kFull;
  using aligned::kHOnly;
  using aligned::kWOnly;
  cudaError_t e;
  switch (mode) {
    case 0:
      e = launch_mode<kFull, kHOnly>(y, ky, y_nranges, c, kc, c_nranges,
                                     batch, resident, s);
      break;
    case 1:
      e = launch_mode<kHOnly, kHOnly>(y, ky, y_nranges, c, kc, c_nranges,
                                      batch, resident, s);
      break;
    case 2:
      e = launch_mode<kWOnly, kDma>(y, ky, y_nranges, c, kc, c_nranges,
                                    batch, resident, s);
      break;
    default:
      e = launch_mode<kDma, kDma>(y, ky, y_nranges, c, kc, c_nranges, batch,
                                  resident, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
