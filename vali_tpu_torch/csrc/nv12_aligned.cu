// Lab kernel `aligned` of the 4K NV12 resize lab for Hopper (sm_90a): the
// NV12 resize with both passes as products over aligned windows on the
// tensor cores, wgmma fed by a cp.async ring.
//
// Replaces aligned of resize_diag.py: on the TPU both passes are MXU
// products over windows widened to aligned blocks (zero taps added): the H
// pass [TILE, y_win] weight blocks times the frame's window rows, the W
// pass the H rows times [wy_winw, LANE_TILE] weight blocks. Its sweep asks
// what the alignment slack costs the matrix unit; here it asks the same of
// the tensor cores.
//
// What bounds it on this card: the bytes. 16 x 4K NV12 -> 1080p reads
// 199 MB and writes 50 MB (0.074 ms at 3.35 TB/s); the products issue
// ~35 GFLOP with the zeros at h_align 8 (0.036 ms at 989 TFLOP/s bf16).
//
// Design. One launch a plane (luma, then the interleaved chroma rows),
// compiled per K / 16 (NK) and plane (CH = 1 luma, 2 chroma), so that no
// wgmma sits under a branch (ptxas serializes wgmmas whose A registers are
// written under one). A block is (column range, strip of kRows output
// rows, frame), 256 threads, two blocks an SM. The host builds once per
// geometry (lab/resize_diag.py aligned_plane_tables): each strip's window
// of k_pad plane rows (its rows' bands widened to h_align rows, then with
// zeros to a multiple of 16, pulled back inside the plane; rows past a
// plane shorter than the window read its last row with weight 0), B =
// [k_pad, kRows] bf16 of the strip's weights in wgmma's K-major core
// matrices; the output tiles of 64 pixels, each with its band of source
// pixels (its columns' tap ranges widened to w_align // channels pixels,
// then to whole k-steps of 16 from a multiple of 8) and A = [64, 16 nk]
// bf16 of its weights in register-fragment order; and the column ranges:
// runs of tiles whose bands' union, the range's H columns, fits a block
// beside B and the ring.
//   - H pass: the transposed product of aligned_passes.cuh over each
//     128-byte chunk of the range, its window's bytes streamed through a
//     ring of kStages stages of [k_pad, 128 bytes] by 16-byte cp.async
//     copies issued two stages ahead (element loads where rows are not
//     16-byte aligned); each warpgroup takes 64 columns of a stage and
//     builds its A fragments from the raw bytes (wgmma_common.cuh
//     ring_fragments), then writes its bf16 H rows.
//   - W pass: aligned_passes.cuh's product and store per tile of the
//     range.
// The two warpgroups take alternate tiles. The block is aligned_block.cuh's
// in its full mode, shared with the lab's knock-outs (nv12_phases.cu) and
// its frame-skewed walk (nv12_skewed.cu).
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order and precision, so a sum may round
// apart from nv12_resize's FMA chain. The lab holds the kernel to the
// uint8 envelope of nv12_resize and counts its differing samples.
//
// The launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_block.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/aligned_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass's conversion and products
// (3: the staging ring alone).
#ifndef NV12_ALIGNED_KNOCKOUT
#define NV12_ALIGNED_KNOCKOUT 0
#endif

namespace {

using aligned::kRows;
using aligned::kThreads;
using aligned::Plane;
using aligned::Tables;
using aligned::smem_bytes;

// aligned_block.cuh's block in its full mode, the knob's bits knocked out.
template <int NK, int CH>
__global__ void __launch_bounds__(kThreads, 2) aligned_kernel(Plane p) {
  aligned::block<NK, CH, aligned::kFull, NV12_ALIGNED_KNOCKOUT>(
      p, aligned::Knock{});
}

template <int NK, int CH>
cudaError_t launch_nk(const Plane& p, int nranges, int batch,
                      cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_bytes(CH, p.hcols, p.k_pad));
  const cudaError_t e = banded::allow_smem(aligned_kernel<NK, CH>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nranges, (p.dst_rows + kRows - 1) / kRows, batch);
  aligned_kernel<NK, CH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_plane(const Plane& p, int nranges, int batch,
                         cudaStream_t stream) {
  switch (p.k_pad / 16) {
#define NV12_ALIGNED_NK(n) \
  case n:                  \
    return launch_nk<n, CH>(p, nranges, batch, stream);
    NV12_ALIGNED_NK(1) NV12_ALIGNED_NK(2) NV12_ALIGNED_NK(3)
    NV12_ALIGNED_NK(4) NV12_ALIGNED_NK(5) NV12_ALIGNED_NK(6)
    NV12_ALIGNED_NK(7) NV12_ALIGNED_NK(8) NV12_ALIGNED_NK(9)
    NV12_ALIGNED_NK(10) NV12_ALIGNED_NK(11) NV12_ALIGNED_NK(12)
    NV12_ALIGNED_NK(13) NV12_ALIGNED_NK(14) NV12_ALIGNED_NK(15)
    NV12_ALIGNED_NK(16)
#undef NV12_ALIGNED_NK
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `aligned` over frame 0 of a [batch, >= src_h * 3 / 2, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes) into a contiguous
// [batch, dst_h * 3 / 2, dst_w] uint8 output. Per plane (luma, then the
// interleaved chroma rows; lab/resize_diag.py AlignedPlane, on the device):
// b [strips, k_pad * 32] bf16 (strips = ceil(rows / 32)), starts [strips]
// int32, k_pad (a multiple of 16, at most 256), ranges [nranges, 4] int32,
// hcols (a multiple of 16), heads [tiles, 3] int32, frags [k-steps, 128]
// 16-byte words. Two launches.
int nv12_resize_aligned_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_ranges, int y_nranges,
    int y_hcols, const int* y_heads, const void* y_frags, const void* c_b,
    const int* c_starts, int c_k_pad, const int* c_ranges, int c_nranges,
    int c_hcols, const int* c_heads, const void* c_frags, void* out,
    void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const Tables yt{y_b, y_starts, y_k_pad, y_ranges, y_nranges, y_hcols,
                  y_heads, y_frags};
  const Tables ct{c_b, c_starts, c_k_pad, c_ranges, c_nranges, c_hcols,
                  c_heads, c_frags};
  Plane y, c;
  const long long out_bs = static_cast<long long>(dst_h) * 3 / 2 * dst_w;
  if (batch > 65535 ||
      !aligned::nv12_planes(y, c, src, batch_stride, row_stride, src_h,
                            src_w, dst_h, dst_w, yt, ct, out,
                            static_cast<uint8_t*>(out) +
                                static_cast<long long>(dst_h) * dst_w,
                            out_bs) ||
      !aligned::plane_ok(y, y_nranges, smem_bytes(1, y.hcols, y.k_pad)) ||
      !aligned::plane_ok(c, c_nranges, smem_bytes(2, c.hcols, c.k_pad)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_plane<1>(y, y_nranges, batch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_plane<2>(c, c_nranges, batch, s));
}

}  // extern "C"
