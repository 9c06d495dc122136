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
// The two warpgroups take alternate tiles.
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

#include "aligned_passes.cuh"
#include "banded_common.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/aligned_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass's conversion and products
// (3: the staging ring alone).
#ifndef NV12_ALIGNED_KNOCKOUT
#define NV12_ALIGNED_KNOCKOUT 0
#endif

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::kSmemLimit;
using passes::kGroupBytes;
using passes::kRows;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::fence_proxy_async;
using wgmma::kStageCols;

constexpr int kKnockout = NV12_ALIGNED_KNOCKOUT;
constexpr int kThreads = 256;   // two warpgroups
constexpr int kStages = 3;      // ring depth: two stages in flight
constexpr int kMaxKSteps = 16;  // k_pad <= 256 window rows

// One plane's launch: its frames, output and tables (lab/resize_diag.py
// AlignedPlane).
struct Plane {
  const uint8_t* src;  // plane row 0 of frame 0
  long long bs, rs;    // batch and row strides of the frames (bytes)
  int rows, bytes;     // plane rows; bytes of a row
  int vec;             // 16-byte cp.async copies
  uint8_t* out;        // output plane row 0 of frame 0
  long long out_bs;    // output batch stride
  int dst_rows, dst_w;  // output rows; bytes of an output row
  const uint4* b;       // [strips][k_pad * kRows / 8] bf16, core matrices
  const int* starts;    // [strips] first plane row of each window
  int k_pad;
  const int4* ranges;   // [ranges]: first tile, tiles, first H pixel, H pixels
  int hcols;            // H columns (pixels) of the widest range
  const int* heads;     // [tiles][3]: first k-step, first source pixel, k-steps
  const uint4* frags;   // [k-steps][128] bf16 A fragments
};

template <int NK, int CH>
__global__ void __launch_bounds__(kThreads, 2) aligned_kernel(Plane p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr int kp = 16 * NK;
  unsigned char* hrows = smem;                           // tiled H rows
  unsigned char* bw = hrows + p.hcols / 8 * kGroup;      // B: [kp, kRows]
  unsigned char* ring = bw + kp * kRows * 2;  // kStages x [kp, 128] bytes
  const int tid = threadIdx.x;
  const int strip = blockIdx.y;
  const int4 rg = __ldg(p.ranges + blockIdx.x);
  const int xb0 = rg.z * CH;      // the range's first byte of a row
  const int hbytes = rg.w * CH;   // bytes of its H columns
  const int nstages = (hbytes + kStageCols - 1) / kStageCols;
  const int o0 = strip * kRows;
  const int rows = min(kRows, p.dst_rows - o0);
  const uint8_t* base = p.src + blockIdx.z * p.bs + xb0;
  const int end = p.bytes - xb0;  // bytes of a row from the range's start
  const int w0 = __ldg(p.starts + strip), last = p.rows - 1;
  const auto row_of = [=](int k) { return min(w0 + k, last); };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages)
      wgmma::issue_stage<kThreads>(ring + s * kp * kStageCols, base, p.rs,
                                   s * kStageCols, kp, end, p.vec, row_of);
    else
      cp_async_commit();
  }
  const uint4* bsrc = p.b + static_cast<long long>(strip) * kp * kRows / 8;
  for (int i = tid; i < kp * kRows / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  fence_proxy_async();  // B, read by wgmma

  const int wg = tid >> 7;                  // warpgroup: 64 stage columns
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * wg + 16 * warp + 2 * gq;  // the thread's 2 columns
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; slot (s - 1) % kStages is free
    if (s + kStages - 1 < nstages)
      wgmma::issue_stage<kThreads>(
          ring + (s + kStages - 1) % kStages * kp * kStageCols, base, p.rs,
          (s + kStages - 1) * kStageCols, kp, end, p.vec, row_of);
    else
      cp_async_commit();
    if (kKnockout & 2) continue;
    unsigned a[NK][4];
    wgmma::ring_fragments<NK>(a, ring + s % kStages * kp * kStageCols, ccol,
                              tq);
    float d[kRows / 2];
    passes::h_product<NK>(d, a, bdesc);
    passes::store_h<CH>(hrows, d, s * kStageCols + ccol, hbytes, end, tq);
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the H rows, read by wgmma in the W pass
  __syncthreads();
  if (kKnockout & 1) return;

  uint8_t* ob = p.out + blockIdx.z * p.out_bs;
  for (int t = rg.x + wg; t < rg.x + rg.y; t += 2)
    passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads, p.frags, t,
                       rg.z, tid & 127, warp, gq, tq);
}

// Shared memory of one block of a plane (lab/resize_diag.py
// aligned_smem_bytes): the tiled H rows of its widest range, B and the ring.
long long smem_bytes(int ch, int hcols, int k_pad) {
  return static_cast<long long>(hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) +
         2LL * k_pad * kRows + static_cast<long long>(kStages) * k_pad *
                                   kStageCols;
}

template <int NK, int CH>
cudaError_t launch_nk(const Plane& p, int nranges, int batch,
                      cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_bytes(CH, p.hcols, p.k_pad));
  const cudaError_t e = allow_smem(aligned_kernel<NK, CH>, smem);
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

// A plane's tables as the launcher takes them, checked.
bool plane_ok(const Plane& p, int ch, int nranges) {
  return p.k_pad >= 16 && p.k_pad % 16 == 0 &&
         p.k_pad <= 16 * kMaxKSteps && nranges >= 1 && p.hcols >= 16 &&
         p.hcols % 16 == 0 && aligned16(p.b) && aligned16(p.ranges) &&
         aligned16(p.frags) && p.starts != nullptr && p.heads != nullptr &&
         smem_bytes(ch, p.hcols, p.k_pad) <= kSmemLimit;
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
  if (batch > 65535 || src_w <= 0 || src_h <= 0 || (src_w & 1) ||
      (src_h & 1) || (dst_w & 1) || (dst_h & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(src) && src_w % 16 == 0 &&
                   batch_stride % 16 == 0 && row_stride % 16 == 0;
  Plane y{static_cast<const uint8_t*>(src), batch_stride, row_stride, src_h,
          src_w, vec, static_cast<uint8_t*>(out),
          static_cast<long long>(dst_h) * 3 / 2 * dst_w, dst_h, dst_w,
          static_cast<const uint4*>(y_b), y_starts, y_k_pad,
          reinterpret_cast<const int4*>(y_ranges), y_hcols, y_heads,
          static_cast<const uint4*>(y_frags)};
  Plane c = y;
  c.src = y.src + static_cast<long long>(src_h) * row_stride;
  c.rows = src_h / 2;
  c.out = y.out + static_cast<long long>(dst_h) * dst_w;
  c.dst_rows = dst_h / 2;
  c.b = static_cast<const uint4*>(c_b);
  c.starts = c_starts;
  c.k_pad = c_k_pad;
  c.ranges = reinterpret_cast<const int4*>(c_ranges);
  c.hcols = c_hcols;
  c.heads = c_heads;
  c.frags = static_cast<const uint4*>(c_frags);
  if (!plane_ok(y, 1, y_nranges) || !plane_ok(c, 2, c_nranges))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_plane<1>(y, y_nranges, batch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_plane<2>(c, c_nranges, batch, s));
}

}  // extern "C"
