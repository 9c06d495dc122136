// Lab kernel `skewed` of the 4K NV12 resize lab for Hopper (sm_90a):
// aligned's tensor-core passes (aligned_passes.cuh, nv12_aligned.cu at
// h_align 8, w_align 32) skewed across frames, frame b's H pass beside
// frame b - 1's W pass in one block.
//
// Replaces skewed of resize_diag.py: on the TPU a software-pipelined grid
// whose step b runs frame b's H pass and frame b - 1's W pass from a
// double-buffered H scratch, so that the two matrix passes overlap across
// grid steps instead of following each other within one. On the TPU at
// (8, 32) it won nothing: the matrix work was already hidden behind the
// input DMA. Here aligned's W pass sets the block's pace, and the two
// passes issue about the same FLOPs, so the question is open.
//
// What bounds it on this card: the bytes, as aligned's (16 x 4K -> 1080p:
// 199 MB in, 50 MB out, 0.074 ms at 3.35 TB/s); its products issue ~36
// GFLOP with the zeros (0.036 ms at 989 TFLOP/s bf16; more H columns than
// aligned's, its column ranges being narrower).
//
// Design. One launch a plane, compiled per K / 16 (NK) and plane (CH), a
// block per (column range, 32-row strip, group of G frames), 256 threads
// in two warpgroups with one role each, two blocks an SM (the host picks
// the fewest column ranges whose two H buffers, B and ring fit that:
// lab/resize_diag.py skewed_plane_tables). The strip's B is loaded once
// for its G frames. At step s = 0 .. G:
//   - the producer warpgroup streams frame s's window (s < G) through
//     aligned's cp.async ring, the ring running on across frames (the next
//     frame's first stages are issued while this frame's last are
//     multiplied), and runs both 64-column halves of each stage's H
//     product into H buffer s % 2; its ring's barriers are a named barrier
//     of its 128 threads, and after its last H-row stores a
//     fence.proxy.async makes them visible to the consumer's wgmma;
//   - the consumer warpgroup runs frame s - 1's W tiles (s > 0), every
//     tile of the range, from H buffer (s - 1) % 2, each product waited
//     for (wgmma.wait_group 0) before the buffer is released;
//   - both meet at one block barrier, where the buffers swap roles.
// Bits: the products of aligned's block per (strip, column), summed in
// the same order: aligned8x32's bits.
//
// The launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_block.cuh"
#include "tma_common.cuh"

namespace {

using aligned::kGroupBytes;
using aligned::kRows;
using aligned::kStages;
using aligned::kThreads;
using aligned::Plane;
using aligned::Tables;
using wgmma::kStageCols;

constexpr int kRole = 128;      // threads of a warpgroup: one role
constexpr int kRingBarrier = 1;  // the producer's named barrier

// Shared memory of one block (lab/resize_diag.py skewed_smem_bytes): two
// buffers of the tiled H rows of its widest range, B and the ring.
long long smem_bytes(int ch, int hcols, int k_pad) {
  return aligned::smem_bytes(ch, hcols, k_pad) +
         static_cast<long long>(hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>);
}

template <int NK, int CH>
__global__ void __launch_bounds__(kThreads, 2)
skewed_kernel(Plane p, int batch, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr int kp = 16 * NK;
  const int hbuf = p.hcols / 8 * kGroup;  // bytes of one H buffer
  unsigned char* hrows = smem;            // two H buffers
  unsigned char* bw = hrows + 2 * hbuf;   // B: [kp, kRows]
  unsigned char* ring = bw + kp * kRows * 2;  // kStages x [kp, 128] bytes
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & (kRole - 1);
  const int warp = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int strip = blockIdx.y;
  const int4 rg = __ldg(p.ranges + blockIdx.x);
  const int xb0 = rg.z * CH;      // the range's first byte of a row
  const int hbytes = rg.w * CH;   // bytes of its H columns
  const int nstages = (hbytes + kStageCols - 1) / kStageCols;
  const int o0 = strip * kRows;
  const int rows = min(kRows, p.dst_rows - o0);
  const int end = p.bytes - xb0;  // bytes of a row from the range's start
  const int w0 = __ldg(p.starts + strip), last = p.rows - 1;
  const auto row_of = [=](int k) { return min(w0 + k, last); };
  const int f0 = blockIdx.z * group;
  const int nf = min(group, batch - f0);
  const int nq = nf * nstages;  // the producer's stages over its frames
  // stage q of the walk: frame f0 + q / nstages, columns q % nstages
  const auto issue = [&](int q) {
    if (q < nq) {
      const int f = q / nstages, s = q - f * nstages;
      wgmma::issue_stage<kRole>(ring + q % kStages * kp * kStageCols,
                                p.src + (f0 + f) * p.bs + xb0, p.rs,
                                s * kStageCols, kp, end, p.vec, row_of);
    } else {
      wgmma::cp_async_commit();
    }
  };

  if (wg == 0) {
    for (int q = 0; q < kStages - 1; ++q) issue(q);
    const uint4* bsrc =
        p.b + static_cast<long long>(strip) * kp * kRows / 8;
    for (int i = wt; i < kp * kRows / 8; i += kRole)
      reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
    wgmma::fence_proxy_async();  // B, read by wgmma
  }
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);

  for (int step = 0; step <= nf; ++step) {
    if (wg == 0) {
      if (step < nf) {
        unsigned char* h = hrows + (step & 1) * hbuf;
        for (int s = 0; s < nstages; ++s) {
          const int q = step * nstages + s;
          wgmma::cp_async_wait<kStages - 2>();
          // stage q landed; slot (q - 1) % kStages is free (B is written)
          tma::named_sync(kRingBarrier, kRole);
          issue(q + kStages - 1);
          const unsigned char* slot = ring + q % kStages * kp * kStageCols;
#pragma unroll 1
          for (int half = 0; half < 2; ++half) {
            const int ccol = 64 * half + 16 * warp + 2 * gq;
            unsigned a[NK][4];
            wgmma::ring_fragments<NK>(a, slot, ccol, tq);
            float d[kRows / 2];
            passes::h_product<NK>(d, a, bdesc);
            passes::store_h<CH>(h, d, s * kStageCols + ccol, hbytes, end,
                                tq);
          }
        }
        wgmma::fence_proxy_async();  // the H rows, read by the consumer
      }
    } else if (step > 0) {
      const unsigned char* h = hrows + ((step - 1) & 1) * hbuf;
      uint8_t* ob = p.out + (f0 + step - 1) * p.out_bs;
      for (int t = rg.x; t < rg.x + rg.y; ++t)
        passes::w_tile<CH>(ob, o0, rows, p.dst_w, h, p.heads, p.frags, t,
                           rg.z, wt, warp, gq, tq);
    }
    __syncthreads();  // the hand-off: the H buffers swap roles
  }
  wgmma::cp_async_wait<0>();
}

template <int NK, int CH>
cudaError_t launch_nk(const Plane& p, int nranges, int batch, int group,
                      int* resident, cudaStream_t stream) {
  const auto kern = skewed_kernel<NK, CH>;
  const size_t smem = static_cast<size_t>(smem_bytes(CH, p.hcols, p.k_pad));
  cudaError_t e = banded::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  if (resident) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
  }
  if (batch <= 0) return cudaSuccess;
  const dim3 grid(nranges, (p.dst_rows + kRows - 1) / kRows,
                  (batch + group - 1) / group);
  kern<<<grid, kThreads, smem, stream>>>(p, batch, group);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_plane(const Plane& p, int nranges, int batch, int group,
                         int* resident, cudaStream_t stream) {
  switch (p.k_pad / 16) {
#define NV12_SKEWED_NK(n) \
  case n:                 \
    return launch_nk<n, CH>(p, nranges, batch, group, resident, stream);
    NV12_SKEWED_NK(1) NV12_SKEWED_NK(2) NV12_SKEWED_NK(3)
    NV12_SKEWED_NK(4) NV12_SKEWED_NK(5) NV12_SKEWED_NK(6)
    NV12_SKEWED_NK(7) NV12_SKEWED_NK(8) NV12_SKEWED_NK(9)
    NV12_SKEWED_NK(10) NV12_SKEWED_NK(11) NV12_SKEWED_NK(12)
    NV12_SKEWED_NK(13) NV12_SKEWED_NK(14) NV12_SKEWED_NK(15)
    NV12_SKEWED_NK(16)
#undef NV12_SKEWED_NK
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `skewed` over frame 0 of a [batch, >= src_h * 3 / 2, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes) into a contiguous
// [batch, dst_h * 3 / 2, dst_w] uint8 output, each block walking `group`
// frames (the last block of a column fewer). Per plane the tables of
// lab/resize_diag.py skewed_plane_tables on the device, as
// nv12_resize_aligned_launch takes aligned's. `resident` (may be null)
// gets the blocks an SM holds of the luma and the chroma launch; batch 0
// launches nothing. Two launches.
int nv12_resize_skewed_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_ranges, int y_nranges,
    int y_hcols, const int* y_heads, const void* y_frags, const void* c_b,
    const int* c_starts, int c_k_pad, const int* c_ranges, int c_nranges,
    int c_hcols, const int* c_heads, const void* c_frags, int group,
    int* resident, void* out, void* stream) {
  if (batch < 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const Tables yt{y_b, y_starts, y_k_pad, y_ranges, y_nranges, y_hcols,
                  y_heads, y_frags};
  const Tables ct{c_b, c_starts, c_k_pad, c_ranges, c_nranges, c_hcols,
                  c_heads, c_frags};
  Plane y, c;
  if (group < 1 ||
      (batch + group - 1) / group > 65535 ||
      !aligned::nv12_planes(y, c, src, batch_stride, row_stride, src_h,
                            src_w, dst_h, dst_w, yt, ct, out,
                            static_cast<uint8_t*>(out) +
                                static_cast<long long>(dst_h) * dst_w,
                            static_cast<long long>(dst_h) * 3 / 2 * dst_w) ||
      !aligned::plane_ok(y, y_nranges, smem_bytes(1, y.hcols, y.k_pad)) ||
      !aligned::plane_ok(c, c_nranges, smem_bytes(2, c.hcols, c.k_pad)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      launch_plane<1>(y, y_nranges, batch, group, resident, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_plane<2>(
      c, c_nranges, batch, group, resident ? resident + 1 : nullptr, s));
}

}  // extern "C"
