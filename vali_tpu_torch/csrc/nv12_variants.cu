// The stream floor of the NV12 preprocess lab for Hopper (sm_90a): a
// measuring instrument beside the product kernel of banded_preprocess.cu,
// on no product path.
//
// Replaces dma_floor of bench_kernel_variants.py (nv12_stream_floor_launch).
// (The notebook's other kernels run on the tensor cores: grouped_kernel,
// static_kernel2, variant_kernel B / C / D, combo_kernel, prod_like,
// multiframe_kernel, static_kernel and transposed_chroma_kernel are
// nv12_grouped.cu, nv12_static2.cu, nv12_staged.cu, nv12_combo.cu,
// nv12_prodlike.cu, nv12_combo.cu again and nv12_chains.cu.)
//
// What bounds the lab's kernels on this card: what bounds the product
// kernel. One 64 x 1080p -> 224 batch reads ~199 MB and does a few GFLOP
// of FMAs, far under the H100's ~295 FLOP/byte ridge, so device-memory
// reads bound it. The stream floor measures how fast this card streams
// those bytes when nothing else is done: every byte of every frame read
// once with a 16-byte load and XORed into a small sink, so no load is
// dead. Its rate is the measured bound the variants (and the product
// kernels) are held to.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_common.cuh"

namespace {

using banded::aligned16;

constexpr int kThreads = 256;

struct Frames {
  const uint8_t* src;  // frame 0 of [batch, buf_rows, src_w]
  long long bs, rs;    // batch and row strides in bytes
  int buf_rows;        // rows of the buffer as given (>= src_h * 3 / 2)
  int vec;             // 1: aligned start, strides and width: 16-byte loads
};

bool vec_frames(const void* src, long long bs, long long rs, int src_w) {
  return aligned16(src) && src_w % 16 == 0 && bs % 16 == 0 && rs % 16 == 0;
}

__global__ void __launch_bounds__(kThreads)
nv12_stream_floor_kernel(Frames f, int W, int DH, int DW, unsigned* sink,
                         int sink_words, uint8_t* __restrict__ out) {
  const int rows = f.buf_rows;
  const uint8_t* fr = f.src + blockIdx.y * f.bs;
  const int nthreads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  if (f.vec) {
    // (row, 16-byte group) of this thread's loads, stepped by nthreads
    // groups at a time without a division per load
    const int vpr = W / 16;
    const int dr = nthreads / vpr, dc = nthreads - dr * vpr;
    int r = tid / vpr, c = tid - (tid / vpr) * vpr;
    while (r < rows) {
      int rr[4], cc[4];
      rr[0] = r;
      cc[0] = c;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        rr[j] = rr[j - 1] + dr;
        cc[j] = cc[j - 1] + dc;
        if (cc[j] >= vpr) {
          cc[j] -= vpr;
          ++rr[j];
        }
      }
      uint4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = rr[j] < rows
                   ? __ldg(reinterpret_cast<const uint4*>(
                         fr + static_cast<long long>(rr[j]) * f.rs +
                         cc[j] * 16))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc ^= q[j].x ^ q[j].y ^ q[j].z ^ q[j].w;
      r = rr[3] + dr;
      c = cc[3] + dc;
      if (c >= vpr) {
        c -= vpr;
        ++r;
      }
    }
  } else {
    const long long n = static_cast<long long>(rows) * W;
    for (long long e = tid; e < n; e += nthreads) {
      const long long r = e / W;
      const int c = static_cast<int>(e - r * W);
      acc ^= static_cast<unsigned>(__ldg(fr + r * f.rs + c)) << (8 * (c & 3));
    }
  }

  // the output: two DH x DW corners of the frame, summed mod 256
  const int npix = DH * DW;
  uint8_t* ob = out + static_cast<long long>(blockIdx.y) * 3 * npix;
  for (int e = tid; e < npix; e += nthreads) {
    const int o = e / DW;
    const int p = e - o * DW;
    const unsigned v =
        (__ldg(fr + static_cast<long long>(o) * f.rs + p) +
         __ldg(fr + static_cast<long long>(rows - DH + o) * f.rs + p)) &
        0xFFu;
#pragma unroll
    for (int c = 0; c < 3; ++c) ob[c * npix + e] = static_cast<uint8_t>(v);
  }

  // one word of the sink per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ unsigned warp_acc[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned x = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) x ^= warp_acc[i];
    atomicXor(sink + (blockIdx.y * gridDim.x + blockIdx.x) % sink_words, x);
  }
}

}  // namespace

extern "C" {

// The stream floor over `src`, frame 0 of a [batch, rows, src_w] uint8
// buffer with the given batch and row strides (bytes): every byte read and
// XORed into sink[block % sink_words] (int32 words, not cleared here), and
// out[b, c] = (frame[:dst_h, :dst_w] + frame[rows - dst_h:, :dst_w]) & 255
// for c = 0, 1, 2 into a contiguous [batch, 3, dst_h, dst_w] uint8 tensor.
int nv12_stream_floor_launch(const void* src, long long batch_stride,
                             long long row_stride, int batch, int rows,
                             int src_w, int dst_h, int dst_w, void* sink,
                             int sink_words, void* out, void* stream) {
  if (batch <= 0 || rows <= 0 || src_w <= 0) return 0;
  if (dst_h < 0 || dst_w < 0 || dst_h > rows || dst_w > src_w ||
      sink_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Frames f;
  f.src = static_cast<const uint8_t*>(src);
  f.bs = batch_stride;
  f.rs = row_stride;
  f.buf_rows = rows;
  f.vec = vec_frames(src, batch_stride, row_stride, src_w) ? 1 : 0;
  // about eight 16-byte loads per thread
  const long long vectors = static_cast<long long>(rows) * src_w / 16 + 1;
  long long blocks = (vectors + 8LL * kThreads - 1) / (8LL * kThreads);
  blocks = blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  nv12_stream_floor_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      f, src_w, dst_h, dst_w, static_cast<unsigned*>(sink), sink_words,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
