// Lab variants of the banded NV12 preprocess kernel, and a stream floor,
// for Hopper (sm_90a): measuring instruments beside the product kernel of
// banded_preprocess.cu, on no product path.
//
// Replaces the TPU lab-notebook kernels of bench_kernel_variants.py:
//   - dma_floor           -> nv12_stream_floor_launch
//   - static_kernel       -> nv12_static_launch, S: H row tables in the
//                            constant bank, short or long cast chain
//   - transposed_chroma_kernel -> nv12_transposed_launch, T
// (grouped_kernel, static_kernel2, variant_kernel B / C / D, combo_kernel,
// prod_like and multiframe_kernel, the resize passes on the tensor cores,
// are nv12_grouped.cu, nv12_static2.cu, nv12_staged.cu, nv12_combo.cu,
// nv12_prodlike.cu and nv12_combo.cu again.)
//
// What bounds them on this card: what bounds the product kernel. One 64 x
// 1080p -> 224 batch reads ~199 MB and does a few GFLOP of FMAs, far under
// the H100's ~295 FLOP/byte ridge, so device-memory reads bound it. The
// stream floor measures how fast this card streams those bytes when
// nothing else is done: every byte of every frame read once with a 16-byte
// load and XORed into a small sink, so no load is dead. Its rate is the
// measured bound the variants (and the product kernels) are held to.
//
// S and T keep the block design of banded_preprocess.cu's earlier form:
// one block per (frame, strip of `rows` output rows), the H pass into
// shared memory as bf16 rows (banded_preprocess.cuh), then the W pass, CSC
// and round/clip to uint8 (wpass_store), the same FMAs in the same order
// as the product kernel, so its bits. They change where the H pass finds
// its windows or keeps its rows:
//   S      the TPU's trace-time window starts become row tables in the
//          64 KB constant bank (43,008 B at 1080p -> 224), read through the
//          constant cache instead of __ldg; a warp whose threads straddle
//          two output rows reads two addresses and serialises.
// Rows too wide for full-width H rows in a block run in output-column
// ranges: a block (strip, range) runs the H pass only over the source
// columns its W bands read, the same FMAs per H sample.
//   T      the chroma H-pass rows are kept transposed in shared memory
//          ([W][rows + pad], the pad making the pitch odd in 32-bit words so
//          that a warp's 32 column stores hit 32 banks); the W pass reads
//          U of column band j from row 2j, V from row 2j + 1. Its chroma H
//          pass takes one column a thread (byte loads) so that the stores
//          are conflict-free; the luma H pass is the product's.
//
// Each launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_preprocess.cuh"

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::Geometry;
using banded::hpass;
using banded::kSmemLimit;
using banded::Mid;
using banded::Tables;
using banded::Tail;
using banded::wpass_store;

using M = Mid<false>;
using T = __nv_bfloat16;

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

// ---- static windows: S ---------------------------------------------------

// The constant bank of S: one geometry's H row tables, as
// nv12_static_launch uploads them. Layout in 4-byte words: the luma row
// starts and counts, the chroma row starts and counts ([dst_h] int32 each,
// kept as their bits), then the luma row weights [dst_h, hy_k] and the
// chroma row weights [dst_h, hc_k]. The bank holds ONE geometry at a time:
// the launcher uploads the tables when the geometry differs from the last
// upload on the device, so two streams running S on two
// geometries at once would race on it.
constexpr int kBankBytes = 65536;
__constant__ float c_bank[kBankBytes / 4];

enum Cast : int { kCastLong = 0, kCastShort = 1 };

// One uint8 sample as the H pass multiplies it: u8 -> i32 -> f32 (long)
// or u8 -> i32 -> bf16 -> f32 (short). Every uint8 is exact in bf16, so
// the two give equal values.
template <int CAST>
__device__ __forceinline__ float sample(unsigned x) {
  if constexpr (CAST == kCastShort)
    return __bfloat162float(__int2bfloat16_rn(static_cast<int>(x)));
  else
    return static_cast<float>(static_cast<int>(x));
}

// The row bands of one plane in the constant bank: per output row o its
// first source row, its count and its weights.
struct RowBands {
  int start, count, w, k_max;  // word offsets into c_bank
  __device__ __forceinline__ int first(int o) const {
    return __float_as_int(c_bank[start + o]);
  }
  __device__ __forceinline__ int n(int o) const {
    return __float_as_int(c_bank[count + o]);
  }
  __device__ __forceinline__ float weight(int o, int k) const {
    return c_bank[w + o * k_max + k];
  }
};

// H pass of `rows` output rows (table rows o0 ..) over source columns
// [c0, c1) of a uint8 plane into dst[r * pitch + col - c0]: the FMAs of
// banded::hpass in the same order. With vec, c0 and c1 - c0 are multiples
// of 16 and the plane's rows 16-byte aligned.
template <int CAST, typename Bands>
__device__ __forceinline__ void hpass_cols(const uint8_t* plane, long long rs,
                                           int c0, int c1, int o0, int rows,
                                           const Bands& bd, T* dst, int pitch,
                                           bool vec) {
  const int ncols = c1 - c0;
  const uint8_t* base = plane + c0;
  if (vec) {
    const int groups = ncols / 16;
    for (int item = threadIdx.x; item < rows * groups; item += blockDim.x) {
      const int r = item / groups;
      const int gi = item - r * groups;
      const int o = o0 + r;
      const int n = bd.n(o);
      const uint8_t* src =
          base + static_cast<long long>(bd.first(o)) * rs + gi * 16;
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
      for (int k = 0; k < n; ++k) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<long long>(k) * rs));
        const unsigned wd[4] = {q.x, q.y, q.z, q.w};
        const float wk = bd.weight(o, k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * j + i] = fmaf(wk, sample<CAST>((wd[j] >> (8 * i)) & 0xFFu),
                                  acc[4 * j + i]);
      }
      T* d = dst + r * pitch + gi * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = M::put(acc[i]);
    }
  } else {
    for (int item = threadIdx.x; item < rows * ncols; item += blockDim.x) {
      const int r = item / ncols;
      const int col = item - r * ncols;
      const int o = o0 + r;
      const int n = bd.n(o);
      const uint8_t* src = base + static_cast<long long>(bd.first(o)) * rs + col;
      float acc = 0.0f;
      for (int k = 0; k < n; ++k)
        acc = fmaf(bd.weight(o, k),
                   sample<CAST>(__ldg(src + static_cast<long long>(k) * rs)),
                   acc);
      dst[r * pitch + col] = M::put(acc);
    }
  }
}

// Output-column ranges of a block: ext[4 z .. 4 z + 3] are the luma source
// columns [lo, hi) and the interleaved chroma columns [lo, hi) that the W
// bands of output columns [z DW / n, (z + 1) DW / n) read, widened to
// multiples of 16 (ops/banded.py column_ranges). n = 1 is the full row.
struct Ranges {
  const int* ext;
  int n, y_pitch, c_pitch;
};

// S: one block per (strip of g.rows output rows, frame, output-column
// range). The H pass reads its row tables from the constant bank; then
// the product's W pass and tail.
template <int CAST>
__global__ void __launch_bounds__(kThreads)
nv12_static_kernel(Frames f, Tables t, RowBands yb, RowBands cb,
                   Tail tl, Geometry g, Ranges rg,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DW = g.dst_w;
  T* yh = reinterpret_cast<T*>(smem);  // [rows][y_pitch]
  T* ch = yh + g.rows * rg.y_pitch;    // [rows][c_pitch] interleaved U/V
  const int o0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, g.dst_h - o0);
  const int z = blockIdx.z;
  const int p0 = static_cast<int>(static_cast<long long>(z) * DW / rg.n);
  const int p1 = static_cast<int>(static_cast<long long>(z + 1) * DW / rg.n);
  const int ylo = __ldg(rg.ext + 4 * z), yhi = __ldg(rg.ext + 4 * z + 1);
  const int clo = __ldg(rg.ext + 4 * z + 2), chi = __ldg(rg.ext + 4 * z + 3);
  const bool vec = f.vec != 0;

  const int b = blockIdx.y;
  const uint8_t* frame = f.src + b * f.bs;
  const uint8_t* uv = frame + static_cast<long long>(g.src_h) * f.rs;
  hpass_cols<CAST>(frame, f.rs, ylo, yhi, o0, rows, yb, yh, rg.y_pitch, vec);
  hpass_cols<CAST>(uv, f.rs, clo, chi, o0, rows, cb, ch, rg.c_pitch, vec);
  __syncthreads();
  uint8_t* ob = out + static_cast<long long>(b) * 3 * g.dst_h * DW;
  wpass_store<banded::kInterleaved>(
      yh, ch, rg.y_pitch, rg.c_pitch, rows, o0, g.dst_h, DW, p0, p1 - p0,
      ylo, clo, t, tl, ob);
}

template <int CAST>
cudaError_t launch_static(const Frames& f, const Tables& t,
                          const RowBands& yb, const RowBands& cb,
                          const Tail& tl, const Geometry& g, const Ranges& rg,
                          size_t smem, void* out, cudaStream_t stream) {
  auto kern = nv12_static_kernel<CAST>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.dst_h + g.rows - 1) / g.rows, g.batch, rg.n);
  kern<<<grid, kThreads, smem, stream>>>(f, t, yb, cb, tl, g, rg,
                                         static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

// The geometry whose row tables the constant bank holds, per device.
struct BankKey {
  const void* index;
  const void* weights;
  int src_h, src_w, dst_h, dst_w, hy_k, hc_k;
  bool operator==(const BankKey& o) const {
    return index == o.index && weights == o.weights && src_h == o.src_h &&
           src_w == o.src_w && dst_h == o.dst_h && dst_w == o.dst_w &&
           hy_k == o.hy_k && hc_k == o.hc_k;
  }
};
constexpr int kMaxDevices = 64;
BankKey g_bank[kMaxDevices];
bool g_bank_set[kMaxDevices];

// Upload the H row tables to the constant bank on `stream` when the
// geometry differs from the last upload on this device.
cudaError_t bank_upload(const BankKey& key, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_bank_set[dev] && g_bank[dev] == key) return cudaSuccess;
  const size_t idx = 16ull * key.dst_h;
  const size_t wts = 4ull * key.dst_h * (key.hy_k + key.hc_k);
  e = cudaMemcpyToSymbolAsync(c_bank, key.index, idx, 0,
                              cudaMemcpyDeviceToDevice, stream);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_bank, key.weights, wts, idx,
                                cudaMemcpyDeviceToDevice, stream);
  g_bank_set[dev] = e == cudaSuccess;
  g_bank[dev] = key;
  return e;
}

// ---- T: the chroma H-pass rows transposed ----------------------------------

// One block per (frame, strip of g.rows output rows), as the product; the
// luma H pass is the product's, the chroma H pass stores interleaved column
// j of strip row r at cht[j * pitch + r]. Its threads take one column each
// (a warp: 32 consecutive columns of one row), so that with pitch / 2 odd
// their 32 stores fall in 32 banks; the W pass then reads U of output
// column band j from row 2j of the transpose and V from row 2j + 1.
__global__ void __launch_bounds__(kThreads)
nv12_transposed_kernel(Frames f, Tables t, Tail tl, Geometry g, int pitch,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = g.src_w;
  T* yh = reinterpret_cast<T*>(smem);  // [rows][W]
  T* cht = yh + g.rows * W;            // [W][pitch]
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, g.dst_h - o0);
  const uint8_t* frame = f.src + b * f.bs;
  const uint8_t* uv = frame + static_cast<long long>(g.src_h) * f.rs;

  hpass<uint8_t, false>(frame, f.rs, W, o0, rows, t.hy_start, t.hy_count,
                        t.hy_w, t.hy_k, yh, W, 1, 0, f.vec != 0);
  for (int item = threadIdx.x; item < rows * W; item += blockDim.x) {
    const int r = item / W;
    const int col = item - r * W;
    const int o = o0 + r;
    const int n = __ldg(t.hc_count + o);
    const float* wr = t.hc_w + static_cast<long long>(o) * t.hc_k;
    const uint8_t* src =
        uv + static_cast<long long>(__ldg(t.hc_start + o)) * f.rs + col;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
      acc = fmaf(__ldg(wr + k),
                 static_cast<float>(__ldg(src + static_cast<long long>(k) *
                                                    f.rs)),
                 acc);
    cht[col * pitch + r] = M::put(acc);
  }
  __syncthreads();
  wpass_store<banded::kTransposed>(
      yh, cht, W, pitch, rows, o0, g.dst_h, g.dst_w, 0, g.dst_w, 0, 0, t, tl,
      out + static_cast<long long>(b) * 3 * g.dst_h * g.dst_w);
}

// Frames, tables and geometry of a lab launch; false when the arguments
// are refused.
bool lab_setup(const void* src, long long batch_stride, long long row_stride,
               int buf_rows, int batch, int src_h, int src_w, int dst_h,
               int dst_w, const int* index, const float* weights, int hy_k,
               int hc_k, int wy_k, const float* tail, int rows_per_block,
               Frames& f, Tables& t, Tail& tl, Geometry& g) {
  if (src_w <= 0 || (src_w & 1) || buf_rows < src_h * 3 / 2 ||
      rows_per_block < 1)
    return false;
  f.src = static_cast<const uint8_t*>(src);
  f.bs = batch_stride;
  f.rs = row_stride;
  f.buf_rows = buf_rows;
  f.vec = vec_frames(src, batch_stride, row_stride, src_w) ? 1 : 0;
  t = banded::unpack_tables(index, weights, dst_h, dst_w, hy_k, hc_k, wy_k);
  tl = banded::unpack_tail(tail);
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = rows_per_block < dst_h ? rows_per_block : dst_h;
  return true;
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

// S over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 buffer with
// the given batch and row strides (bytes; the interleaved UV rows start at
// row src_h), with the product's tables as nv12_preprocess_launch takes
// them (bf16-rounded) and `tail` the 18 floats of tail_params, on strips of
// rows_per_block output rows and n_ranges output-column ranges: `ranges`
// [n_ranges, 4] int32 on the device (ops/banded.py column_ranges), y_pitch
// and c_pitch the widest luma and interleaved chroma range. const_bank
// must be 1: the H row tables (the first 4 dst_h ints of `index` and the
// first dst_h (hy_k + hc_k) floats of `weights`) go to the constant bank,
// at most 64 KB, uploaded on `stream` when the geometry differs from the
// last upload on this device. short_chain 1 converts samples u8 -> i32 ->
// bf16, 0 u8 -> i32 -> f32.
int nv12_static_launch(const void* src, long long batch_stride,
                       long long row_stride, int buf_rows, int batch,
                       int src_h, int src_w, int dst_h, int dst_w,
                       const int* index, const float* weights, int hy_k,
                       int hc_k, int wy_k, int wc_k, const float* tail,
                       int const_bank, int short_chain, int rows_per_block,
                       const int* ranges, int n_ranges, int y_pitch,
                       int c_pitch, void* out, void* stream) {
  (void)wc_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const long long bank = 16LL * dst_h + 4LL * dst_h * (hy_k + hc_k);
  Frames f;
  Tables t;
  Tail tl;
  Geometry g;
  if (!lab_setup(src, batch_stride, row_stride, buf_rows, batch, src_h,
                 src_w, dst_h, dst_w, index, weights, hy_k, hc_k, wy_k, tail,
                 rows_per_block, f, t, tl, g) ||
      !const_bank || n_ranges < 1 || n_ranges > dst_w || y_pitch < 1 ||
      y_pitch > src_w || c_pitch < 1 || c_pitch > src_w || bank > kBankBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Ranges rg;
  rg.ext = ranges;
  rg.n = n_ranges;
  rg.y_pitch = y_pitch;
  rg.c_pitch = c_pitch;
  const long long smem = 2LL * g.rows * (rg.y_pitch + rg.c_pitch);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const size_t sb = static_cast<size_t>(smem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bank_upload(
      BankKey{index, weights, src_h, src_w, dst_h, dst_w, hy_k, hc_k}, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const RowBands yb{0, dst_h, 4 * dst_h, hy_k};
  const RowBands cb{2 * dst_h, 3 * dst_h, 4 * dst_h + dst_h * hy_k, hc_k};
  if (short_chain)
    e = launch_static<kCastShort>(f, t, yb, cb, tl, g, rg, sb, out, st);
  else
    e = launch_static<kCastLong>(f, t, yb, cb, tl, g, rg, sb, out, st);
  return static_cast<int>(e);
}

// T over `src` as nv12_static_launch takes it, on strips of
// rows_per_block output rows: the chroma H-pass rows kept transposed in
// shared memory, [src_w][pitch] with pitch the strip height rounded up so
// that pitch / 2 is odd.
int nv12_transposed_launch(const void* src, long long batch_stride,
                           long long row_stride, int buf_rows, int batch,
                           int src_h, int src_w, int dst_h, int dst_w,
                           const int* index, const float* weights, int hy_k,
                           int hc_k, int wy_k, int wc_k, const float* tail,
                           int rows_per_block, void* out, void* stream) {
  (void)wc_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  Frames f;
  Tables t;
  Tail tl;
  Geometry g;
  if (!lab_setup(src, batch_stride, row_stride, buf_rows, batch, src_h,
                 src_w, dst_h, dst_w, index, weights, hy_k, hc_k, wy_k, tail,
                 rows_per_block, f, t, tl, g))
    return static_cast<int>(cudaErrorInvalidValue);
  int pitch = (g.rows + 1) & ~1;
  if ((pitch / 2) % 2 == 0) pitch += 2;
  const long long smem = 2LL * src_w * (g.rows + pitch);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(nv12_transposed_kernel,
                                   static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((dst_h + g.rows - 1) / g.rows, batch);
  nv12_transposed_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      f, t, tl, g, pitch, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
