// Lab variants of the banded NV12 resize kernel for Hopper (sm_90a):
// measuring instruments beside nv12_resize (banded_resize.cu), on no
// product path.
//
// Replaces the TPU lab-notebook kernels of resize_diag.py:
//   - variant  (dma_only, h_only, w_only, both) -> nv12_resize_phases_launch
//   - skewed                                    -> nv12_resize_skewed_launch
//   - slabs                                     -> nv12_slabs.cu
//   - striped  (nw, store)                      -> nv12_striped.cu
//
// What bounds them on this card: what bounds nv12_resize. 16 x 4K NV12 ->
// 1080p reads 199 MB and writes 50 MB for ~3.6 GFLOP of FMAs, far under the
// H100's ~295 FLOP/byte ridge, so moving samples bounds it: the device-
// memory reads and the L2 -> SM traffic of the source rows that
// neighbouring strips share. Each variant asks one question of the product
// design:
//   phases    what each pass costs over the stream of the same bytes. The
//             knock-outs keep the product's blocks and drop a phase; their
//             results are folded into a sink so no phase is compiled away.
//   skewed    whether the W pass hides behind the H pass: one block per
//             (column tile, strip, plane) walks the frames; a producer half
//             of the block runs frame b's H pass into one of two H-pass
//             buffers while the consumer half runs frame b - 1's W pass from
//             the other, handing off at one barrier per step.
//   slabs     (split-K by row slab) and striped (column stripes as one
//             thread-block cluster) live in nv12_slabs.cu and
//             nv12_striped.cu, on aligned's tensor-core passes.
//
// The block design is banded_resize.cu's: a block of (frame, strip of kRows
// output rows, tile of tile_w output pixels) runs the H pass of the strip
// over the tile's source-column window into shared memory as bf16 rows,
// then the W pass and the round/clip to uint8. Tables as ops/banded.py
// ResizeTables; uint8 samples and bf16 compute only. Every full-function
// variant does the product's FMAs in the product's order, so it gives
// nv12_resize's bits.
//
// Each launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <climits>

#include "banded_common.cuh"

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::sink_xor;
using banded::stream_rows;
using M = banded::Mid<false>;
using MT = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 8;        // output rows per strip (ops/banded.py STRIP_ROWS)
constexpr int kTile = 32;       // TILE: rows of frame samples the knock-outs keep
constexpr int kLaneTile = 128;  // LANE_TILE: lanes of the knock-outs' output

// kFull: H pass + W pass into the output (the product block).
// kHOnly: H pass; output lanes < lanes_out are the H-pass rows truncated to
//   int and cut to their low byte, the rest 0; every H-pass value into the
//   sink. kHSink: H pass into the sink only (the chroma of h_only and both).
// kWOnly: H-pass rows = frame rows o < rows_out as bf16, the rest 0; W pass
//   into the output; the block's share of the frame into the sink.
// kDmaOnly: the block's share of the frame into the sink; output = frame
//   samples at rows < rows_out and lanes < lanes_out, the rest 0.
enum Mode : int { kFull = 0, kHOnly = 1, kWOnly = 2, kDmaOnly = 3, kHSink = 4 };

// Band tables of one plane (ops/banded.py ResizeTables).
struct Bands {
  const int* h_start; const int* h_count; const float* h_w; int h_k;
  const int* w_start; const int* w_count; const float* w_w;  // [k][dst_w]
  int tile_w;  // output pixels per block tile
  int span;    // source rows the tallest strip reads
};

// Geometry of one plane: sizes in pixels, strides in bytes.
struct Image {
  int src_h, src_w, dst_h, dst_w;
  long long in_bs, in_rs, out_bs, out_rs;
};

// The knock-outs' sink and output extent.
struct Knock {
  unsigned* sink;
  int sink_words;
  int frame_rows;  // rows of one NV12 frame (src_h * 3 / 2)
  int rows_out;    // min(kTile, dst_h, frame_rows)
  int lanes_out;   // min(kLaneTile, dst_w, src_w)
  int vec;         // 1: 16-byte loads of whole frame rows
};

// Lanes of one H-pass row (or ring row) in shared memory: the window, its
// start rounded down to `vec` lanes, and its end rounded up.
__host__ __device__ constexpr int mid_lanes(int window, int c, int vec) {
  return (window * c + 2 * (vec - 1)) / vec * vec;
}

template <int VEC> __device__ __forceinline__ void load_vec(const uint8_t* p,
                                                            float* x);
template <> __device__ __forceinline__ void load_vec<4>(const uint8_t* p,
                                                       float* x) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = static_cast<float>((w >> (8 * i)) & 0xFFu);
}

// The strip's source rows [r_lo, r_lo + span) and its row bands as dense
// [kRows][ld] weights wd (0 where a row's band does not reach: that adds
// exactly nothing; rows past the image weigh 0). Every thread of the block
// calls it; it ends with a barrier.
__device__ void strip_rows(const Bands& bd, int dst_h, int o0, float* wd,
                           int& r_lo, int& span) {
  const int rows = min(kRows, dst_h - o0);
  int lo = INT_MAX, hi = -1;
  for (int r = 0; r < rows; ++r) {
    const int c = __ldg(bd.h_count + o0 + r);
    if (c > 0) {
      const int s = __ldg(bd.h_start + o0 + r);
      lo = min(lo, s);
      hi = max(hi, s + c - 1);
    }
  }
  span = max(hi - lo + 1, 0);
  r_lo = span > 0 ? lo : 0;
  for (int i = threadIdx.x; i < kRows * span; i += blockDim.x) {
    const int r = i / span;
    const int j = i - r * span;
    float w = 0.0f;
    if (r < rows) {
      const int k = r_lo + j - __ldg(bd.h_start + o0 + r);
      if (k >= 0 && k < __ldg(bd.h_count + o0 + r))
        w = __ldg(bd.h_w + static_cast<long long>(o0 + r) * bd.h_k + k);
    }
    wd[r * bd.span + j] = w;
  }
  __syncthreads();
}

// Source pixels [lo, hi] that the column bands of output pixels
// [p0, p0 + cols) read. Every thread calls it; it uses s_win[2].
__device__ void tile_window(const Bands& bd, int p0, int cols, int* s_win,
                            int& lo, int& hi) {
  if (threadIdx.x == 0) {
    s_win[0] = INT_MAX;
    s_win[1] = -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int s = __ldg(bd.w_start + p0 + j);
    atomicMin(&s_win[0], s);
    atomicMax(&s_win[1], s + __ldg(bd.w_count + p0 + j) - 1);
  }
  __syncthreads();
  lo = s_win[0] == INT_MAX ? 0 : s_win[0];
  hi = s_win[1];
}

// H pass of source rows [r_lo, r_lo + span) over window lanes [0, nl) of
// `base` (the window's first lane in row 0; row stride rs; lanes at or
// past `len` read as 0) by threads t of nt, VEC lanes each:
// mid[r * ldm + l] = bf16(sum_j wd[r][j] * x[j][l]), fp32 FMAs in row order
// (banded_resize.cu phase 1).
template <int VEC>
__device__ __forceinline__ void hpass(const uint8_t* base, long long rs,
                                      bool vec, int len, int r_lo, int span,
                                      const float* wd, int ld, int rows,
                                      int nl, MT* mid, int ldm, int t,
                                      int nt) {
  for (int l = VEC * t; l < nl; l += VEC * nt) {
    float acc[kRows][VEC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] = 0.0f;
    const bool full = vec && l + VEC <= len;
    const uint8_t* col = base + l + static_cast<long long>(r_lo) * rs;
    for (int j = 0; j < span; ++j, col += rs) {
      float x[VEC];
      if (full) {
        load_vec<VEC>(col, x);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          x[i] = l + i < len ? static_cast<float>(__ldg(col + i)) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float w = wd[r * ld + j];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(w, x[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (r < rows) mid[r * ldm + l + i] = M::put(acc[r][i]);
  }
}

// W pass and quantise of `rows` H-pass rows into output pixels
// [p0, p0 + cols) (banded_resize.cu phase 2): `ob` is output row 0 of the
// strip at pixel p0, rows `out_rs` bytes apart.
template <int C>
__device__ __forceinline__ void wpass(const MT* mid, int ldm, int lane0,
                                      const Bands& bd, int dst_w, int rows,
                                      int p0, int cols, uint8_t* ob,
                                      long long out_rs, int t, int nt) {
  const int olanes = cols * C;
  for (int i = t; i < rows * olanes; i += nt) {
    const int r = i / olanes;
    const int j = i - r * olanes;
    const int q = j / C;
    const int c = j - q * C;
    const int p = p0 + q;
    const int n = __ldg(bd.w_count + p);
    const MT* m = mid + r * ldm + __ldg(bd.w_start + p) * C - lane0 + c;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
      acc = fmaf(__ldg(bd.w_w + static_cast<long long>(k) * dst_w + p),
                 M::get(m[k * C]), acc);
    ob[r * out_rs + j] =
        static_cast<uint8_t>(fminf(fmaxf(rintf(acc), 0.0f), 255.0f));
  }
}

// ---- phases: one block per (column tile, strip, frame) -----------------

template <int MODE, int VEC, int C>
__global__ void __launch_bounds__(kThreads)
strip_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
             Bands bd, Image im, Knock kn) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wd = reinterpret_cast<float*>(smem);             // [kRows][span]
  MT* mid = reinterpret_cast<MT*>(wd + kRows * bd.span);  // [kRows][ldm]
  __shared__ int s_win[2];

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kRows;
  const int rows = min(kRows, im.dst_h - o0);
  const int p0 = blockIdx.x * bd.tile_w;
  const int cols = min(bd.tile_w, im.dst_w - p0);
  const uint8_t* frame = src + b * im.in_bs;
  uint8_t* ob = out + b * im.out_bs + static_cast<long long>(o0) * im.out_rs;
  const int len = im.src_w * C;  // lanes of a source row

  if constexpr (MODE == kWOnly || MODE == kDmaOnly) {
    // this block's share of the frame's rows, every byte into the sink
    const int nb = gridDim.x * gridDim.y;
    const int k = blockIdx.y * gridDim.x + blockIdx.x;
    const int r0 = static_cast<int>(static_cast<long long>(kn.frame_rows) * k / nb);
    const int r1 =
        static_cast<int>(static_cast<long long>(kn.frame_rows) * (k + 1) / nb);
    sink_xor(stream_rows(frame, im.in_rs, r0, r1, len, kn.vec != 0), kn.sink,
             kn.sink_words, static_cast<long long>(b) * nb + k);
  }
  if constexpr (MODE == kDmaOnly) {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int p = p0 + (i - r * cols);
      const int o = o0 + r;
      ob[r * im.out_rs + p] =
          o < kn.rows_out && p < kn.lanes_out
              ? __ldg(frame + static_cast<long long>(o) * im.in_rs + p)
              : 0;
    }
    return;
  } else {
    int lo, hi;
    tile_window(bd, p0, cols, s_win, lo, hi);
    if (MODE == kHOnly && blockIdx.x == 0) {
      // block 0 writes the output lanes < lanes_out: its window covers them
      lo = 0;
      hi = max(hi, kn.lanes_out - 1);
    }
    const int lane0 = lo * C / VEC * VEC;
    const int nl = max((hi + 1) * C - lane0, 0);
    const int ldm = (nl + VEC - 1) / VEC * VEC;

    if constexpr (MODE == kWOnly) {
      for (int i = threadIdx.x; i < kRows * ldm; i += blockDim.x) {
        const int r = i / ldm;
        const int l = i - r * ldm;
        const int o = o0 + r;
        float x = 0.0f;
        if (r < rows && o < kn.rows_out && lane0 + l < len)
          x = static_cast<float>(
              __ldg(frame + static_cast<long long>(o) * im.in_rs + lane0 + l));
        mid[r * ldm + l] = M::put(x);
      }
    } else {
      int r_lo, span;
      strip_rows(bd, im.dst_h, o0, wd, r_lo, span);
      const uint8_t* base = frame + lane0;
      const bool vec = (reinterpret_cast<uintptr_t>(base) % VEC) == 0 &&
                       im.in_rs % VEC == 0;
      hpass<VEC>(base, im.in_rs, vec, len - lane0, r_lo, span, wd, bd.span,
                 rows, nl, mid, ldm, threadIdx.x, blockDim.x);
    }
    __syncthreads();

    if constexpr (MODE == kFull || MODE == kWOnly) {
      wpass<C>(mid, ldm, lane0, bd, im.dst_w, rows, p0, cols, ob + p0 * C,
               im.out_rs, threadIdx.x, blockDim.x);
    } else {
      // kHOnly, kHSink: every H-pass value of the block into the sink
      unsigned acc = 0;
      for (int i = threadIdx.x; i < rows * nl; i += blockDim.x) {
        const int r = i / nl;
        const int l = i - r * nl;
        acc ^= static_cast<unsigned>(__bfloat16_as_ushort(mid[r * ldm + l]))
               << (16 * (l & 1));
      }
      const int nb = gridDim.x * gridDim.y;
      sink_xor(acc, kn.sink, kn.sink_words,
               static_cast<long long>(b) * nb + blockIdx.y * gridDim.x +
                   blockIdx.x);
      if constexpr (MODE == kHOnly) {
        // output pixels [w_lo, w_hi): block 0 also those < lanes_out
        const int w_lo = blockIdx.x == 0 ? 0 : max(p0, kn.lanes_out);
        const int w_hi = blockIdx.x == 0 ? max(cols, kn.lanes_out) : p0 + cols;
        const int n = w_hi - w_lo;
        for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
          const int r = i / n;
          const int p = w_lo + (i - r * n);
          unsigned v = 0;
          if (p < kn.lanes_out)  // astype(int32).astype(uint8)
            v = static_cast<unsigned>(
                    static_cast<int>(M::get(mid[r * ldm + p - lane0]))) &
                0xFFu;
          ob[r * im.out_rs + p] = static_cast<uint8_t>(v);
        }
      }
    }
  }
}

template <int MODE, int VEC, int C>
cudaError_t launch_strip(const void* src, void* out, const Bands& bd,
                         const Image& im, const Knock& kn, int batch,
                         int window, cudaStream_t stream) {
  auto kern = strip_kernel<MODE, VEC, C>;
  const size_t smem =
      MODE == kDmaOnly ? 0
                       : sizeof(float) * kRows * bd.span +
                             sizeof(MT) * kRows * mid_lanes(window, C, VEC);
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((im.dst_w + bd.tile_w - 1) / bd.tile_w,
                  (im.dst_h + kRows - 1) / kRows, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), bd, im,
      kn);
  return cudaGetLastError();
}

// ---- skewed: one block per (column tile, strip, plane) over the frames --

template <int C>
__device__ void skewed_plane(const uint8_t* src, uint8_t* out,
                             const Bands& bd, const Image& im, int batch,
                             int ldm_cap, unsigned char* smem, int* s_win) {
  const int p0 = blockIdx.x * bd.tile_w;
  const int o0 = blockIdx.y * kRows;
  if (p0 >= im.dst_w || o0 >= im.dst_h) return;  // the whole block
  const int rows = min(kRows, im.dst_h - o0);
  const int cols = min(bd.tile_w, im.dst_w - p0);
  float* wd = reinterpret_cast<float*>(smem);
  MT* mids[2];
  mids[0] = reinterpret_cast<MT*>(wd + kRows * bd.span);
  mids[1] = mids[0] + kRows * ldm_cap;

  int lo, hi, r_lo, span;
  tile_window(bd, p0, cols, s_win, lo, hi);
  strip_rows(bd, im.dst_h, o0, wd, r_lo, span);  // the same for every frame
  const int lane0 = lo * C / 4 * 4;
  const int nl = max((hi + 1) * C - lane0, 0);
  const int ldm = (nl + 3) / 4 * 4;
  const int len = im.src_w * C - lane0;
  const int half = blockDim.x / 2;
  const bool producer = threadIdx.x < half;
  const int t = producer ? threadIdx.x : threadIdx.x - half;
  // step s: the producers run frame s's H pass into mids[s & 1] while the
  // consumers run frame s - 1's W pass from mids[(s - 1) & 1]
  for (int s = 0; s <= batch; ++s) {
    if (producer) {
      if (s < batch) {
        const uint8_t* base = src + s * im.in_bs + lane0;
        const bool vec = (reinterpret_cast<uintptr_t>(base) % 4) == 0 &&
                         im.in_rs % 4 == 0;
        hpass<4>(base, im.in_rs, vec, len, r_lo, span, wd, bd.span, rows, nl,
                 mids[s & 1], ldm, t, half);
      }
    } else if (s > 0) {
      wpass<C>(mids[(s - 1) & 1], ldm, lane0, bd, im.dst_w, rows, p0, cols,
               out + (s - 1) * im.out_bs +
                   static_cast<long long>(o0) * im.out_rs + p0 * C,
               im.out_rs, t, half);
    }
    __syncthreads();  // the hand-off: buffers swap roles
  }
}

__global__ void __launch_bounds__(2 * kThreads)
skewed_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
              Bands y, Image yim, Bands c, Image cim, int batch, int y_ldm,
              int c_ldm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_win[2];
  if (blockIdx.z == 0)
    skewed_plane<1>(src, out, y, yim, batch, y_ldm, smem, s_win);
  else
    skewed_plane<2>(src + yim.src_h * yim.in_rs,
                    out + static_cast<long long>(yim.dst_h) * yim.out_rs, c,
                    cim, batch, c_ldm, smem, s_win);
}

// ---- host side ------------------------------------------------------------

// The column tap count is implicit in the transposed column weights.
Bands bands(int dst_h, int dst_w, const int* index, const float* weights,
            int h_k, int tile_w, int span) {
  Bands bd;
  bd.h_start = index;
  bd.h_count = index + dst_h;
  bd.w_start = index + 2 * dst_h;
  bd.w_count = bd.w_start + dst_w;
  bd.h_w = weights;
  bd.h_k = h_k;
  bd.w_w = weights + static_cast<long long>(dst_h) * h_k;
  bd.tile_w = tile_w;
  bd.span = span;
  return bd;
}

// Both planes of one NV12 batch: luma, and the interleaved UV rows at row
// src_h resized as their own half-size image of pixel pairs.
struct Nv12 {
  Bands y, c;
  Image yim, cim;
  bool ok;
};

Nv12 nv12(long long bs, long long rs, int src_h, int src_w, int dst_h,
          int dst_w, const int* y_index, const float* y_weights, int y_h_k,
          int y_tile_w, int y_window, int y_span, const int* c_index,
          const float* c_weights, int c_h_k, int c_tile_w, int c_window,
          int c_span, long long out_bs, int luma_only) {
  Nv12 n;
  n.ok = !((src_h | src_w | dst_h | dst_w) & 1) && src_h > 0 && src_w > 0 &&
         y_tile_w > 0 && y_window > 0 && y_span > 0 &&
         (luma_only || (c_tile_w > 0 && c_window > 0 && c_span > 0));
  n.y = bands(dst_h, dst_w, y_index, y_weights, y_h_k, y_tile_w, y_span);
  n.c = bands(dst_h / 2, dst_w / 2, c_index, c_weights, c_h_k, c_tile_w,
              c_span);
  n.yim = Image{src_h, src_w, dst_h, dst_w, bs, rs, out_bs, dst_w};
  n.cim = Image{src_h / 2, src_w / 2, dst_h / 2, dst_w / 2, bs, rs, out_bs,
                dst_w};
  return n;
}

}  // namespace

extern "C" {

// Every launcher takes `src`, frame 0 of a [batch, >= src_h*3/2, src_w]
// uint8 NV12 buffer with the given batch and row strides (bytes), and the
// band tables of luma and of chroma (ops/banded.py ResizeTables.args(),
// bf16-rounded weights). The full-function launchers write a contiguous
// [batch, dst_h*3/2, dst_w] uint8 tensor, luma rows then the interleaved
// UV rows, equal to nv12_resize_launch's bf16 output.

// The notebook's `variant` knock-outs into a contiguous [batch, dst_h,
// dst_w] uint8 tensor (luma only): mode 0 both, 1 h_only, 2 w_only,
// 3 dma_only (ops: lab/resize_diag.py resize_phases). Each block XORs what
// it must not drop into sink[block % sink_words] (int32 words, not cleared
// here): the H-pass values (both: chroma; h_only: luma and chroma) or
// its share of the frame's bytes (w_only, dma_only). Two launches for both
// and h_only (luma, then the chroma H pass), one otherwise.
int nv12_resize_phases_launch(const void* src, long long batch_stride,
                              long long row_stride, int batch, int src_h,
                              int src_w, int dst_h, int dst_w,
                              const int* y_index, const float* y_weights,
                              int y_h_k, int y_w_k, int y_tile_w,
                              int y_window, int y_span, const int* c_index,
                              const float* c_weights, int c_h_k, int c_w_k,
                              int c_tile_w, int c_window, int c_span,
                              int mode, void* sink, int sink_words, void* out,
                              void* stream) {
  (void)y_w_k;
  (void)c_w_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const bool chroma = mode == 0 || mode == 1;
  const Nv12 n = nv12(batch_stride, row_stride, src_h, src_w, dst_h, dst_w,
                      y_index, y_weights, y_h_k, y_tile_w, y_window, y_span,
                      c_index, c_weights, c_h_k, c_tile_w, c_window, c_span,
                      static_cast<long long>(dst_h) * dst_w, !chroma);
  if (!n.ok || mode < 0 || mode > 3 || sink == nullptr || sink_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Knock kn;
  kn.sink = static_cast<unsigned*>(sink);
  kn.sink_words = sink_words;
  kn.frame_rows = src_h * 3 / 2;
  kn.rows_out = min(kTile, min(dst_h, kn.frame_rows));
  kn.lanes_out = min(kLaneTile, min(dst_w, src_w));
  kn.vec = aligned16(src) && batch_stride % 16 == 0 && row_stride % 16 == 0 &&
           src_w % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case 0:
      e = launch_strip<kFull, 4, 1>(src, out, n.y, n.yim, kn, batch,
                                    y_window, s);
      break;
    case 1:
      e = launch_strip<kHOnly, 4, 1>(src, out, n.y, n.yim, kn, batch,
                                     max(y_window, kn.lanes_out), s);
      break;
    case 2:
      e = launch_strip<kWOnly, 4, 1>(src, out, n.y, n.yim, kn, batch,
                                     y_window, s);
      break;
    default:
      e = launch_strip<kDmaOnly, 4, 1>(src, out, n.y, n.yim, kn, batch,
                                       y_window, s);
  }
  if (e != cudaSuccess || !chroma) return static_cast<int>(e);
  const void* c_src =
      static_cast<const char*>(src) + static_cast<long long>(src_h) * row_stride;
  return static_cast<int>(launch_strip<kHSink, 4, 2>(
      c_src, out, n.c, n.cim, kn, batch, c_window, s));
}

// The full resize with one block per (column tile, strip, plane) looping
// over the frames, H pass of frame b beside W pass of frame b - 1. One
// launch of 512-thread blocks.
int nv12_resize_skewed_launch(const void* src, long long batch_stride,
                              long long row_stride, int batch, int src_h,
                              int src_w, int dst_h, int dst_w,
                              const int* y_index, const float* y_weights,
                              int y_h_k, int y_w_k, int y_tile_w,
                              int y_window, int y_span, const int* c_index,
                              const float* c_weights, int c_h_k, int c_w_k,
                              int c_tile_w, int c_window, int c_span,
                              void* out, void* stream) {
  (void)y_w_k;
  (void)c_w_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const Nv12 n = nv12(batch_stride, row_stride, src_h, src_w, dst_h, dst_w,
                      y_index, y_weights, y_h_k, y_tile_w, y_window, y_span,
                      c_index, c_weights, c_h_k, c_tile_w, c_window, c_span,
                      static_cast<long long>(dst_h) * 3 / 2 * dst_w, 0);
  if (!n.ok) return static_cast<int>(cudaErrorInvalidValue);
  const int y_ldm = mid_lanes(y_window, 1, 4);
  const int c_ldm = mid_lanes(c_window, 2, 4);
  const size_t y_smem = sizeof(float) * kRows * y_span +
                        2 * sizeof(MT) * kRows * static_cast<size_t>(y_ldm);
  const size_t c_smem = sizeof(float) * kRows * c_span +
                        2 * sizeof(MT) * kRows * static_cast<size_t>(c_ldm);
  const size_t smem = y_smem > c_smem ? y_smem : c_smem;
  const cudaError_t e = allow_smem(skewed_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = max((dst_w + y_tile_w - 1) / y_tile_w,
                        (dst_w / 2 + c_tile_w - 1) / c_tile_w);
  const dim3 grid(tiles, (dst_h + kRows - 1) / kRows, 2);
  skewed_kernel<<<grid, 2 * kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), n.y, n.yim,
      n.c, n.cim, batch, y_ldm, c_ldm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
