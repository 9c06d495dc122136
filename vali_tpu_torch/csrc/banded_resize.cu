// Banded separable resize for Hopper (sm_90a).
//
// Replaces three TPU kernels of vali_tpu/ops/pallas_fused.py, which are one
// algorithm over source lanes of stride C:
//   - pallas_plane_resize  (planes [B, H, W], C = 1)
//   - pallas_packed_resize (packed RGB [B, H, W*3], C = 3: output lane
//                           C*p + c reads input lanes C*q + c only)
//   - pallas_nv12_resize   (NV12 / P010 / P012: luma with C = 1, then the
//                           interleaved UV rows at row H with C = 2 on the
//                           half grid, both into one [B, DH*3/2, DW] tensor)
// Samples are uint8, uint16 or float32; the output has the input's type.
//
// What bounds it on this card: 16 x 4K NV12 -> 1080p reads 199 MB and
// writes 50 MB for ~3.6 GFLOP of FMAs (~15 FLOP/byte), and 64 x 1080p RGB
// -> 224 reads 398 MB for ~5 GFLOP; both lie far under the H100's ~295
// FLOP/byte ridge, so the kernel is bound by moving samples: the device-
// memory reads, and the L2 -> SM traffic of rows that neighbouring blocks
// share. The design therefore reads each source row of a block's window
// once (every output row of the strip whose band covers it accumulates
// it), keeps the H-pass rows in shared memory between the passes, and
// writes each output sample once. CUDA-core FMAs are enough here.
//
// One block: (frame, strip of kRows output rows, tile of tile_w output
// pixel columns). A whole source row does not fit in shared memory (a
// packed 4K RGB row is 11,520 lanes: 8 rows of it are 184 KB in bf16),
// so the H pass keeps only the source-column window that the tile's W
// bands read.
//   Phase 1 (H pass): each thread owns lanes of the window; it walks the
//     strip's source rows once, adding each sample into every output row
//     whose row band covers it (fp32 FMAs in band order), and stores the
//     sums rounded to the compute type (bf16 or fp32): the TPU kernels'
//     cast point.
//   Phase 2 (W pass): each output sample is a weighted sum over its column
//     band from shared memory (fp32 FMAs), then integers round half to
//     even and clamp; floats are stored as they are.
//
// Tables (built on the host by vali_tpu_torch/ops/banded.py resize_tables
// from resize_weights): per output row or column the first source index,
// the tap count and the weights, padded to the largest tap count and
// already rounded to the compute type. A band lies inside its image, so
// the kernel never reads outside it: no pad rows, and padded or strided
// batches are accepted.
//
// Each launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <climits>

#include "banded_common.cuh"

namespace {

using banded::Mid;

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output rows per block (ops/banded.py STRIP_ROWS)

constexpr int kVec = 4;   // source lanes per thread in the H pass

template <typename T> struct Sample;
template <> struct Sample<uint8_t> {
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return static_cast<float>(__ldg(p));
  }
  // kVec samples from a 4-byte aligned address
  static __device__ __forceinline__ void load4(const uint8_t* p, float* x) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      x[i] = static_cast<float>((w >> (8 * i)) & 0xFFu);
  }
  static __device__ __forceinline__ void store(uint8_t* p, float x) {
    *p = static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
  }
};
template <> struct Sample<uint16_t> {
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return static_cast<float>(__ldg(p));
  }
  static __device__ __forceinline__ void load4(const uint16_t* p, float* x) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = static_cast<float>(w.x & 0xFFFFu);
    x[1] = static_cast<float>(w.x >> 16);
    x[2] = static_cast<float>(w.y & 0xFFFFu);
    x[3] = static_cast<float>(w.y >> 16);
  }
  static __device__ __forceinline__ void store(uint16_t* p, float x) {
    *p = static_cast<uint16_t>(fminf(fmaxf(rintf(x), 0.0f), 65535.0f));
  }
};
template <> struct Sample<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void load4(const float* p, float* x) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

// Band tables of one image (see ops/banded.py ResizeTables).
struct Bands {
  const int* h_start; const int* h_count; const float* h_w; int h_k;
  const int* w_start; const int* w_count; const float* w_w;  // [k][dst_w]
  int tile_w;  // output pixels per block tile
  int window;  // source pixels the widest tile reads
  int span;    // source rows the tallest strip reads
};

// Geometry of one image: sizes in pixels, strides in elements.
struct Image {
  int src_h, src_w, dst_h, dst_w;
  long long in_bs, in_rs, out_bs, out_rs;
};

// Lanes of one H-pass row in shared memory: the window, its start rounded
// down to kVec lanes, and its end rounded up.
__host__ __device__ constexpr int mid_lanes(int window, int c) {
  return (window * c + 2 * (kVec - 1)) / kVec * kVec;
}

template <typename T, bool F32, int C>
__global__ void __launch_bounds__(kThreads)
banded_resize_kernel(const T* __restrict__ src, T* __restrict__ out,
                     Bands bd, Image im) {
  using M = Mid<F32>;
  using MT = typename M::T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wd = reinterpret_cast<float*>(smem);  // [kRows][span] row weights
  MT* mid = reinterpret_cast<MT*>(wd + kRows * bd.span);  // [kRows][ldm]
  __shared__ int s_lo, s_hi, s_start[kRows], s_count[kRows];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kRows;
  const int rows = min(kRows, im.dst_h - o0);
  const int p0 = blockIdx.x * bd.tile_w;
  const int cols = min(bd.tile_w, im.dst_w - p0);

  // ---- the strip's row bands and the tile's source window --------------
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  if (tid < kRows) {
    // rows past the image get an empty band
    s_start[tid] = tid < rows ? __ldg(bd.h_start + o0 + tid) : 0;
    s_count[tid] = tid < rows ? __ldg(bd.h_count + o0 + tid) : 0;
  }
  __syncthreads();
  for (int j = tid; j < cols; j += blockDim.x) {
    const int s = __ldg(bd.w_start + p0 + j);
    atomicMin(&s_lo, s);
    atomicMax(&s_hi, s + __ldg(bd.w_count + p0 + j) - 1);
  }
  int r_lo = INT_MAX, r_hi = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (s_count[r] > 0) {
      r_lo = min(r_lo, s_start[r]);
      r_hi = max(r_hi, s_start[r] + s_count[r] - 1);
    }
  }
  const int span = max(r_hi - r_lo + 1, 0);  // <= bd.span
  // the strip's row bands as dense [kRows][span] weights: a row that does
  // not read source row s has weight 0 there, which adds exactly nothing
  for (int i = tid; i < kRows * span; i += blockDim.x) {
    const int r = i / span;
    const int k = r_lo + (i - r * span) - s_start[r];
    wd[r * bd.span + i - r * span] =
        k >= 0 && k < s_count[r]
            ? __ldg(bd.h_w + static_cast<long long>(o0 + r) * bd.h_k + k)
            : 0.0f;
  }
  __syncthreads();
  const int lane0 = s_lo * C / kVec * kVec;  // window start, kVec-aligned
  const int nl = max((s_hi + 1) * C - lane0, 0);
  const int ldm = (nl + kVec - 1) / kVec * kVec;  // <= mid_lanes(window, C)
  const int row_len = im.src_w * C;

  // ---- phase 1: H pass, each source row read once per block -------------
  const T* base = src + static_cast<long long>(b) * im.in_bs + lane0;
  const bool vec = (reinterpret_cast<uintptr_t>(base) %
                    (kVec * sizeof(T))) == 0 && im.in_rs % kVec == 0;
  for (int l = kVec * tid; l < nl; l += kVec * blockDim.x) {
    float acc[kRows][kVec];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[r][i] = 0.0f;
    const bool full = vec && lane0 + l + kVec <= row_len;
    const T* col = base + l + static_cast<long long>(r_lo) * im.in_rs;
    for (int j = 0; j < span; ++j, col += im.in_rs) {
      float x[kVec];
      if (full) {
        Sample<T>::load4(col, x);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          x[i] = lane0 + l + i < row_len ? Sample<T>::load(col + i) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float w = wd[r * bd.span + j];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[r][i] = fmaf(w, x[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (r < rows) mid[r * ldm + l + i] = M::put(acc[r][i]);
  }
  __syncthreads();

  // ---- phase 2: W pass and quantise ------------------------------------
  T* ob = out + static_cast<long long>(b) * im.out_bs +
          static_cast<long long>(o0) * im.out_rs +
          static_cast<long long>(p0) * C;
  const int olanes = cols * C;
  for (int i = tid; i < rows * olanes; i += blockDim.x) {
    const int r = i / olanes;
    const int j = i - r * olanes;
    const int q = j / C;
    const int c = j - q * C;
    const int p = p0 + q;
    const int n = __ldg(bd.w_count + p);
    const MT* m = mid + r * ldm + __ldg(bd.w_start + p) * C - lane0 + c;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
      acc = fmaf(__ldg(bd.w_w + static_cast<long long>(k) * im.dst_w + p),
                 M::get(m[k * C]), acc);
    Sample<T>::store(ob + static_cast<long long>(r) * im.out_rs + j, acc);
  }
}

template <typename T, bool F32, int C>
cudaError_t launch_typed(const void* src, void* out, const Bands& bd,
                         const Image& im, int batch, cudaStream_t stream) {
  auto kern = banded_resize_kernel<T, F32, C>;
  const size_t smem =
      sizeof(float) * kRows * bd.span +
      sizeof(typename Mid<F32>::T) * kRows * mid_lanes(bd.window, C);
  cudaError_t e = banded::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((im.dst_w + bd.tile_w - 1) / bd.tile_w,
                  (im.dst_h + kRows - 1) / kRows, batch);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(src),
                                         static_cast<T*>(out), bd, im);
  return cudaGetLastError();
}

// in_kind 0 = uint8 (bf16 or fp32 compute), 1 = uint16, 2 = float32 (fp32
// compute only).
template <int C>
cudaError_t launch(int in_kind, int f32, const void* src, void* out,
                   const Bands& bd, const Image& im, int batch,
                   cudaStream_t s) {
  if (batch <= 0 || im.dst_h <= 0 || im.dst_w <= 0) return cudaSuccess;
  if (im.src_h <= 0 || im.src_w <= 0 || bd.tile_w <= 0 || bd.window <= 0 ||
      bd.span <= 0)
    return cudaErrorInvalidValue;
  switch (in_kind) {
    case 0:
      return f32 ? launch_typed<uint8_t, true, C>(src, out, bd, im, batch, s)
                 : launch_typed<uint8_t, false, C>(src, out, bd, im, batch,
                                                   s);
    case 1:
      if (!f32) return cudaErrorInvalidValue;
      return launch_typed<uint16_t, true, C>(src, out, bd, im, batch, s);
    case 2:
      if (!f32) return cudaErrorInvalidValue;
      return launch_typed<float, true, C>(src, out, bd, im, batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The column tap count is implicit in the transposed column weights.
Bands bands(int dst_h, int dst_w, const int* index, const float* weights,
            int h_k, int /*w_k*/, int tile_w, int window, int span) {
  Bands bd;
  bd.h_start = index;
  bd.h_count = index + dst_h;
  bd.w_start = index + 2 * dst_h;
  bd.w_count = bd.w_start + dst_w;
  bd.h_w = weights;
  bd.h_k = h_k;
  bd.w_w = weights + static_cast<long long>(dst_h) * h_k;
  bd.tile_w = tile_w;
  bd.window = window;
  bd.span = span;
  return bd;
}

int elem_bytes(int in_kind) { return in_kind == 0 ? 1 : in_kind == 1 ? 2 : 4; }

}  // namespace

extern "C" {

// Planes: `src` is frame 0 of [B, >= src_h, src_w] samples with the given
// batch and row strides (elements); `out` is frame 0 of [B, dst_h, dst_w]
// with its own strides. Tables as ops/banded.py ResizeTables.args().
int plane_resize_launch(const void* src, int in_kind, long long batch_stride,
                        long long row_stride, int batch, int src_h,
                        int src_w, int dst_h, int dst_w, const int* index,
                        const float* weights, int h_k, int w_k, int tile_w,
                        int window, int span, int f32_compute, void* out,
                        long long out_batch_stride, long long out_row_stride,
                        void* stream) {
  const Image im{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                 out_batch_stride, out_row_stride};
  return static_cast<int>(launch<1>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, index, weights, h_k, w_k, tile_w, window, span),
      im, batch, static_cast<cudaStream_t>(stream)));
}

// Packed 3-channel samples: `src` is frame 0 of [B, >= src_h, src_w * 3],
// `out` of [B, dst_h, dst_w * 3]; widths are in pixels, strides in
// elements. Everything else as plane_resize_launch.
int packed_resize_launch(const void* src, int in_kind,
                         long long batch_stride, long long row_stride,
                         int batch, int src_h, int src_w, int dst_h,
                         int dst_w, const int* index, const float* weights,
                         int h_k, int w_k, int tile_w, int window,
                         int span, int f32_compute, void* out,
                         long long out_batch_stride,
                         long long out_row_stride, void* stream) {
  const Image im{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                 out_batch_stride, out_row_stride};
  return static_cast<int>(launch<3>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, index, weights, h_k, w_k, tile_w, window, span),
      im, batch, static_cast<cudaStream_t>(stream)));
}

// NV12 / P010 / P012: `src` is frame 0 of [B, >= src_h*3/2, src_w] with
// the given strides (elements), in_kind 0 = uint8, 1 = uint16. `out` is a
// contiguous [B, dst_h*3/2, dst_w] tensor of the same type: luma rows
// first, then the interleaved UV rows. The first table set resizes luma
// (src_h x src_w -> dst_h x dst_w), the second the chroma pairs on the
// half grid (src_h/2 x src_w/2 -> dst_h/2 x dst_w/2). Two launches.
int nv12_resize_launch(const void* src, int in_kind, long long batch_stride,
                       long long row_stride, int batch, int src_h, int src_w,
                       int dst_h, int dst_w, const int* y_index,
                       const float* y_weights, int y_h_k, int y_w_k,
                       int y_tile_w, int y_window, int y_span,
                       const int* c_index, const float* c_weights,
                       int c_h_k, int c_w_k, int c_tile_w, int c_window,
                       int c_span, int f32_compute,
                       void* out, void* stream) {
  if ((src_h | src_w | dst_h | dst_w) & 1 || in_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long out_bs = static_cast<long long>(dst_h) * 3 / 2 * dst_w;
  const Image luma{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                   out_bs, dst_w};
  cudaError_t e = launch<1>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, y_index, y_weights, y_h_k, y_w_k, y_tile_w,
            y_window, y_span), luma, batch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int eb = elem_bytes(in_kind);
  const void* c_src = static_cast<const char*>(src) +
                      static_cast<long long>(src_h) * row_stride * eb;
  void* c_out = static_cast<char*>(out) +
                static_cast<long long>(dst_h) * dst_w * eb;
  const Image chroma{src_h / 2, src_w / 2, dst_h / 2, dst_w / 2,
                     batch_stride, row_stride, out_bs, dst_w};
  return static_cast<int>(launch<2>(
      in_kind, f32_compute, c_src, c_out,
      bands(dst_h / 2, dst_w / 2, c_index, c_weights, c_h_k, c_w_k,
            c_tile_w, c_window, c_span), chroma, batch, s));
}

}  // extern "C"
