// Banded fused YUV -> RGB preprocess for Hopper (sm_90a).
//
// Replaces the four TPU kernels of vali_tpu/ops/pallas_fused.py on the
// decode -> preprocess path:
//   - pallas_nv12_preprocess   (NV12 / P010 / P012: Y plane stacked on
//                               interleaved UV rows)
//   - pallas_yuv420_preprocess (planar I420, 8-bit or LSB-aligned 10-bit)
//   - pallas_yuv422_preprocess (planar 4:2:2, 8-bit: full-height,
//                               half-width U and V)
//   - pallas_yuv444_preprocess (planar 4:4:4, 8-bit: full-resolution U, V)
// All compute the same thing: a banded H pass over luma and chroma rows,
// a banded W pass, a 3x3 CSC, then round/clip to uint8 or scale (and
// optionally normalise) to float. They differ only in how chroma is
// addressed (the Layout template parameter), so one template serves all
// four. The host builds the chroma tables of each layout: 4:2:2 chroma
// rows use the luma row bands, 4:4:4 chroma uses both luma band sets.
//
// What bounds it on this card: one 64 x 1080p -> 224x224 batch reads about
// 199 MB (4:2:0), 265 MB (4:2:2) or 398 MB (4:4:4) and does a few GFLOP of
// FMAs, ~15 FLOP/byte, far under the H100's ~295 FLOP/byte ridge, so the
// kernel is bound by device-memory reads. The design therefore reads every source sample from device memory
// in 16-byte coalesced loads, keeps the H-pass rows in shared memory
// between the passes (they never go back to device memory) and writes only
// the small planar output. CUDA-core FMAs are enough at this intensity.
//
// Layout of one block: one (frame, strip of `rows` output rows).
//   Phase 1 (H pass): for each output row of the strip, every column of
//     luma and chroma is a weighted sum over that row's band of source
//     rows: fp32 FMAs, the result rounded to the compute type (bf16 or
//     fp32) and kept in shared memory — the TPU kernel's cast point. Chroma
//     is stored interleaved (U at 2j, V at 2j+1) for every layout, in rows
//     of twice the chroma plane width (W for 4:2:0 and 4:2:2, 2W for
//     4:4:4).
//   Phase 2 (W pass + tail): each output pixel is a weighted sum over its
//     column band from shared memory, then the CSC in fp32 and the
//     quantise/normalise tail, written to out[b, c, o, p].
//
// Tables (built on the host by vali_tpu_torch/ops/banded.py): per output
// row or column the first source index, the tap count and the weights
// padded to the largest tap count. A band lies inside its plane, so the
// kernel never reads outside a plane and needs no pad rows. Weights arrive
// already rounded to the compute type.
//
// Each launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates. The device code
// the lab variants of nv12_variants.cu share with this kernel (frame and
// table descriptions, loaders and stores, the H pass) lives in
// banded_preprocess.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_preprocess.cuh"

namespace {

using banded::aligned16;
using banded::chroma_cols;
using banded::Geometry;
using banded::hpass;
using banded::kI420;
using banded::kI422;
using banded::kI444;
using banded::kNV12;
using banded::kSmemLimit;
using banded::Mid;
using banded::Out;
using banded::Planes;
using banded::smem_bytes;
using banded::Tables;
using banded::Tail;

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;            // output rows per block

template <typename TIn, typename TOut, bool F32, int L>
__global__ void __launch_bounds__(kThreads)
banded_preprocess_kernel(Planes pl, Tables t, Tail tl, Geometry g,
                         TOut* __restrict__ out) {
  using M = Mid<F32>;
  using T = typename M::T;
  const int cw = chroma_cols(L, g.src_w);  // samples per U or V row
  const int crow_w = 2 * cw;               // interleaved U/V row
  extern __shared__ __align__(16) unsigned char smem[];
  T* yh = reinterpret_cast<T*>(smem);    // [rows][src_w] luma
  T* ch = yh + g.rows * g.src_w;         // [rows][crow_w] interleaved U/V

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * g.rows;
  const int rows = min(g.rows, g.dst_h - o0);
  const bool vec = pl.vec != 0;

  // ---- phase 1: banded H pass into shared memory -----------------------
  hpass<TIn, F32>(static_cast<const TIn*>(pl.y) + b * pl.y_bs, pl.y_rs,
                  g.src_w, o0, rows, t.hy_start, t.hy_count, t.hy_w,
                  t.hy_k, yh, g.src_w, 1, 0, vec);
  if (L == kNV12) {
    // interleaved UV rows: resampled as W columns, already interleaved
    hpass<TIn, F32>(static_cast<const TIn*>(pl.u) + b * pl.u_bs, pl.u_rs,
                    crow_w, o0, rows, t.hc_start, t.hc_count, t.hc_w,
                    t.hc_k, ch, crow_w, 1, 0, vec);
  } else {
    hpass<TIn, F32>(static_cast<const TIn*>(pl.u) + b * pl.u_bs, pl.u_rs,
                    cw, o0, rows, t.hc_start, t.hc_count, t.hc_w, t.hc_k,
                    ch, crow_w, 2, 0, vec);
    hpass<TIn, F32>(static_cast<const TIn*>(pl.v) + b * pl.v_bs, pl.v_rs,
                    cw, o0, rows, t.hc_start, t.hc_count, t.hc_w, t.hc_k,
                    ch, crow_w, 2, 1, vec);
  }
  __syncthreads();

  // ---- phase 2: banded W pass, CSC, quantise/normalise -----------------
  // (kept in the kernel body: the same loop called as a function, as the
  // lab variants of nv12_variants.cu call it, compiles this kernel to 40
  // registers instead of 48 and took a 64 x 1080p NV12 u8 batch from 0.48
  // to 0.57 ms, same bits; NVIDIA H100 80GB HBM3, 700.00 W)
  const int DW = g.dst_w;
  const long long plane_sz = static_cast<long long>(g.dst_h) * DW;
  TOut* ob = out + static_cast<long long>(b) * 3 * plane_sz;
  for (int item = threadIdx.x; item < rows * DW; item += blockDim.x) {
    const int r = item / DW;
    const int p = item - r * DW;
    const T* yrow = yh + r * g.src_w;
    const T* crow = ch + r * crow_w;

    float ya = 0.0f;
    const int ys = __ldg(t.wy_start + p), yn = __ldg(t.wy_count + p);
    for (int k = 0; k < yn; ++k)
      ya = fmaf(__ldg(t.wy_w + k * DW + p), M::get(yrow[ys + k]), ya);

    float ua = 0.0f, va = 0.0f;
    const int cs = __ldg(t.wc_start + p), cn = __ldg(t.wc_count + p);
    for (int k = 0; k < cn; ++k) {
      const float wk = __ldg(t.wc_w + k * DW + p);
      const int j = 2 * (cs + k);
      ua = fmaf(wk, M::get(crow[j]), ua);
      va = fmaf(wk, M::get(crow[j + 1]), va);
    }
    const float yv = __fsub_rn(ya, tl.y_off);
    const float u = __fsub_rn(ua, tl.c_off);
    const float v = __fsub_rn(va, tl.c_off);
    const long long pix = static_cast<long long>(o0 + r) * DW + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // no FMA contraction: same rounding as three separate products
      const float x = __fadd_rn(
          __fadd_rn(__fmul_rn(tl.m[3 * c], yv), __fmul_rn(tl.m[3 * c + 1], u)),
          __fmul_rn(tl.m[3 * c + 2], v));
      Out<TOut>::store(ob + c * plane_sz + pix, x, c, tl);
    }
  }
}

template <typename TIn, typename TOut, bool F32, int L>
cudaError_t launch_typed(const Planes& pl, const Tables& t, const Tail& tl,
                         const Geometry& g, void* out, cudaStream_t stream) {
  auto kern = banded_preprocess_kernel<TIn, TOut, F32, L>;
  const size_t smem = static_cast<size_t>(
      smem_bytes(L, g.rows, g.src_w, sizeof(typename Mid<F32>::T)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.dst_h + g.rows - 1) / g.rows, g.batch);
  kern<<<grid, kThreads, smem, stream>>>(pl, t, tl, g,
                                         static_cast<TOut*>(out));
  return cudaGetLastError();
}

template <typename TIn, typename TOut, int L>
cudaError_t pick_compute(int f32, const Planes& pl, const Tables& t,
                         const Tail& tl, const Geometry& g, void* out,
                         cudaStream_t s) {
  return f32 ? launch_typed<TIn, TOut, true, L>(pl, t, tl, g, out, s)
             : launch_typed<TIn, TOut, false, L>(pl, t, tl, g, out, s);
}

template <typename TIn, int L>
cudaError_t pick_out(int out_kind, int f32, const Planes& pl,
                     const Tables& t, const Tail& tl, const Geometry& g,
                     void* out, cudaStream_t s) {
  switch (out_kind) {
    case 0: return pick_compute<TIn, uint8_t, L>(f32, pl, t, tl, g, out, s);
    case 1: return pick_compute<TIn, float, L>(f32, pl, t, tl, g, out, s);
    case 2:
      return pick_compute<TIn, __nv_bfloat16, L>(f32, pl, t, tl, g, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// Shared part of the launchers: tables, tail, strip height, dispatch.
// 4:2:2 and 4:4:4 take uint8 samples only, as their TPU kernels do.
template <int L>
cudaError_t launch(Planes pl, int in_bytes, int batch, int src_h, int src_w,
                   int dst_h, int dst_w, const int* index,
                   const float* weights, int hy_k, int hc_k, int wy_k,
                   int wc_k, const float* tail, int f32, void* out,
                   int out_kind, cudaStream_t stream) {
  constexpr bool kWide = L == kNV12 || L == kI420;  // takes uint16 samples
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return cudaSuccess;
  if ((in_bytes != 1 && !(kWide && in_bytes == 2)) || src_w <= 0 ||
      (L != kI444 && (src_w & 1)))
    return cudaErrorInvalidValue;

  const Tables t = banded::unpack_tables(index, weights, dst_h, dst_w, hy_k,
                                         hc_k, wy_k);
  const Tail tl = banded::unpack_tail(tail);

  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  const int elem = f32 ? 4 : 2;
  int rows = kMaxRows < dst_h ? kMaxRows : dst_h;
  while (rows > 1 && smem_bytes(L, rows, src_w, elem) > kSmemLimit) --rows;
  if (smem_bytes(L, rows, src_w, elem) > kSmemLimit)
    return cudaErrorInvalidValue;
  g.rows = rows;

  // 16-byte vector loads need every row start of every plane aligned and
  // widths that are whole vectors
  const int vec = 16 / in_bytes;  // elements per 16 bytes
  bool ok = aligned16(pl.y) && aligned16(pl.u) && src_w % vec == 0 &&
            pl.y_bs % vec == 0 && pl.y_rs % vec == 0 &&
            pl.u_bs % vec == 0 && pl.u_rs % vec == 0;
  if (L != kNV12)
    ok = ok && aligned16(pl.v) && chroma_cols(L, src_w) % vec == 0 &&
         pl.v_bs % vec == 0 && pl.v_rs % vec == 0;
  pl.vec = ok ? 1 : 0;

  if (in_bytes == 1)
    return pick_out<uint8_t, L>(out_kind, f32, pl, t, tl, g, out, stream);
  if constexpr (kWide)
    return pick_out<uint16_t, L>(out_kind, f32, pl, t, tl, g, out, stream);
  return cudaErrorInvalidValue;
}

// Planar y/u/v with their own strides, the shared part of the three planar
// launchers.
template <int L>
cudaError_t launch_planar(const void* y, const void* u, const void* v,
                          int in_bytes, long long y_bs, long long y_rs,
                          long long u_bs, long long u_rs, long long v_bs,
                          long long v_rs, int batch, int src_h, int src_w,
                          int dst_h, int dst_w, const int* index,
                          const float* weights, int hy_k, int hc_k, int wy_k,
                          int wc_k, const float* tail, int f32, void* out,
                          int out_kind, void* stream) {
  Planes pl;
  pl.y = y;
  pl.u = u;
  pl.v = v;
  pl.y_bs = y_bs;
  pl.y_rs = y_rs;
  pl.u_bs = u_bs;
  pl.u_rs = u_rs;
  pl.v_bs = v_bs;
  pl.v_rs = v_rs;
  pl.vec = 0;
  return launch<L>(pl, in_bytes, batch, src_h, src_w, dst_h, dst_w, index,
                   weights, hy_k, hc_k, wy_k, wc_k, tail, f32, out, out_kind,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// NV12 / P010 / P012: `src` is frame 0 of a [B, >= H*3/2, W] plane with
// the given batch and row strides (elements); the interleaved UV rows
// start at row H. in_bytes 1 = uint8, 2 = uint16. out is a contiguous
// [B, 3, dst_h, dst_w] tensor: out_kind 0 = uint8, 1 = float32,
// 2 = bfloat16. `tail` is a host array of 18 floats (see
// vali_tpu_torch/ops/banded.py tail_params).
int nv12_preprocess_launch(const void* src, int in_bytes,
                           long long batch_stride, long long row_stride,
                           int batch, int src_h, int src_w, int dst_h,
                           int dst_w, const int* index, const float* weights,
                           int hy_k, int hc_k, int wy_k, int wc_k,
                           const float* tail, int f32_compute, void* out,
                           int out_kind, void* stream) {
  Planes pl;
  pl.y = src;
  pl.u = static_cast<const char*>(src) +
         static_cast<long long>(src_h) * row_stride * in_bytes;
  pl.v = pl.u;
  pl.y_bs = pl.u_bs = pl.v_bs = batch_stride;
  pl.y_rs = pl.u_rs = pl.v_rs = row_stride;
  pl.vec = 0;
  return static_cast<int>(launch<kNV12>(
      pl, in_bytes, batch, src_h, src_w, dst_h, dst_w, index, weights, hy_k,
      hc_k, wy_k, wc_k, tail, f32_compute, out, out_kind,
      static_cast<cudaStream_t>(stream)));
}

// Planar I420 (8-bit or LSB-aligned 10-bit): y [B, >= H, W], u and v
// [B, >= H/2, W/2], each frame 0 of a plane with its own strides
// (elements). Everything else as nv12_preprocess_launch.
int yuv420_preprocess_launch(const void* y, const void* u, const void* v,
                             int in_bytes, long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const float* tail, int f32_compute, void* out,
                             int out_kind, void* stream) {
  return static_cast<int>(launch_planar<kI420>(
      y, u, v, in_bytes, y_batch_stride, y_row_stride, u_batch_stride,
      u_row_stride, v_batch_stride, v_row_stride, batch, src_h, src_w, dst_h,
      dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, tail, f32_compute, out,
      out_kind, stream));
}

// Planar 4:2:2, uint8: y [B, >= H, W], u and v [B, >= H, W/2]. The chroma
// row tables of the geometry are the luma row tables. Everything else as
// yuv420_preprocess_launch.
int yuv422_preprocess_launch(const void* y, const void* u, const void* v,
                             long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const float* tail, int f32_compute, void* out,
                             int out_kind, void* stream) {
  return static_cast<int>(launch_planar<kI422>(
      y, u, v, 1, y_batch_stride, y_row_stride, u_batch_stride,
      u_row_stride, v_batch_stride, v_row_stride, batch, src_h, src_w, dst_h,
      dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, tail, f32_compute, out,
      out_kind, stream));
}

// Planar 4:4:4, uint8: y, u and v [B, >= H, W]. The chroma tables of the
// geometry are the luma tables. Everything else as
// yuv420_preprocess_launch.
int yuv444_preprocess_launch(const void* y, const void* u, const void* v,
                             long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const float* tail, int f32_compute, void* out,
                             int out_kind, void* stream) {
  return static_cast<int>(launch_planar<kI444>(
      y, u, v, 1, y_batch_stride, y_row_stride, u_batch_stride,
      u_row_stride, v_batch_stride, v_row_stride, batch, src_h, src_w, dst_h,
      dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, tail, f32_compute, out,
      out_kind, stream));
}

const char* banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
