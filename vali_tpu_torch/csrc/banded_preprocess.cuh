// Device code shared by the banded preprocess kernels
// (banded_preprocess.cu) and their lab variants (nv12_variants.cu,
// nv12_grouped.cu, nv12_static2.cu): the frame and table descriptions, the
// sample loaders and output stores, the tensor-core variants' CSC tail,
// the H pass of one plane segment, the shared-memory sizing of a strip,
// and the lab variants' W pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_common.cuh"

namespace banded {

// How the chroma samples of a frame are laid out.
enum Layout : int {
  kNV12 = 0,  // interleaved UV rows under the Y plane, half height and width
  kI420 = 1,  // planar U and V, half height and half width
  kI422 = 2,  // planar U and V, full height and half width
  kI444 = 3,  // planar U and V, full resolution
};

// Samples in one row of one chroma plane (U or V) of a src_w-wide frame;
// the interleaved chroma rows in shared memory are twice as wide.
__host__ __device__ __forceinline__ int chroma_cols(int layout, int src_w) {
  return layout == kI444 ? src_w : src_w / 2;
}

struct Tables {
  const int* hy_start; const int* hy_count; const float* hy_w; int hy_k;
  const int* hc_start; const int* hc_count; const float* hc_w; int hc_k;
  // column weights are stored transposed: w[k * dst_w + p]
  const int* wy_start; const int* wy_count; const float* wy_w;
  const int* wc_start; const int* wc_count; const float* wc_w;
};

struct Planes {
  const void* y; const void* u; const void* v;   // frame 0 of each plane
  long long y_bs, y_rs, u_bs, u_rs, v_bs, v_rs;  // strides in elements
  int vec;  // 1: every row start is 16-byte aligned, widths fit vectors
};

// CSC and quantise/normalise constants, in the input's stored units;
// without normalisation mean is 0 and std 1, which change nothing.
struct Tail {
  float m[9];
  float y_off, c_off, div;
  float mean[3], stdv[3];
};

struct Geometry {
  int batch, src_h, src_w, dst_h, dst_w, rows;
};

// The tables as the launchers receive them (see ops/banded.py
// DeviceTables): `index` holds the row and column starts and counts back
// to back, `weights` the row weights, then the transposed column weights.
inline Tables unpack_tables(const int* index, const float* weights,
                            int dst_h, int dst_w, int hy_k, int hc_k,
                            int wy_k) {
  Tables t;
  t.hy_start = index;
  t.hy_count = index + dst_h;
  t.hc_start = index + 2 * dst_h;
  t.hc_count = index + 3 * dst_h;
  t.wy_start = index + 4 * dst_h;
  t.wy_count = t.wy_start + dst_w;
  t.wc_start = t.wy_start + 2 * dst_w;
  t.wc_count = t.wy_start + 3 * dst_w;
  t.hy_w = weights;
  t.hy_k = hy_k;
  t.hc_w = t.hy_w + static_cast<long long>(dst_h) * hy_k;
  t.hc_k = hc_k;
  t.wy_w = t.hc_w + static_cast<long long>(dst_h) * hc_k;
  t.wc_w = t.wy_w + static_cast<long long>(wy_k) * dst_w;
  return t;
}

// The 18 floats of ops/banded.py tail_params.
inline Tail unpack_tail(const float* tail) {
  Tail tl;
  for (int i = 0; i < 9; ++i) tl.m[i] = tail[i];
  tl.y_off = tail[9];
  tl.c_off = tail[10];
  tl.div = tail[11];
  for (int i = 0; i < 3; ++i) {
    tl.mean[i] = tail[12 + i];
    tl.stdv[i] = tail[15 + i];
  }
  return tl;
}

// A table entry: through the read-only cache from device memory, or a
// plain load when the block has staged its tables in shared memory.
template <bool kShared, typename T>
__device__ __forceinline__ T tab(const T* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// --- input samples: one 16-byte load -> kVec exact fp32 values ----------
template <typename TIn> struct In;
template <> struct In<uint8_t> {
  static constexpr int kVec = 16;
  static __device__ __forceinline__ void load_vec(const uint8_t* p,
                                                  float* f) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[4 * j + i] = static_cast<float>((w[j] >> (8 * i)) & 0xFFu);
  }
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return static_cast<float>(__ldg(p));
  }
};
template <> struct In<uint16_t> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void load_vec(const uint16_t* p,
                                                  float* f) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        f[2 * j + i] = static_cast<float>((w[j] >> (16 * i)) & 0xFFFFu);
  }
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return static_cast<float>(__ldg(p));
  }
};

// --- output element ------------------------------------------------------
template <typename TOut> struct Out;
template <> struct Out<uint8_t> {
  static __device__ __forceinline__ void store(uint8_t* p, float x,
                                               int /*c*/, const Tail& t) {
    // round half to even, then clip (jnp.round / torch.round semantics)
    float q = rintf(__fdiv_rn(x, t.div));
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    *p = static_cast<uint8_t>(q);
  }
};
__device__ __forceinline__ float scaled(float x, int c, const Tail& t) {
  return __fdiv_rn(__fsub_rn(__fdiv_rn(x, t.div), t.mean[c]), t.stdv[c]);
}
template <> struct Out<float> {
  static __device__ __forceinline__ void store(float* p, float x, int c,
                                               const Tail& t) {
    *p = scaled(x, c, t);
  }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x,
                                               int c, const Tail& t) {
    *p = __float2bfloat16_rn(scaled(x, c, t));
  }
};

// The product's tail for one pixel of the tensor-core lab kernels
// (nv12_grouped.cu, nv12_static2.cu): CSC of its W sums, round and clip to
// uint8, stored at `pix` of each of the three planes (`plane_sz` apart).
__device__ __forceinline__ void csc_store(uint8_t* ob, long long plane_sz,
                                          long long pix, float ya, float ua,
                                          float va, const Tail& tl) {
  const float yv = __fsub_rn(ya, tl.y_off);
  const float u = __fsub_rn(ua, tl.c_off);
  const float v = __fsub_rn(va, tl.c_off);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // no FMA contraction: same rounding as three separate products
    const float x = __fadd_rn(
        __fadd_rn(__fmul_rn(tl.m[3 * c], yv), __fmul_rn(tl.m[3 * c + 1], u)),
        __fmul_rn(tl.m[3 * c + 2], v));
    Out<uint8_t>::store(ob + c * plane_sz + pix, x, c, tl);
  }
}

// H pass of one plane segment: `ncols` columns of `rows` output rows,
// written to dst[r * dst_w + col * step + off]. Row o0 + r of the tables
// is output row r.
template <typename TIn, bool F32>
__device__ __forceinline__ void hpass(
    const TIn* plane, long long rs, int ncols, int o0, int rows,
    const int* start, const int* count, const float* w, int k_max,
    typename Mid<F32>::T* dst, int dst_w, int step, int off, bool vec) {
  using M = Mid<F32>;
  if (vec) {
    constexpr int V = In<TIn>::kVec;
    const int groups = ncols / V;
    for (int item = threadIdx.x; item < rows * groups; item += blockDim.x) {
      const int r = item / groups;
      const int g = item - r * groups;
      const int o = o0 + r;
      const int n = __ldg(count + o);
      const float* wr = w + static_cast<long long>(o) * k_max;
      const TIn* src = plane +
                       static_cast<long long>(__ldg(start + o)) * rs +
                       static_cast<long long>(g) * V;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float x[V];
        In<TIn>::load_vec(src + static_cast<long long>(k) * rs, x);
        const float wk = __ldg(wr + k);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wk, x[i], acc[i]);
      }
      typename M::T* d = dst + r * dst_w + (g * V) * step + off;
#pragma unroll
      for (int i = 0; i < V; ++i) d[i * step] = M::put(acc[i]);
    }
  } else {
    for (int item = threadIdx.x; item < rows * ncols; item += blockDim.x) {
      const int r = item / ncols;
      const int col = item - r * ncols;
      const int o = o0 + r;
      const int n = __ldg(count + o);
      const float* wr = w + static_cast<long long>(o) * k_max;
      const TIn* src = plane +
                       static_cast<long long>(__ldg(start + o)) * rs + col;
      float acc = 0.0f;
      for (int k = 0; k < n; ++k)
        acc = fmaf(__ldg(wr + k),
                   In<TIn>::load(src + static_cast<long long>(k) * rs), acc);
      dst[r * dst_w + col * step + off] = M::put(acc);
    }
  }
}

// Shared memory of a block of `rows` output rows: the luma rows and the
// interleaved chroma rows of its H pass.
inline long long smem_bytes(int layout, int rows, int src_w, int elem) {
  return static_cast<long long>(rows) *
         (src_w + 2 * chroma_cols(layout, src_w)) * elem;
}

// How the lab variants keep their chroma H-pass rows in shared memory.
enum ChromaRows : int {
  kInterleaved = 0,  // row r at ch[r * pitch]: U at 2j, V at 2j + 1
  kTransposed = 2,   // interleaved column j of row r at ch[j * pitch + r]
};

// The lab variants' phase 2 (nv12_variants.cu): the product kernel's W
// pass, CSC and round/clip to uint8 of `rows` bf16 H-pass rows, for output
// columns [p0, p0 + np). Luma row r is at yh[r * y_pitch] and holds source
// columns from ylo on; the chroma rows are laid out as kC says,
// interleaved columns from clo on. Output row r is o0 + r of the [3,
// dst_h, DW] planes at `ob`.
template <int kC>
__device__ __forceinline__ void wpass_store(
    const __nv_bfloat16* yh, const __nv_bfloat16* ch, int y_pitch,
    int c_pitch, int rows, int o0, int dst_h, int DW, int p0, int np,
    int ylo, int clo, const Tables& t, const Tail& tl, uint8_t* ob) {
  using M = Mid<false>;
  const long long plane_sz = static_cast<long long>(dst_h) * DW;
  for (int item = threadIdx.x; item < rows * np; item += blockDim.x) {
    const int r = item / np;
    const int p = p0 + item - r * np;
    const __nv_bfloat16* yrow = yh + r * y_pitch;
    const __nv_bfloat16* crow =
        kC == kTransposed ? ch + r : ch + r * c_pitch;
    const int cstep = kC == kTransposed ? c_pitch : 1;

    float ya = 0.0f;
    const int ys = __ldg(t.wy_start + p) - ylo;
    const int yn = __ldg(t.wy_count + p);
    for (int k = 0; k < yn; ++k)
      ya = fmaf(__ldg(t.wy_w + k * DW + p), M::get(yrow[ys + k]), ya);

    float ua = 0.0f, va = 0.0f;
    const int cs = __ldg(t.wc_start + p), cn = __ldg(t.wc_count + p);
    for (int k = 0; k < cn; ++k) {
      const float wk = __ldg(t.wc_w + k * DW + p);
      const int j = 2 * (cs + k) - clo;
      ua = fmaf(wk, M::get(crow[j * cstep]), ua);
      va = fmaf(wk, M::get(crow[(j + 1) * cstep]), va);
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
      Out<uint8_t>::store(ob + c * plane_sz + pix, x, c, tl);
    }
  }
}

}  // namespace banded
