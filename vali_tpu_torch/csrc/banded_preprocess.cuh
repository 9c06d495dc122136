// Device code shared by the banded preprocess kernels
// (banded_preprocess.cu) and their tensor-core lab variants
// (nv12_grouped.cu and the kernels on static2_passes.cuh): the frame and
// table descriptions, the output stores and the tensor-core variants' CSC
// tail.
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

}  // namespace banded
