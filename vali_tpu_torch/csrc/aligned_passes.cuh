// The two resize passes over aligned windows on the tensor cores, shared
// by lab kernels `aligned` (nv12_aligned.cu) and `streamed`
// (nv12_streamed.cu): the H product of one 128-byte column chunk of a
// strip's window, its bf16 H rows, and the W product and uint8 store of
// one 64-pixel output tile. The host tables are lab/resize_diag.py's
// AlignedPlane. sm_90a only.
//
//   - H product, transposed: D [64 byte columns, kRows rows] = A [64
//     columns, k_pad] x B [k_pad, kRows], wgmma m64n32k16 bf16 -> fp32
//     with A built in registers from the window's raw bytes, B the
//     strip's weights in shared memory (K-major core matrices).
//   - H rows: the fp32 sums rounded to bf16 (the notebook's cast point):
//     luma kRows rows, chroma kRows U rows then kRows V rows
//     (deinterleaved as they are stored), as 8 x 8 core matrices, column
//     groups padded by 16 bytes; columns past the plane are zeros.
//   - W product: D [64 output pixels, N] = A x the H rows in place (N =
//     kRows luma: m64n32k16; N = 2 kRows chroma, m64n64k16: one A of
//     chroma weights serves U and V), then round, clip and uint8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace passes {

constexpr int kRows = 32;   // output rows of a strip: N of the H product
constexpr int kWTile = 64;  // output pixels of a W tile: M of the W product

// Bytes of one 8-column group of a plane's tiled H rows: kRows rows (CH
// kRows U then kRows V rows for chroma) of 16 bytes, and 16 of padding.
template <int CH>
constexpr int kGroupBytes = 16 * kRows * CH + 16;

__device__ __forceinline__ uint8_t quantise(float x) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
}

// d = A x B of one chunk: A's NK k-steps in registers, B at descriptor
// `bdesc` ([16 NK, kRows] bf16, K-major core matrices, 128 bytes apart
// along K, 256 along N). Waits for the products.
template <int NK>
__device__ __forceinline__ void h_product(float (&d)[kRows / 2],
                                          const unsigned (&a)[NK][4],
                                          uint64_t bdesc) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) d[i] = 0.0f;
  wgmma::fence();
#pragma unroll
  for (int ks = 0; ks < NK; ++ks)
    wgmma::mma<kRows>(d, make_uint4(a[ks][0], a[ks][1], a[ks][2], a[ks][3]),
                      bdesc + ((ks * kRows * 32) >> 4));
  wgmma::commit();
  wgmma::wait_all();
}

// The thread's share of a chunk's H product into the tiled H rows:
// d[4 j + e], d[4 j + 2 + e] are row 8 j + 2 tq + e of byte columns c and
// c + 1 of the range (luma: two pixels; chroma: U and V of pixel c / 2);
// columns from `hbytes` on are not the range's, those from `end` on lie
// past the plane (zeros).
template <int CH>
__device__ __forceinline__ void store_h(unsigned char* hrows,
                                        const float (&d)[kRows / 2], int c,
                                        int hbytes, int end, int tq) {
  constexpr int kGroup = kGroupBytes<CH>;
  if (c >= hbytes) return;
  const bool in = c < end;  // a row's bytes are even: c + 1 < end too
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * tq + e;
      const float lo = in ? d[4 * j + e] : 0.0f;
      const float hi = in ? d[4 * j + 2 + e] : 0.0f;
      if constexpr (CH == 1) {
        *reinterpret_cast<unsigned*>(hrows + wgmma::h_off(r, c, kGroup)) =
            wgmma::pack_bf16(lo, hi);
      } else {
        *reinterpret_cast<__nv_bfloat16*>(
            hrows + wgmma::h_off(r, c / 2, kGroup)) = __float2bfloat16_rn(lo);
        *reinterpret_cast<__nv_bfloat16*>(
            hrows + wgmma::h_off(kRows + r, c / 2, kGroup)) =
            __float2bfloat16_rn(hi);
      }
    }
  }
}

// W product of output tile t over the H rows of a range whose first H
// pixel is `x0` (heads [tiles][3]: first k-step in `frags`, first source
// pixel, k-steps), rounded, clipped and stored into output rows o0 ..
// o0 + rows - 1 of the plane at `ob` (`dst_w` bytes a row). `wt` is the
// thread of the warpgroup, `warp` its warp there, (gq, tq) its fragment
// row and k pair.
template <int CH>
__device__ __forceinline__ void w_tile(uint8_t* ob, int o0, int rows,
                                       int dst_w, const unsigned char* hrows,
                                       const int* heads, const uint4* frags,
                                       int t, int x0, int wt, int warp,
                                       int gq, int tq) {
  constexpr int kN = kRows * CH;
  const int* hd = heads + 3 * t;
  const uint4* a = frags + static_cast<long long>(__ldg(hd)) * 128;
  float d[kN / 2];
  wgmma::wpass_product<kN>(d, a, __ldg(hd + 2), hrows, __ldg(hd + 1) - x0,
                           kGroupBytes<CH>, 128, wt);
  // pixel 64 t + 16 warp + gq (+8 for e >= 2), row 8 j + 2 tq (+1 for odd
  // e); chroma's V rows are N rows kRows on
  const int ow = dst_w / CH;  // output pixels a row
  const int pa = kWTile * t + 16 * warp + gq;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int px = pa + 8 * (e >> 1), r = 8 * j + 2 * tq + (e & 1);
      if (px < ow && r < rows) {
        uint8_t* o = ob + static_cast<long long>(o0 + r) * dst_w;
        if constexpr (CH == 1) {
          o[px] = quantise(d[4 * j + e]);
        } else {
          *reinterpret_cast<unsigned short*>(o + 2 * px) =
              static_cast<unsigned short>(
                  quantise(d[4 * j + e]) |
                  quantise(d[kRows / 2 + 4 * j + e]) << 8);
        }
      }
    }
  }
}

}  // namespace passes
