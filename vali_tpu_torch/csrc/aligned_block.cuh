// The block of lab kernel `aligned` (nv12_aligned.cu) as a template over
// what it issues, shared with the resize lab's knock-outs (nv12_phases.cu)
// and its frame-skewed walk (nv12_skewed.cu): one block of (column range,
// strip of kRows output rows, frame), 256 threads, its window streamed
// through a cp.async ring, the H products into tiled bf16 H rows, the W
// tiles of its range. The host tables are lab/resize_diag.py's
// AlignedPlane. sm_90a only.
//
// MODE picks a defined function of the block (lab/resize_diag.py
// resize_phases):
//   kFull   aligned itself: ring, H products, H rows, W tiles, uint8 out.
//   kHOnly  ring, H products and H rows, no W product; every H value
//           XORed into the sink, and (luma) the range's share of output
//           pixels below Knock::lanes_out stored from the bf16 H rows,
//           truncated to int32 and cut to the low byte, the rest of its
//           tiles' pixels 0.
//   kWOnly  ring, no H product: the bytes of the window the block owns
//           (Knock's partition) XORed into the sink; H rows = the frame's
//           first Knock::rows_out buffer rows as bf16 in strip 0, zeros in
//           every other strip; then the W tiles.
//   kDma    ring alone, its owned bytes into the sink; (luma) the output
//           corner [rows_out, lanes_out] copied from the frame, the rest of
//           the tiles' pixels 0.
// The knock-outs' sink partition: a block folds the bytes of plane rows
// own_rows[strip] x row bytes own_cols[range] (each byte of the plane in
// exactly one block's share), from the ring where they lie in its window
// and by element loads where they do not.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_passes.cuh"
#include "banded_common.cuh"
#include "wgmma_common.cuh"

namespace aligned {

using passes::kGroupBytes;
using passes::kRows;
using wgmma::kStageCols;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kStages = 3;      // ring depth: two stages in flight
constexpr int kMaxKSteps = 16;  // k_pad <= 256 window rows

enum Mode : int { kFull = 0, kHOnly = 1, kWOnly = 2, kDma = 3 };

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

// What the knock-outs read besides the plane (lab/resize_diag.py
// phases_tables); unused by kFull.
struct Knock {
  unsigned* sink;
  int sink_words;
  const int2* own_rows;  // [strips] plane rows [lo, hi) the strip folds
  const int2* own_cols;  // [ranges] row bytes [lo, hi) the range folds
  const int2* h_owned;   // [ranges] luma pixels [lo, hi) kHOnly stores
  int rows_out, lanes_out;  // the corner: buffer rows, output pixels
};

// Shared memory of one block (lab/resize_diag.py aligned_smem_bytes): the
// tiled H rows of its widest range, B and the ring.
inline long long smem_bytes(int ch, int hcols, int k_pad) {
  return static_cast<long long>(hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) +
         2LL * k_pad * kRows + static_cast<long long>(kStages) * k_pad *
                                   kStageCols;
}

// A plane's tables as a launcher takes them, checked against `smem`.
inline bool plane_ok(const Plane& p, int nranges, long long smem) {
  return p.k_pad >= 16 && p.k_pad % 16 == 0 &&
         p.k_pad <= 16 * kMaxKSteps && nranges >= 1 && p.hcols >= 16 &&
         p.hcols % 16 == 0 && banded::aligned16(p.b) &&
         banded::aligned16(p.ranges) && banded::aligned16(p.frags) &&
         p.starts != nullptr && p.heads != nullptr &&
         smem <= banded::kSmemLimit;
}

// One plane's tables as the launchers take them (lab/resize_diag.py
// AlignedPlane, on the device).
struct Tables {
  const void* b;
  const int* starts;
  int k_pad;
  const int* ranges;
  int nranges;
  int hcols;
  const int* heads;
  const void* frags;
};

// Luma and the interleaved chroma rows of frame 0 of a [batch, >= src_h *
// 3 / 2, src_w] uint8 NV12 buffer as two Planes; the output planes at
// `y_out` and `c_out`, `out_bs` bytes a frame. False for odd or empty
// sizes.
inline bool nv12_planes(Plane& y, Plane& c, const void* src, long long bs,
                        long long rs, int src_h, int src_w, int dst_h,
                        int dst_w, const Tables& yt, const Tables& ct,
                        void* y_out, void* c_out, long long out_bs) {
  if (src_w <= 0 || src_h <= 0 || (src_w & 1) || (src_h & 1) ||
      (dst_w & 1) || (dst_h & 1))
    return false;
  const bool vec = banded::aligned16(src) && src_w % 16 == 0 &&
                   bs % 16 == 0 && rs % 16 == 0;
  y = Plane{static_cast<const uint8_t*>(src), bs, rs, src_h, src_w, vec,
            static_cast<uint8_t*>(y_out), out_bs, dst_h, dst_w,
            static_cast<const uint4*>(yt.b), yt.starts, yt.k_pad,
            reinterpret_cast<const int4*>(yt.ranges), yt.hcols, yt.heads,
            static_cast<const uint4*>(yt.frags)};
  c = Plane{y.src + static_cast<long long>(src_h) * rs, bs, rs, src_h / 2,
            src_w, vec, static_cast<uint8_t*>(c_out), out_bs, dst_h / 2,
            dst_w, static_cast<const uint4*>(ct.b), ct.starts, ct.k_pad,
            reinterpret_cast<const int4*>(ct.ranges), ct.hcols, ct.heads,
            static_cast<const uint4*>(ct.frags)};
  return true;
}

__device__ __forceinline__ unsigned xor_words(uint4 q) {
  return q.x ^ q.y ^ q.z ^ q.w;
}

// XOR of the bytes of a ring slot (stage columns c0 .. c0 + kStageCols - 1
// of the range) at window rows [klo, khi) and range bytes [glo, ghi), each
// shifted to its place in a 32-bit word of the frame (the range starts on
// a multiple of 16 bytes), by thread t of nt.
__device__ __forceinline__ unsigned fold_slot(const unsigned char* slot,
                                              int c0, int klo, int khi,
                                              int glo, int ghi, int t,
                                              int nt) {
  unsigned acc = 0;
  for (int i = t; i < (khi - klo) * (kStageCols / 16); i += nt) {
    const int k = klo + (i >> 3), ch = i & 7, g = c0 + 16 * ch;
    if (g + 16 <= glo || g >= ghi) continue;
    const uint4 q =
        *reinterpret_cast<const uint4*>(slot + wgmma::ring_off(k, ch));
    if (g >= glo && g + 16 <= ghi) {
      acc ^= xor_words(q);
    } else {
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (g + j >= glo && g + j < ghi)
          acc ^= ((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) << (8 * (j & 3));
    }
  }
  return acc;
}

// XOR of rows [r0, r1) x bytes [c0, c1) of a frame's plane by element
// loads, each byte shifted to its place in a 32-bit word, by thread t of nt.
__device__ __forceinline__ unsigned fold_rect(const uint8_t* plane,
                                              long long rs, int r0, int r1,
                                              int c0, int c1, int t, int nt) {
  unsigned acc = 0;
  const int w = c1 - c0;
  if (r1 <= r0 || w <= 0) return acc;
  const long long n = static_cast<long long>(r1 - r0) * w;
  for (long long e = t; e < n; e += nt) {
    const int r = r0 + static_cast<int>(e / w);
    const int c = c0 + static_cast<int>(e % w);
    acc ^= static_cast<unsigned>(__ldg(plane + r * rs + c)) << (8 * (c & 3));
  }
  return acc;
}

// The output pixels of a knock-out block that no product stores (luma):
// kDma the corner [rows_out, lanes_out] copied from the frame, kHOnly the
// pixels from lanes_out on, the rest of the range's tiles' rows 0; 16
// bytes a thread where the output rows allow it and a run lies past the
// corner.
template <int MODE>
__device__ __forceinline__ void store_rest(const Plane& p, const Knock& kn,
                                           uint8_t* ob, int4 rg, int o0,
                                           int rows) {
  const int tid = threadIdx.x;
  const int px0 = passes::kWTile * rg.x;
  const int npx = min(passes::kWTile * (rg.x + rg.y), p.dst_w) - px0;
  const int run =
      p.dst_w % 16 == 0 && p.out_bs % 16 == 0 &&
              (reinterpret_cast<uintptr_t>(p.out) & 15u) == 0
          ? 16
          : 1;
  const int nrun = npx / run;
  for (int i = tid; i < rows * nrun; i += kThreads) {
    const int r = i / nrun, px = px0 + (i - r * nrun) * run, o = o0 + r;
    uint8_t* q = ob + static_cast<long long>(o) * p.dst_w + px;
    const bool corner = (MODE == kHOnly || o < kn.rows_out) &&
                        px < kn.lanes_out;
    if (run == 16 && !corner) {
      *reinterpret_cast<uint4*>(q) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    for (int j = 0; j < run; ++j) {
      if constexpr (MODE == kDma) {
        q[j] = o < kn.rows_out && px + j < kn.lanes_out
                   ? __ldg(p.src + blockIdx.z * p.bs + o * p.rs + px + j)
                   : 0;
      } else if (px + j >= kn.lanes_out) {
        q[j] = 0;
      }
    }
  }
}

// The block at (range blockIdx.x, strip blockIdx.y, frame blockIdx.z) in
// MODE, compiled per K / 16 (NK; 0: the ring's k_pad at run time, for the
// modes without H products) and plane (CH = 1 luma, 2 chroma). KO: the
// A/B's knock-out bits of kFull (1 no W pass, 2 no H pass).
template <int NK, int CH, int MODE, int KO = 0>
__device__ __forceinline__ void block(const Plane& p, const Knock& kn) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr bool kProducts = MODE == kFull || MODE == kHOnly;
  constexpr bool kFolds = MODE == kWOnly || MODE == kDma;
  constexpr int kNK = NK > 0 ? NK : 1;
  const int kp = NK > 0 ? 16 * NK : p.k_pad;
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
      wgmma::cp_async_commit();
  }
  if constexpr (kProducts) {
    const uint4* bsrc = p.b + static_cast<long long>(strip) * kp * kRows / 8;
    for (int i = tid; i < kp * kRows / 8; i += kThreads)
      reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
    wgmma::fence_proxy_async();  // B, read by wgmma
  }

  const int wg = tid >> 7;                  // warpgroup: 64 stage columns
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * wg + 16 * warp + 2 * gq;  // the thread's 2 columns
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);

  // the knock-outs' sink share: window rows and range bytes this block owns
  unsigned acc = 0;
  int2 orow = make_int2(0, 0), ocol = make_int2(0, 0);
  if constexpr (kFolds) {
    orow = __ldg(kn.own_rows + strip);
    ocol = __ldg(kn.own_cols + blockIdx.x);
  }
  const int klo = max(orow.x - w0, 0), khi = min(orow.y - w0, kp);
  const int glo = ocol.x - xb0, ghi = min(ocol.y - xb0, end);
  uint8_t* ob = p.out + blockIdx.z * p.out_bs;
  if constexpr ((MODE == kDma || MODE == kHOnly) && CH == 1)
    store_rest<MODE>(p, kn, ob, rg, o0, rows);

  for (int s = 0; s < nstages; ++s) {
    wgmma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; slot (s - 1) % kStages is free
    if (s + kStages - 1 < nstages)
      wgmma::issue_stage<kThreads>(
          ring + (s + kStages - 1) % kStages * kp * kStageCols, base, p.rs,
          (s + kStages - 1) * kStageCols, kp, end, p.vec, row_of);
    else
      wgmma::cp_async_commit();
    if constexpr (kFolds) {
      acc ^= fold_slot(ring + s % kStages * kp * kStageCols, s * kStageCols,
                       klo, khi, glo, ghi, tid, kThreads);
    } else {
      if (KO & 2) continue;
      unsigned a[kNK][4];
      wgmma::ring_fragments<kNK>(a, ring + s % kStages * kp * kStageCols,
                                 ccol, tq);
      float d[kRows / 2];
      passes::h_product<kNK>(d, a, bdesc);
      passes::store_h<CH>(hrows, d, s * kStageCols + ccol, hbytes, end, tq);
    }
  }
  wgmma::cp_async_wait<0>();

  if constexpr (MODE == kFull) {
    wgmma::fence_proxy_async();  // the H rows, read by wgmma in the W pass
    __syncthreads();
    if (KO & 1) return;
    for (int t = rg.x + wg; t < rg.x + rg.y; t += 2)
      passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads, p.frags, t,
                         rg.z, tid & 127, warp, gq, tq);
    return;
  } else {
    if constexpr (MODE == kHOnly) {
      __syncthreads();  // the H rows
      // every H value of the range into the sink, 16 bytes (8 of a row's
      // columns) at a time
      for (int i = tid; i < rg.w / 8 * kRows * CH; i += kThreads)
        acc ^= xor_words(*reinterpret_cast<const uint4*>(
            hrows + i / (kRows * CH) * kGroup + i % (kRows * CH) * 16));
      if constexpr (CH == 1) {
        // the owned pixels below lanes_out: the notebook's
        // astype(int32).astype(uint8) of the bf16 H rows
        const int2 hown = __ldg(kn.h_owned + blockIdx.x);
        const int n = hown.y - hown.x;
        for (int i = tid; i < rows * n; i += kThreads) {
          const int r = i / n, px = hown.x + i % n;
          const float v = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(
                  hrows + wgmma::h_off(r, px - xb0, kGroup)));
          ob[static_cast<long long>(o0 + r) * p.dst_w + px] =
              static_cast<uint8_t>(static_cast<int>(v) & 0xFF);
        }
      }
    }
    if constexpr (MODE == kWOnly) {
      // H rows: strip 0's the frame's first rows_out buffer rows, else 0
      const uint8_t* frame = p.src + blockIdx.z * p.bs + xb0;
      if (strip == 0) {
        for (int i = tid; i < kRows * hbytes; i += kThreads) {
          const int r = i / hbytes, c = i - r * hbytes;
          const float x = r < kn.rows_out && c < end
                              ? static_cast<float>(__ldg(frame + r * p.rs + c))
                              : 0.0f;
          *reinterpret_cast<__nv_bfloat16*>(
              hrows + wgmma::h_off(r, c, kGroup)) = __float2bfloat16_rn(x);
        }
      } else {
        for (int i = tid; i < rg.w / 8 * kGroup / 16; i += kThreads)
          reinterpret_cast<uint4*>(hrows)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      wgmma::fence_proxy_async();
      __syncthreads();
      for (int t = rg.x + wg; t < rg.x + rg.y; t += 2)
        passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads, p.frags, t,
                           rg.z, tid & 127, warp, gq, tq);
    }
    if constexpr (kFolds) {
      // the owned bytes that lie outside the window's rows or the ring's
      // columns, by element loads
      const uint8_t* plane = p.src + blockIdx.z * p.bs;
      const int wr0 = max(orow.x, w0), wr1 = min(orow.y, w0 + kp);
      const int rc1 = min(xb0 + nstages * kStageCols, p.bytes);
      acc ^= fold_rect(plane, p.rs, orow.x, min(orow.y, w0), ocol.x, ocol.y,
                       tid, kThreads);
      acc ^= fold_rect(plane, p.rs, max(orow.x, w0 + kp), orow.y, ocol.x,
                       ocol.y, tid, kThreads);
      acc ^= fold_rect(plane, p.rs, wr0, wr1, ocol.x, min(ocol.y, xb0), tid,
                       kThreads);
      acc ^= fold_rect(plane, p.rs, wr0, wr1, max(ocol.x, rc1), ocol.y, tid,
                       kThreads);
    }
    banded::sink_xor(acc, kn.sink, kn.sink_words,
                     (static_cast<long long>(blockIdx.z) * gridDim.y +
                      blockIdx.y) * gridDim.x + blockIdx.x);
  }
}

}  // namespace aligned
