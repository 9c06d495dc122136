// The block of lab kernel S2 (nv12_static2.cu), shared with the lab's
// prod_like (nv12_prodlike.cu) and its static_kernel and transposed_chroma
// (nv12_chains.cu), and with the product's tensor-core route of
// nv12_preprocess (nv12_wgmma_preprocess.cu, T's instance at 16 rows):
// one block per (output tile of 64 columns, strip of rows, frame), 256
// threads in two warpgroups, the stacked window rows streamed through a
// cp.async ring, the transposed H product and the streamed W pass on
// wgmma, the final trade of partial sums and the product's tail.
// nv12_static2.cu describes the design; this header holds its code,
// templated over
//   N      wgmma's N of the H chains and of the luma W products (the U and
//          V rows are 2 N), a multiple of 8 up to 48;
//   STRIP  the output rows of a strip: N, or fewer (4 at N = 8: B's
//          columns STRIP .. N - 1 are zero and those rows are not stored);
//   MODE   what the block computes: kFull (S2), kHpass (the H chains
//          alone, yh + ch stored from registers) or kWpass (no H chain:
//          the W pass over the strip's frame rows as given);
//   KO     the A/B lab's knock-out bits (1 no W pass, 2 no H pass);
//   CHAIN  how the H chains' A elements are cast from the ring's bytes
//          (wgmma_common.cuh Chain: kMagic, kShort, kLong; equal values);
//   CLAYOUT where the chroma chain's sums go: kSplit, K-major U rows then
//          V rows (deinterleaved as they are stored), or kTransposed,
//          kept interleaved as the chain leaves them, the chroma W
//          operand MN-major (store_chroma_mn).
// With CHAIN and CLAYOUT at their defaults the block is S2's.
// sm_90a only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_preprocess.cuh"
#include "wgmma_common.cuh"

namespace static2 {
// Internal linkage: the product's and the labs' libraries both include
// this block, and an inline or template function of external linkage
// that kept state per kernel would be one object across both loaded
// libraries (as convert_staged.cuh says).
namespace {

using banded::csc_store;
using banded::Geometry;
using banded::Tail;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::h_off;
using wgmma::kStageCols;
using wgmma::pack_bf16;

constexpr int kThreads = 256;  // two warpgroups, one chunk of a stage each
constexpr int kStages = 3;     // ring depth: two stages in flight
constexpr int kHBatch = 4;     // H-pass k-steps a batch of products
constexpr int kWSteps = 6;     // W k-steps a chunk: 4 luma, 2 chroma

enum Mode : int { kFull = 0, kHpass = 1, kWpass = 2 };
enum CLayout : int { kSplit = 0, kTransposed = 1 };

// Bytes of one 8-column group of a warpgroup's H rows: N luma rows (U
// then V rows for chroma) of 16 bytes, and 16 of padding.
template <int N>
constexpr int kGroupY = 16 * N + 16;
template <int N>
constexpr int kGroupC = 32 * N + 16;
// A warpgroup's H rows of one chunk: 64 luma columns, 32 chroma pixels.
template <int N>
constexpr int kChunkBytes = 8 * kGroupY<N> + 4 * kGroupC<N>;
// The partial W sums the two warpgroups trade at the end (in the ring).
template <int N>
constexpr int kTradeBytes = 4 * (N / 2 + N) * 128;

// Bytes of the ring (or the traded sums, the larger) for kst window rows.
template <int N>
__host__ __device__ __forceinline__ int ring_bytes(int kst) {
  const int ring = kStages * kst * kStageCols;
  return ring > kTradeBytes<N> ? ring : kTradeBytes<N>;
}

// Shared memory of one block (bytes): the ring (or the traded sums, the
// larger), B_y and B_c (not in kWpass), and the two warpgroups' H rows of
// a chunk (not in kHpass) (ops/banded.py static2_smem_bytes,
// lab/prodlike.py prodlike_smem_bytes).
template <int N, int MODE>
long long smem_bytes(int kst) {
  return ring_bytes<N>(kst) + (MODE == kWpass ? 0LL : 2LL * kst * N) +
         (MODE == kHpass ? 0LL : 2LL * kChunkBytes<N>);
}

// The arguments of one launch of a kFull kernel on the block
// (nv12_static2.cu, nv12_chains.cu): frame 0 of the NV12 buffer and its
// strides, 16-byte loads when its start, width and strides allow, the
// grid, the tail and geometry, and S2's tables (b, starts, ky, kc, heads,
// frags).
struct Launch {
  const uint8_t* src;
  long long bs, rs;
  int vec, tiles, strips;
  Tail tl;
  Geometry g;
  const uint4* b;
  const int2* starts;
  int ky, kc;
  const int4* heads;
  const uint4* frags;
  uint8_t* out;
  cudaStream_t stream;
};

// Fill `l` from a launcher's C arguments (nv12_static2_launch's); false
// when they are refused.
inline bool setup(Launch& l, const void* src, long long batch_stride,
                  long long row_stride, int buf_rows, int batch, int src_h,
                  int src_w, int dst_h, int dst_w, const float* tail,
                  int tile, const void* b_tiles, const int* starts,
                  int k_luma, int k_chroma, const int* w_heads,
                  const void* w_frags, void* out, void* stream) {
  const int strips = tile > 0 ? (dst_h + tile - 1) / tile : 0;
  if (batch > 65535 || strips > 65535 || src_w <= 0 || (src_w & 1) ||
      src_h < 2 || buf_rows < src_h * 3 / 2 || k_luma < 16 ||
      k_luma % 16 != 0 || k_chroma < 16 || k_chroma % 16 != 0 ||
      !banded::aligned16(b_tiles) || !banded::aligned16(w_heads) ||
      !banded::aligned16(w_frags) ||
      (reinterpret_cast<uintptr_t>(starts) & 7))
    return false;
  l.src = static_cast<const uint8_t*>(src);
  l.bs = batch_stride;
  l.rs = row_stride;
  l.vec = banded::aligned16(src) && src_w % 16 == 0 &&
          batch_stride % 16 == 0 && row_stride % 16 == 0;
  l.tiles = (dst_w + 63) / 64;
  l.strips = strips;
  l.tl = banded::unpack_tail(tail);
  l.g.batch = batch;
  l.g.src_h = src_h;
  l.g.src_w = src_w;
  l.g.dst_h = dst_h;
  l.g.dst_w = dst_w;
  l.g.rows = tile;
  l.b = static_cast<const uint4*>(b_tiles);
  l.starts = reinterpret_cast<const int2*>(starts);
  l.ky = k_luma;
  l.kc = k_chroma;
  l.heads = reinterpret_cast<const int4*>(w_heads);
  l.frags = static_cast<const uint4*>(w_frags);
  l.out = static_cast<uint8_t*>(out);
  l.stream = static_cast<cudaStream_t>(stream);
  return true;
}

// Launch `kern` (a kFull kernel at wgmma's N) over `l`'s grid with its
// shared memory.
template <int N, typename K>
int launch_full(K kern, const Launch& l) {
  const long long smem = smem_bytes<N, kFull>(l.ky + l.kc);
  if (smem > banded::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = banded::allow_smem(kern, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(l.tiles, l.strips, l.g.batch), kThreads,
         static_cast<size_t>(smem), l.stream>>>(
      l.src, l.bs, l.rs, l.vec, l.tl, l.g, l.b, l.starts, l.ky, l.kc,
      l.heads, l.frags, l.out);
  return static_cast<int>(cudaGetLastError());
}

// Barrier of one warpgroup's 128 threads (ids 1 and 2; __syncthreads is
// 0): constant ids, so that ptxas reserves two barriers, not all 16.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// B k-steps k0 .. k0 + B - 1 of an H chain: d += the thread's A
// fragments of their window rows (16 a k-step from `rows` on, cast by
// CHAIN) x B's k-steps (descriptor bdesc, N * 32 bytes apart), then one
// wait.
template <int N, int B, int CHAIN>
__device__ __forceinline__ void h_batch(float (&d)[N / 2],
                                        const unsigned char* rows, int k0,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
  uint4 a[B];
#pragma unroll
  for (int i = 0; i < B; ++i)
    a[i] = wgmma::ring_step<CHAIN>(rows + (k0 + i) * 16 * kStageCols, off);
  wgmma::fence();
#pragma unroll
  for (int i = 0; i < B; ++i)
    wgmma::mma<N>(d, a[i], bdesc + (((k0 + i) * N * 32) >> 4));
  wgmma::commit();
  wgmma::wait_all();
}

// One chain of the H pass: d [64 columns, N] = the thread's A fragments
// of the nk k-steps of window rows from `rows` on (a ring slot's row 0 or
// ky) x B, in batches of kHBatch k-steps, then one batch of the rest.
// Each batch size is a loop of its own, so that no wgmma sits under a
// branch.
template <int N, int CHAIN = wgmma::kMagic>
__device__ __forceinline__ void h_chain(float (&d)[N / 2],
                                        const unsigned char* rows, int nk,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  int k0 = 0;
  for (; k0 + kHBatch <= nk; k0 += kHBatch)
    h_batch<N, kHBatch, CHAIN>(d, rows, k0, off, bdesc);
  for (; k0 < nk; ++k0) h_batch<N, 1, CHAIN>(d, rows, k0, off, bdesc);
}

// kWpass's stand-in for an H chain: d in the chain's layout from the ring
// rows themselves, d[4 j + e] and d[4 j + 2 + e] the bytes of columns
// (lcol, lcol + 1) of row 8 j + 2 tq + e from `rows` on (rows 2 tq (+1,
// +8, +9) of each 16 at `off`), each an exact float.
template <int N>
__device__ __forceinline__ void ring_rows(float (&d)[N / 2],
                                          const unsigned char* rows,
                                          const int (&off)[4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned h = *reinterpret_cast<const unsigned short*>(
          rows + (j >> 1) * 16 * kStageCols + off[2 * (j & 1) + e]);
      d[4 * j + e] = wgmma::byte_f(h, 0);
      d[4 * j + 2 + e] = wgmma::byte_f(h, 1);
    }
}

// The luma sums d of the thread's columns (lcol, lcol + 1), rounded to
// bf16 (the notebook's cast point), into the warpgroup's H rows.
template <int N>
__device__ __forceinline__ void store_luma(unsigned char* hy,
                                           const float (&d)[N / 2], int lcol,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<unsigned*>(
          hy + h_off(8 * j + 2 * tq + e, lcol, kGroupY<N>)) =
          pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
}

// The chroma sums d of the thread's interleaved columns (lcol: U, lcol +
// 1: V of pixel lcol / 2), rounded to bf16, deinterleaved into the U rows
// and the V rows (N rows on) of the warpgroup's H rows.
template <int N>
__device__ __forceinline__ void store_chroma(unsigned char* hc,
                                             const float (&d)[N / 2],
                                             int lcol, int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * tq + e;
      *reinterpret_cast<__nv_bfloat16*>(hc + h_off(r, lcol / 2, kGroupC<N>)) =
          __float2bfloat16_rn(d[4 * j + e]);
      *reinterpret_cast<__nv_bfloat16*>(
          hc + h_off(N + r, lcol / 2, kGroupC<N>)) =
          __float2bfloat16_rn(d[4 * j + 2 + e]);
    }
}

// kTransposed's store of the chroma sums d, kept interleaved: the chroma
// W operand [K: the chunk's 32 pixels, n: 2 N] MN-major, each group of 8
// pixels kGroupC<N> bytes, in it N / 4 core matrices of 128 bytes along
// n (n = 16 j + e: U of row 8 j + e, then n = 16 j + 8 + e: V of it), a
// pixel's 8 n of a core matrix 16 bytes at 16 (pixel mod 8). The thread's
// U of rows 8 j + 2 tq (+1) of pixel lcol / 2 is one 4-byte word, its V
// the word 128 bytes on; a warp's U words of one j fill one core matrix
// (32 banks).
template <int N>
__device__ __forceinline__ void store_chroma_mn(unsigned char* hc,
                                                const float (&d)[N / 2],
                                                int lcol, int tq) {
  const int c = lcol / 2;
  unsigned char* p = hc + (c >> 3) * kGroupC<N> + (c & 7) * 16 + 4 * tq;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<unsigned*>(p + 256 * j) = pack_bf16(d[4 * j],
                                                          d[4 * j + 1]);
    *reinterpret_cast<unsigned*>(p + 256 * j + 128) =
        pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// kHpass's store: for row r < rows and frame column p = p0 (+1) in the
// block's own columns [own.x, own.y), clip(round(bf16(yh) + bf16(ch)))
// into all three planes; ch is the interleaved chroma sum of the same
// byte column.
template <int N>
__device__ __forceinline__ void hpass_store(uint8_t* ob, long long plane_sz,
                                            int dst_w, int o0, int rows,
                                            int p0, int2 own,
                                            const float (&dy)[N / 2],
                                            const float (&dc)[N / 2],
                                            int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * j + 2 * tq + e, p = p0 + c;
        if (r < rows && p >= own.x && p < own.y) {
          const int i = 4 * j + 2 * c + e;
          const float y = __bfloat162float(__float2bfloat16_rn(dy[i]));
          const float u = __bfloat162float(__float2bfloat16_rn(dc[i]));
          const uint8_t q = static_cast<uint8_t>(
              fminf(fmaxf(rintf(__fadd_rn(y, u)), 0.0f), 255.0f));
          const long long pix = static_cast<long long>(o0 + r) * dst_w + p;
#pragma unroll
          for (int k = 0; k < 3; ++k) ob[k * plane_sz + pix] = q;
        }
      }
}

// The block. Launched as a grid (ceil(dst_w / 64) tiles, ceil(dst_h /
// STRIP) strips, frames) of kThreads threads with smem_bytes<N, MODE>(ky +
// kc) bytes of dynamic shared memory. kFull and kHpass read the strip's
// windows (ky luma rows from starts[strip].x, kc interleaved chroma rows
// from starts[strip].y) against B (b_tiles: [strips, (ky + kc) N] bf16 in
// core-matrix order); kWpass reads instead, with ky = kc = N, the strip's
// rows o0 .. and buf_rows - dst_h + o0 .. of the buffer as given. kHpass
// stores the frame columns owned[tile] holds; the others ignore owned.
template <int N, int STRIP, int MODE, int KO, int CHAIN = wgmma::kMagic,
          int CLAYOUT = kSplit>
__device__ __forceinline__ void block(
    const uint8_t* __restrict__ src, long long bs, long long rs, int vec,
    Tail tl, Geometry g, const uint4* __restrict__ b_tiles,
    const int2* __restrict__ starts, int ky, int kc,
    const int4* __restrict__ heads, const uint4* __restrict__ frags,
    const int2* __restrict__ owned, int buf_rows, uint8_t* __restrict__ out) {
  static_assert(N % 8 == 0 && STRIP <= N, "N: wgmma's, over the strip");
  static_assert(MODE != kWpass || N % 16 == 0,
                "kWpass's chroma rows start on a 16-row k-step");
  static_assert(CLAYOUT == kSplit || MODE == kFull,
                "the transposed chroma layout is kFull's");
  // the H chains and the W products this block issues
  constexpr bool kH = MODE != kWpass && !(KO & 2);
  constexpr bool kW = MODE != kHpass && !(KO & 1);
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGy = kGroupY<N>, kGc = kGroupC<N>;
  const int kst = ky + kc;  // stacked window rows: luma, then chroma
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  unsigned char* ring = smem;  // kStages x [kst, 128] bytes
  unsigned char* bw = smem + ring_bytes<N>(kst);  // B_y [ky, N], B_c
  unsigned char* hy =
      bw + (MODE == kWpass ? 0 : 2 * kst * N) + wg * kChunkBytes<N>;
  unsigned char* hc = hy + 8 * kGy;  // U rows, then V rows
  const int tile = blockIdx.x, strip = blockIdx.y;
  const int4 hd = __ldg(heads + tile);  // first chunk, x0, chunks
  const int nstages = hd.z / 2;
  const int o0 = strip * STRIP;
  const int rows = min(STRIP, g.dst_h - o0);
  const uint8_t* base = src + blockIdx.z * bs + hd.y;
  const int end = g.src_w - hd.y;  // bytes of a row from x0
  const int2 st = MODE == kWpass ? make_int2(0, 0) : __ldg(starts + strip);
  const int h = g.src_h;
  const auto row_of = [=](int k) {
    if constexpr (MODE == kWpass)
      return min(k < ky ? o0 + k : buf_rows - g.dst_h + o0 + k - ky,
                 buf_rows - 1);
    else
      return k < ky ? min(st.x + k, h - 1)
                    : h + min(st.y + k - ky, h / 2 - 1);
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages)
      wgmma::issue_stage<kThreads>(ring + s * kst * kStageCols, base, rs,
                                   s * kStageCols, kst, end, vec, row_of);
    else
      cp_async_commit();
  }
  if constexpr (MODE != kWpass) {
    const uint4* bsrc =
        b_tiles + static_cast<long long>(strip) * kst * N / 8;
    for (int i = tid; i < kst * N / 8; i += kThreads)
      reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
    fence_proxy_async();  // B, read by wgmma
  }

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int lcol = 16 * warp + 2 * gq;      // the thread's 2 chunk bytes
  const uint64_t bdesc_y = desc(bw, 128, 256);
  const uint64_t bdesc_c = desc(bw + 2 * ky * N, 128, 256);
  int off[4];  // the thread's A rows within a k-step of its chunk
  wgmma::step_offsets(off, 64 * wg + lcol, tq);
  const uint4* wf = frags + static_cast<long long>(hd.x) * kWSteps * 128 +
                    wt;
  const int2 own = MODE == kHpass ? __ldg(owned + tile) : make_int2(0, 0);
  float dy[N / 2], duv[N];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dy[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) duv[i] = 0.0f;

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; slot (s - 1) % kStages is free
    if (s + kStages - 1 < nstages)
      wgmma::issue_stage<kThreads>(
          ring + (s + kStages - 1) % kStages * kst * kStageCols, base, rs,
          (s + kStages - 1) * kStageCols, kst, end, vec, row_of);
    else
      cp_async_commit();
    uint4 wa[kWSteps];  // the chunk's W weights, loaded under the H pass
    if constexpr (kW) {
      const uint4* f =
          wf + static_cast<long long>(2 * s + wg) * kWSteps * 128;
#pragma unroll
      for (int i = 0; i < kWSteps; ++i) wa[i] = __ldg(f + i * 128);
    }
    const unsigned char* slot = ring + s % kStages * kst * kStageCols;
    if constexpr (MODE == kHpass) {
      float d[N / 2], e[N / 2];
      h_chain<N, CHAIN>(d, slot, ky / 16, off, bdesc_y);
      h_chain<N, CHAIN>(e, slot + ky * kStageCols, kc / 16, off, bdesc_c);
      const long long plane_sz = static_cast<long long>(g.dst_h) * g.dst_w;
      hpass_store<N>(out + static_cast<long long>(blockIdx.z) * 3 * plane_sz,
                     plane_sz, g.dst_w, o0, rows,
                     hd.y + s * kStageCols + 64 * wg + lcol, own, d, e, tq);
    } else if constexpr (MODE == kWpass || kH) {
      float d[N / 2];
      // d[4 j + e], d[4 j + 2 + e]: row 8 j + 2 tq + e of byte columns
      // lcol and lcol + 1 (luma: two pixels; chroma: U and V of one)
      if constexpr (MODE == kWpass)
        ring_rows<N>(d, slot, off);
      else
        h_chain<N, CHAIN>(d, slot, ky / 16, off, bdesc_y);
      store_luma<N>(hy, d, lcol, tq);
      if constexpr (MODE == kWpass)
        ring_rows<N>(d, slot + ky * kStageCols, off);
      else
        h_chain<N, CHAIN>(d, slot + ky * kStageCols, kc / 16, off, bdesc_c);
      if constexpr (CLAYOUT == kTransposed)
        store_chroma_mn<N>(hc, d, lcol, tq);
      else
        store_chroma<N>(hc, d, lcol, tq);
      fence_proxy_async();  // the H rows, read by wgmma below
      warpgroup_sync(wg);
    }
    if constexpr (kW) {
      wgmma::fence();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wgmma::mma<N>(dy, wa[i], desc(hy + 2 * i * kGy, kGy, 128));
      // one descriptor for both layouts: K groups kGc bytes apart, N
      // groups 128 (kTransposed: MN-major, imm-trans-b 1)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wgmma::mma<2 * N, CLAYOUT == kTransposed>(
            duv, wa[4 + i], desc(hc + 2 * i * kGc, kGc, 128));
      wgmma::commit();
      // before the next chunk's weights overwrite wa: a wgmma reads its A
      // registers until its group completes
      wgmma::wait_all();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring's bytes are free
  if constexpr (!kW) return;

  // Warpgroup w finishes the pixels of accumulators e with e / 2 == w
  // (tile columns 16 warp + gq + 8 w); it hands the other its sums of
  // the rest, in the fragment layout both share.
  float* trade = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    if (((i & 3) >> 1) != wg) trade[i * 128 + wt] = dy[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (((i & 3) >> 1) != wg) trade[(N / 2 + i) * 128 + wt] = duv[i];
  __syncthreads();
  uint8_t* ob = out + static_cast<long long>(blockIdx.z) * 3 * g.dst_h *
                          g.dst_w;
  const long long plane_sz = static_cast<long long>(g.dst_h) * g.dst_w;
  // pixel of accumulator 4 j + e: tile column 16 warp + gq + 8 (e / 2),
  // row 8 j + 2 tq + e mod 2; kSplit: U from duv[4 j + e], V from duv[4
  // (j + N / 8) + e] (the V rows are N rows N on); kTransposed: U from
  // duv[8 j + e], V from duv[8 j + 4 + e] (n = 16 j (+8) + 2 tq + e mod 2)
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * tq + (e & 1);
      const int p = 64 * tile + 16 * warp + gq + 8 * (e >> 1);
      if ((e >> 1) == wg && r < rows && p < g.dst_w) {
        constexpr bool kT = CLAYOUT == kTransposed;
        const int iy = 4 * j + e, iu = kT ? 8 * j + e : iy,
                  iv = kT ? 8 * j + 4 + e : 4 * (j + N / 8) + e;
        csc_store(ob, plane_sz, static_cast<long long>(o0 + r) * g.dst_w + p,
                  dy[iy] + trade[iy * 128 + wt],
                  duv[iu] + trade[(N / 2 + iu) * 128 + wt],
                  duv[iv] + trade[(N / 2 + iv) * 128 + wt], tl);
      }
    }
  }
}

}  // namespace
}  // namespace static2
