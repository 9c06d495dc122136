// Lab kernel S2 of the NV12 preprocess lab for Hopper (sm_90a): the
// preprocess on tall strips over aligned windows, both resize passes on
// the tensor cores with the strip height as wgmma's N, fed by a cp.async
// ring.
//
// Replaces static_kernel2 of bench_kernel_variants.py: on the TPU each
// strip of `tile` output rows multiplies [tile, win] weight blocks with a
// window of frame rows that starts on a multiple of `align` rows and has
// the plane's common length (every row of the strip runs over the whole
// window, zero taps included), then a dense W product. Its sweep asks
// what the strip height and the alignment cost the matrix unit; here the
// strip height T is N of both products, so the sweep also asks whether
// the tensor-core W pass pays per wgmma or per output tile.
//
// What bounds it on this card: the bytes (199 MB in, 9.6 MB out per
// 64 x 1080p -> 224 batch: 0.062 ms at 3.35 TB/s). The products it issues,
// zeros included, take 0.02-0.04 ms at 989 TFLOP/s bf16
// (lab/kernel_variants.py static2_work).
//
// Design. One block per (output tile of 64 columns, strip of T rows,
// frame), 256 threads: two warpgroups. The host builds once per geometry
// (ops/banded.py static2_tables, static2_w_tables):
//   - per strip, its luma window of ky rows and its chroma window of kc
//     interleaved chroma rows (the notebook's windows, each widened with
//     zero rows to a multiple of 16; rows past a plane read its last row
//     and weigh 0), and B_y = [ky, T], B_c = [kc, T] bf16 of the strip's
//     weights in wgmma's K-major core matrices;
//   - per tile, its first byte column x0 (a multiple of 32) and an even
//     number of chunks of 64 frame bytes that cover the luma and chroma
//     bands of its columns, and per chunk the tile's bf16 W weights in
//     register-fragment order: 4 luma k-steps (its 64 luma columns) and 2
//     chroma k-steps (its 32 chroma pixels), zeros outside the bands.
// The block streams its tile's bytes of both windows, stacked (ky + kc
// rows), through a ring of kStages stages of 128 columns by 16-byte
// cp.async copies issued two stages ahead (element loads where the rows
// are not 16-byte aligned); each warpgroup takes one chunk of a stage.
//   - H pass, the transposed product, two chains a chunk: D [64 columns,
//     T] = A [64, ky] x B_y and D [64 interleaved columns, T] = A [64, kc]
//     x B_c, wgmma m64nTk16 bf16 -> fp32, A built in registers from the
//     raw bytes (wgmma_common.cuh ring_step), kHBatch k-steps a batch and
//     one wait a batch, the rest one k-step a batch (no zero k-steps
//     issued). The sums round to bf16 (the notebook's cast point) into
//     the warpgroup's H rows of the chunk: T luma rows of 64 columns, T U
//     rows and T V rows of 32 pixels (the chroma sums deinterleaved as
//     they are stored), as 8 x 8 core matrices.
//   - W pass, streamed: right after a chunk's H rows, D_y [64 output
//     columns, T] += A (the chunk's 4 luma k-steps) x the luma H rows
//     (m64nTk16) and D_uv [64, 2T] += A (its 2 chroma k-steps) x the U
//     and V rows (m64n(2T)k16: one A of chroma weights serves both). The
//     accumulators stay in registers over the stages, so the H rows of a
//     whole band are never kept: a chunk's rows take 2.2-12.5 KB a
//     warpgroup, and the W pass runs while the ring's next stages are in
//     flight. The chunk's W weights are loaded before its H chains.
// Each warpgroup sums its own chunks; at the end each hands the other,
// through shared memory, the partial sums of the pixels the other
// finishes, adds the other's to its own, and runs the product's CSC,
// round and clip (banded_preprocess.cuh csc_store) on half the tile.
// The kernel is compiled per T (8 to 48 in steps of 8); the k-step counts
// are run-time loops, so that no wgmma sits under a branch (ptxas
// serializes wgmmas whose A registers are written under one).
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order, and the two warpgroups' W sums
// meet at the end, so a sum may round apart from nv12_preprocess's FMA
// chain. The lab holds S2 to the kernels' uint8 envelope and counts its
// differing samples.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "banded_preprocess.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/static2_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass's conversion and products
// (3: the staging ring alone).
#ifndef NV12_STATIC2_KNOCKOUT
#define NV12_STATIC2_KNOCKOUT 0
#endif

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::csc_store;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tail;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::h_off;
using wgmma::kStageCols;
using wgmma::pack_bf16;

constexpr int kKnockout = NV12_STATIC2_KNOCKOUT;
constexpr int kThreads = 256;  // two warpgroups, one chunk of a stage each
constexpr int kStages = 3;     // ring depth: two stages in flight
constexpr int kHBatch = 4;     // H-pass k-steps a batch of products
constexpr int kWSteps = 6;     // W k-steps a chunk: 4 luma, 2 chroma

// Bytes of one 8-column group of a warpgroup's H rows: T luma rows (U
// then V rows for chroma) of 16 bytes, and 16 of padding.
template <int T>
constexpr int kGroupY = 16 * T + 16;
template <int T>
constexpr int kGroupC = 32 * T + 16;
// A warpgroup's H rows of one chunk: 64 luma columns, 32 chroma pixels.
template <int T>
constexpr int kChunkBytes = 8 * kGroupY<T> + 4 * kGroupC<T>;
// The partial W sums the two warpgroups trade at the end (in the ring).
template <int T>
constexpr int kTradeBytes = 4 * (T / 2 + T) * 128;

// Bytes of the ring (or the traded sums, the larger) for kst window rows.
template <int T>
__host__ __device__ __forceinline__ int ring_bytes(int kst) {
  const int ring = kStages * kst * kStageCols;
  return ring > kTradeBytes<T> ? ring : kTradeBytes<T>;
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
// fragments of their window rows (16 a k-step from `rows` on) x B's
// k-steps (descriptor bdesc, T * 32 bytes apart), then one wait.
template <int T, int B>
__device__ __forceinline__ void h_batch(float (&d)[T / 2],
                                        const unsigned char* rows, int k0,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
  uint4 a[B];
#pragma unroll
  for (int i = 0; i < B; ++i)
    a[i] = wgmma::ring_step(rows + (k0 + i) * 16 * kStageCols, off);
  wgmma::fence();
#pragma unroll
  for (int i = 0; i < B; ++i)
    wgmma::mma<T>(d, a[i], bdesc + (((k0 + i) * T * 32) >> 4));
  wgmma::commit();
  wgmma::wait_all();
}

// One chain of the H pass: d [64 columns, T] = the thread's A fragments
// of the nk k-steps of window rows from `rows` on (a ring slot's row 0 or
// ky) x B, in batches of kHBatch k-steps, then one batch of the rest.
// Each batch size is a loop of its own, so that no wgmma sits under a
// branch.
template <int T>
__device__ __forceinline__ void h_chain(float (&d)[T / 2],
                                        const unsigned char* rows, int nk,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
#pragma unroll
  for (int i = 0; i < T / 2; ++i) d[i] = 0.0f;
  int k0 = 0;
  for (; k0 + kHBatch <= nk; k0 += kHBatch)
    h_batch<T, kHBatch>(d, rows, k0, off, bdesc);
  for (; k0 < nk; ++k0) h_batch<T, 1>(d, rows, k0, off, bdesc);
}

template <int T>
__global__ void __launch_bounds__(kThreads, T <= 16 ? 2 : 1)
nv12_static2_kernel(const uint8_t* __restrict__ src, long long bs,
                    long long rs, int vec, Tail tl, Geometry g,
                    const uint4* __restrict__ b_tiles,
                    const int2* __restrict__ starts, int ky, int kc,
                    const int4* __restrict__ heads,
                    const uint4* __restrict__ frags,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGy = kGroupY<T>, kGc = kGroupC<T>;
  const int kst = ky + kc;  // stacked window rows: luma, then chroma
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  unsigned char* ring = smem;  // kStages x [kst, 128] bytes
  unsigned char* bw = smem + ring_bytes<T>(kst);  // B_y [ky, T], B_c
  unsigned char* hy = bw + 2 * kst * T + wg * kChunkBytes<T>;
  unsigned char* hc = hy + 8 * kGy;  // U rows, then V rows
  const int tile = blockIdx.x, strip = blockIdx.y;
  const int4 hd = __ldg(heads + tile);  // first chunk, x0, chunks
  const int nstages = hd.z / 2;
  const int o0 = strip * T;
  const int rows = min(T, g.dst_h - o0);
  const uint8_t* base = src + blockIdx.z * bs + hd.y;
  const int end = g.src_w - hd.y;  // bytes of a row from x0
  const int2 st = __ldg(starts + strip);
  const int h = g.src_h;
  const auto row_of = [=](int k) {
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
  const uint4* bsrc = b_tiles + static_cast<long long>(strip) * kst * T / 8;
  for (int i = tid; i < kst * T / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  fence_proxy_async();  // B, read by wgmma

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int lcol = 16 * warp + 2 * gq;      // the thread's 2 chunk bytes
  const uint64_t bdesc_y = desc(bw, 128, 256);
  const uint64_t bdesc_c = desc(bw + 2 * ky * T, 128, 256);
  int off[4];  // the thread's A rows within a k-step of its chunk
  wgmma::step_offsets(off, 64 * wg + lcol, tq);
  const uint4* wf = frags + static_cast<long long>(hd.x) * kWSteps * 128 +
                    wt;
  float dy[T / 2], duv[T];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) dy[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < T; ++i) duv[i] = 0.0f;

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
    if constexpr (!(kKnockout & 1)) {
      const uint4* f =
          wf + static_cast<long long>(2 * s + wg) * kWSteps * 128;
#pragma unroll
      for (int i = 0; i < kWSteps; ++i) wa[i] = __ldg(f + i * 128);
    }
    if constexpr (!(kKnockout & 2)) {
      const unsigned char* slot = ring + s % kStages * kst * kStageCols;
      float d[T / 2];
      // d[4 j + e], d[4 j + 2 + e]: row 8 j + 2 tq + e of byte columns
      // lcol and lcol + 1 (luma: two pixels; chroma: U and V of one)
      h_chain<T>(d, slot, ky / 16, off, bdesc_y);
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<unsigned*>(hy + h_off(8 * j + 2 * tq + e, lcol,
                                                  kGy)) =
              pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
      h_chain<T>(d, slot + ky * kStageCols, kc / 16, off, bdesc_c);
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * tq + e;
          *reinterpret_cast<__nv_bfloat16*>(hc + h_off(r, lcol / 2, kGc)) =
              __float2bfloat16_rn(d[4 * j + e]);
          *reinterpret_cast<__nv_bfloat16*>(
              hc + h_off(T + r, lcol / 2, kGc)) =
              __float2bfloat16_rn(d[4 * j + 2 + e]);
        }
      fence_proxy_async();  // the H rows, read by wgmma below
      warpgroup_sync(wg);
    }
    if constexpr (!(kKnockout & 1)) {
      wgmma::fence();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wgmma::mma<T>(dy, wa[i], desc(hy + 2 * i * kGy, kGy, 128));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wgmma::mma<2 * T>(duv, wa[4 + i], desc(hc + 2 * i * kGc, kGc, 128));
      wgmma::commit();
      // before the next chunk's weights overwrite wa: a wgmma reads its A
      // registers until its group completes
      wgmma::wait_all();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring's bytes are free
  if constexpr (kKnockout & 1) return;

  // Warpgroup w finishes the pixels of accumulators e with e / 2 == w
  // (tile columns 16 warp + gq + 8 w); it hands the other its sums of
  // the rest, in the fragment layout both share.
  float* trade = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < T / 2; ++i)
    if (((i & 3) >> 1) != wg) trade[i * 128 + wt] = dy[i];
#pragma unroll
  for (int i = 0; i < T; ++i)
    if (((i & 3) >> 1) != wg) trade[(T / 2 + i) * 128 + wt] = duv[i];
  __syncthreads();
  uint8_t* ob = out + static_cast<long long>(blockIdx.z) * 3 * g.dst_h *
                          g.dst_w;
  const long long plane_sz = static_cast<long long>(g.dst_h) * g.dst_w;
  // pixel of accumulator 4 j + e: tile column 16 warp + gq + 8 (e / 2),
  // row 8 j + 2 tq + e mod 2; U from duv[4 j + e], V from duv[4 (j +
  // T / 8) + e] (the V rows are N rows T on)
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * tq + (e & 1);
      const int p = 64 * tile + 16 * warp + gq + 8 * (e >> 1);
      if ((e >> 1) == wg && r < rows && p < g.dst_w) {
        const int iy = 4 * j + e, iv = 4 * (j + T / 8) + e;
        csc_store(ob, plane_sz, static_cast<long long>(o0 + r) * g.dst_w + p,
                  dy[iy] + trade[iy * 128 + wt],
                  duv[iy] + trade[(T / 2 + iy) * 128 + wt],
                  duv[iv] + trade[(T / 2 + iv) * 128 + wt], tl);
      }
    }
  }
}

// Shared memory of one block (bytes): the ring (or the traded sums, the
// larger), B_y and B_c, and the two warpgroups' H rows of a chunk
// (ops/banded.py static2_smem_bytes).
template <int T>
long long smem_bytes(int kst) {
  return ring_bytes<T>(kst) + 2LL * kst * T + 2LL * kChunkBytes<T>;
}

template <int T>
cudaError_t launch_t(int tiles, int strips, int batch, cudaStream_t stream,
                     const uint8_t* src, long long bs, long long rs, int vec,
                     const Tail& tl, const Geometry& g, const uint4* b,
                     const int2* starts, int ky, int kc, const int4* heads,
                     const uint4* frags, uint8_t* out) {
  const long long smem = smem_bytes<T>(ky + kc);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem(nv12_static2_kernel<T>, static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  nv12_static2_kernel<T>
      <<<dim3(tiles, strips, batch), kThreads, static_cast<size_t>(smem),
         stream>>>(src, bs, rs, vec, tl, g, b, starts, ky, kc, heads, frags,
                   out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// S2 over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12 buffer
// with the given batch and row strides (bytes), on strips of `tile` output
// rows (8 to 48, a multiple of 8). tail: the 18 floats of ops/banded.py
// tail_params. b_tiles: [strips, (k_luma + k_chroma) * tile] bf16 on the
// device, per strip B_y then B_c in wgmma core-matrix order, strips =
// ceil(dst_h / tile); starts: [strips, 2] int32 on the device, the first
// row of each strip's luma window (k_luma rows) and chroma window (k_chroma
// interleaved chroma rows), both multiples of 16. w_heads: [ceil(dst_w /
// 64), 4] int32 on the device, per tile its first chunk, first byte column
// (a multiple of 32), chunks (even) and 0; w_frags: [chunks, 6, 128]
// 16-byte words on the device, the W weights (ops/banded.py
// static2_w_tables). out is a contiguous [batch, 3, dst_h, dst_w] uint8
// tensor.
int nv12_static2_launch(const void* src, long long batch_stride,
                        long long row_stride, int buf_rows, int batch,
                        int src_h, int src_w, int dst_h, int dst_w,
                        const float* tail, int tile, const void* b_tiles,
                        const int* starts, int k_luma, int k_chroma,
                        const int* w_heads, const void* w_frags, void* out,
                        void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const int strips = tile > 0 ? (dst_h + tile - 1) / tile : 0;
  if (batch > 65535 || strips > 65535 || src_w <= 0 || (src_w & 1) ||
      src_h < 2 || buf_rows < src_h * 3 / 2 || k_luma < 16 ||
      k_luma % 16 != 0 || k_chroma < 16 || k_chroma % 16 != 0 ||
      !aligned16(b_tiles) || !aligned16(w_heads) || !aligned16(w_frags) ||
      (reinterpret_cast<uintptr_t>(starts) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = tile;
  const Tail tl = banded::unpack_tail(tail);
  const int vec = aligned16(src) && src_w % 16 == 0 &&
                  batch_stride % 16 == 0 && row_stride % 16 == 0;
  const int tiles = (dst_w + 63) / 64;
  auto go = [&](auto t) {
    return static_cast<int>(launch_t<decltype(t)::value>(
        tiles, strips, batch, static_cast<cudaStream_t>(stream),
        static_cast<const uint8_t*>(src), batch_stride, row_stride, vec, tl,
        g, static_cast<const uint4*>(b_tiles),
        reinterpret_cast<const int2*>(starts), k_luma, k_chroma,
        reinterpret_cast<const int4*>(w_heads),
        static_cast<const uint4*>(w_frags), static_cast<uint8_t*>(out)));
  };
  switch (tile) {
#define NV12_STATIC2_TILE(t) \
  case t:                    \
    return go(std::integral_constant<int, t>());
    NV12_STATIC2_TILE(8) NV12_STATIC2_TILE(16) NV12_STATIC2_TILE(24)
    NV12_STATIC2_TILE(32) NV12_STATIC2_TILE(40) NV12_STATIC2_TILE(48)
#undef NV12_STATIC2_TILE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
