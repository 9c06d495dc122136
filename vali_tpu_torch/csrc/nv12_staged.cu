// Lab kernel `staged` of the NV12 preprocess lab for Hopper (sm_90a): the
// preprocess whose H pass reads its frame window as a bf16 operand that
// the block converted once into shared memory, both resize passes on the
// tensor cores.
//
// Replaces variant_kernel of bench_kernel_variants.py (variants B, C, D):
// on the TPU each of them converts the whole frame to bf16 once into VMEM
// scratch (B by u8 -> i32 -> f32 -> bf16, C and D by u8 -> i32 -> bf16:
// equal values), then runs the banded H products from that copy; B and C
// run the chroma W pass over the interleaved H rows with interleaved
// weights, D over the deinterleaved U and V rows. Its question: what does
// converting once cost, and which cast chain is cheaper? Here the same
// experiment meets the tensor cores' operand: the window is converted once
// a stage into the layout wgmma reads A from shared memory, so no A
// fragment is built in registers (every other tensor-core lab kernel of
// this directory builds A from raw bytes at every k-step).
//
// What bounds it on this card: the bytes (199 MB in, 9.6 MB out per
// 64 x 1080p -> 224 batch: 0.062 ms at 3.35 TB/s). The products it issues,
// zeros included, take ~0.02 ms at 989 TFLOP/s bf16
// (lab/kernel_variants.py staged_work).
//
// Design. S2's block (nv12_static2.cu) at strips of T output rows over
// windows aligned to 8 rows, and its host tables (ops/banded.py
// static2_tables: per strip the luma window of ky rows and the chroma
// window of kc interleaved chroma rows, B_y [ky, T] and B_c [kc, T] in
// K-major core matrices; static2_w_tables: per 64-column output tile its
// first byte column x0 and its chunks of 64 frame bytes). One block per
// (output tile, strip, frame), 256 threads: two warpgroups, one chunk of
// a stage each.
//   - Staging: each stage (128 frame bytes of the ky + kc stacked window
//     rows) lands raw in a uint8 ring of kSlots slots by TMA boxes of
//     [16 rows, 128 bytes] without swizzle (row k at k * 128), counted
//     against one mbarrier a slot; TMA zero-fills rows past the NV12 rows
//     and bytes past a row (they weigh 0). Views TMA cannot take fill the
//     same ring with element loads, every thread arriving on the barrier.
//     The next stage lands while the block converts and multiplies this
//     one; a slot is refilled once every thread has converted from it.
//   - Convert once: each warpgroup widens its 64 columns of the landed
//     stage to bf16, once per sample (B: the f32 hop, 2^23 + x less 2^23
//     then cvt.rn.bf16x2.f32; C and D: u8 -> i32 -> bf16 by
//     __int2bfloat16_rn), into its own operand buffer laid out as wgmma
//     reads an MN-major A (imm-trans-a 1) without swizzle: core matrices
//     of 8 window rows (K) of 8 columns (M), 16 bytes a row, K blocks
//     kLbo = 128 bytes apart, M blocks `pitch` = 16 (ky + kc) + 16 bytes
//     apart (the 16 spare bytes put a quarter warp's stores in distinct
//     banks). M is S2's order of the chunk's columns: M rows 16 w .. 16 w
//     + 7 the even columns of 16 w .. 16 w + 15, the next 8 the odd ones,
//     so that every thread's accumulators hold two adjacent columns, as
//     S2's register A gives them. Then fence.proxy.async and a barrier.
//   - H pass: D [64 columns, T] = A (the operand's luma rows, then its
//     chroma rows; descriptor) x B_y (B_c), wgmma m64nTk16 bf16 -> fp32
//     with both operands in shared memory, kHBatch k-steps a batch, then
//     2, then 1 (run-time loops: no wgmma sits under a branch). The sums
//     round to bf16 into the warpgroup's H rows of the chunk: T luma rows
//     of 64 columns and, for D, T U and T V rows of 32 pixels (S2's
//     deinterleaved store), for B and C T interleaved chroma rows of 64
//     columns (the luma store).
//   - W pass, streamed as S2's: D_y [64 output columns, T] += A (4 luma
//     k-steps from registers) x the luma H rows; D keeps S2's chroma
//     product, D_uv [64, 2T] += A (2 chroma k-steps) x the U and V rows;
//     B and C multiply the interleaved H rows twice, D_u [64, T] += A_u (4
//     k-steps of U weights, zero at the V columns) x H_c and D_v the same
//     with the V weights (lab/staged.py interleaved_w_tables): twice D's
//     chroma W work, as the TPU's B and C do it.
//   - Tail: S2's. The warpgroups trade partial sums through the ring and
//     each runs csc_store on half the tile.
// Shared memory at 1080p -> 224, T = 16: two landing slots 45,056 B, two
// operand buffers 45,312 B, B 5,632 B, H rows 8,576 (D) or 8,704 (B, C) B:
// 102 KB, two blocks an SM. D at T = 32 takes 188 KB, one block an SM.
// Instances: (T, variant) = (16, B), (16, C), (16, D), (32, D).
//
// Bits: every bf16 x uint8 product is exact in fp32; B and C give equal
// operands, so equal bits; D issues S2's products in S2's order. The lab
// holds them to the kernels' uint8 envelope of nv12_preprocess and counts
// their differing samples.
//
// The launcher encodes the frames' tensor map on the host, returns
// cudaGetLastError() after the launch, runs on the caller's stream, and
// neither synchronises nor allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "banded_preprocess.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/staged_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass (its conversion and products),
// bit 4 the conversion alone (the products read whatever the operand
// buffer holds); 3 is the staging alone.
#ifndef NV12_STAGED_KNOCKOUT
#define NV12_STAGED_KNOCKOUT 0
#endif

namespace {

using banded::allow_smem;
using banded::csc_store;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tail;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::h_off;
using wgmma::kStageCols;
using wgmma::pack_bf16;

constexpr int kKnockout = NV12_STAGED_KNOCKOUT;
constexpr int kThreads = 256;  // two warpgroups, one chunk of a stage each
constexpr int kSlots = 2;      // landing ring: one stage lands, one converts
constexpr int kHBatch = 4;     // H-pass k-steps a batch of products
constexpr int kLbo = 128;      // the operand's K blocks (8 rows of 16 B)
constexpr int kBox = 16;       // window rows of a TMA box

enum Variant : int { kB = 0, kC = 1, kD = 2 };

// Bytes of one 8-column group of a warpgroup's H rows: T rows (D's
// chroma: U then V rows) of 16 bytes, and 16 of padding.
template <int T>
constexpr int kGroupY = 16 * T + 16;
template <int T>
constexpr int kGroupC = 32 * T + 16;
// A warpgroup's H rows of one chunk: 64 luma columns, and 32 chroma
// pixels deinterleaved (D) or 64 interleaved chroma columns (B, C).
template <int T, int V>
constexpr int kChunkBytes =
    8 * kGroupY<T> + (V == kD ? 4 * kGroupC<T> : 8 * kGroupY<T>);
// W k-steps a chunk: 4 luma, then 2 chroma (D) or 4 U and 4 V (B, C).
template <int V>
constexpr int kWSteps = V == kD ? 6 : 12;
// The partial W sums the two warpgroups trade at the end (in the ring).
template <int T>
constexpr int kTradeBytes = 4 * (T / 2 + T) * 128;

// Bytes between the operand's M blocks for kst window rows.
__host__ __device__ __forceinline__ int operand_pitch(int kst) {
  return 16 * kst + 16;
}

// Bytes of the landing ring (or the traded sums, the larger).
template <int T>
__host__ __device__ __forceinline__ int ring_bytes(int kst) {
  const int ring = kSlots * kst * kStageCols;
  return ring > kTradeBytes<T> ? ring : kTradeBytes<T>;
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Bytes 0-3 of `lo`, then of `hi` (8 samples), widened to bf16 in order:
// B by the f32 hop, C and D by u8 -> i32 -> bf16.
template <int V>
__device__ __forceinline__ uint4 widen(unsigned lo, unsigned hi) {
  if constexpr (V == kB) {
    return make_uint4(
        pack_bf16(wgmma::byte_f(lo, 0), wgmma::byte_f(lo, 1)),
        pack_bf16(wgmma::byte_f(lo, 2), wgmma::byte_f(lo, 3)),
        pack_bf16(wgmma::byte_f(hi, 0), wgmma::byte_f(hi, 1)),
        pack_bf16(wgmma::byte_f(hi, 2), wgmma::byte_f(hi, 3)));
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned src = i < 2 ? lo : hi;
      const int j = 2 * (i & 1);
      const __nv_bfloat162 v = __halves2bfloat162(
          __int2bfloat16_rn(static_cast<int>((src >> (8 * j)) & 0xFFu)),
          __int2bfloat16_rn(static_cast<int>((src >> (8 * j + 8)) & 0xFFu)));
      w[i] = *reinterpret_cast<const unsigned*>(&v);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The warpgroup's 64 columns of the kst landed rows (row k at landed +
// k * 128) into its operand buffer `op`: a thread takes 16 columns of a
// row, their even columns to M block 2 p and their odd ones to 2 p + 1.
template <int V>
__device__ __forceinline__ void convert(unsigned char* op,
                                        const unsigned char* landed,
                                        int kst, int pitch, int wt) {
  for (int i = wt; i < 4 * kst; i += 128) {
    const int k = i >> 2, p = i & 3;
    const uint4 q =
        *reinterpret_cast<const uint4*>(landed + k * kStageCols + 16 * p);
    unsigned char* row = op + (k >> 3) * kLbo + (k & 7) * 16;
    *reinterpret_cast<uint4*>(row + 2 * p * pitch) =
        widen<V>(__byte_perm(q.x, q.y, 0x6420), __byte_perm(q.z, q.w, 0x6420));
    *reinterpret_cast<uint4*>(row + (2 * p + 1) * pitch) =
        widen<V>(__byte_perm(q.x, q.y, 0x7531), __byte_perm(q.z, q.w, 0x7531));
  }
}

// B k-steps k0 .. k0 + B - 1 of an H chain: d += A's k-steps (descriptor
// adesc, 256 bytes apart) x B's (bdesc, T * 32 bytes apart), then one
// wait.
template <int T, int B>
__device__ __forceinline__ void h_batch(float (&d)[T / 2], uint64_t adesc,
                                        int k0, uint64_t bdesc) {
  wgmma::fence();
#pragma unroll
  for (int i = 0; i < B; ++i)
    wgmma::mma_ss<T>(d, adesc + (((k0 + i) * 2 * kLbo) >> 4),
                     bdesc + (((k0 + i) * T * 32) >> 4));
  wgmma::commit();
  wgmma::wait_all();
}

// One chain of the H pass: d [64 columns, T] = A's nk k-steps x B, in
// batches of kHBatch, then of 2, then of 1 k-step. Each batch size is a
// loop of its own, so that no wgmma sits under a branch.
template <int T>
__device__ __forceinline__ void h_chain(float (&d)[T / 2], uint64_t adesc,
                                        int nk, uint64_t bdesc) {
#pragma unroll
  for (int i = 0; i < T / 2; ++i) d[i] = 0.0f;
  int k0 = 0;
  for (; k0 + kHBatch <= nk; k0 += kHBatch)
    h_batch<T, kHBatch>(d, adesc, k0, bdesc);
  for (; k0 + 2 <= nk; k0 += 2) h_batch<T, 2>(d, adesc, k0, bdesc);
  for (; k0 < nk; ++k0) h_batch<T, 1>(d, adesc, k0, bdesc);
}

template <int T, int V>
__global__ void __launch_bounds__(kThreads, T <= 16 ? 2 : 1)
nv12_staged_kernel(const __grid_constant__ CUtensorMap map,
                   const uint8_t* __restrict__ src, long long bs,
                   long long rs, int by_tma, Tail tl, Geometry g,
                   const uint4* __restrict__ b_tiles,
                   const int2* __restrict__ starts, int ky, int kc,
                   const int4* __restrict__ heads,
                   const uint4* __restrict__ frags,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kGy = kGroupY<T>, kGc = kGroupC<T>;
  constexpr int kW = kWSteps<V>;
  const int kst = ky + kc;  // stacked window rows: luma, then chroma
  const int pitch = operand_pitch(kst);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  unsigned char* ring = smem;  // kSlots x [kst, 128] bytes
  unsigned char* op = smem + ring_bytes<T>(kst) + wg * 8 * pitch;
  unsigned char* bw = smem + ring_bytes<T>(kst) + 16 * pitch;  // B_y, B_c
  unsigned char* hy = bw + 2 * kst * T + wg * kChunkBytes<T, V>;
  unsigned char* hc = hy + 8 * kGy;  // chroma H rows
  uint64_t* full =
      reinterpret_cast<uint64_t*>(bw + 2 * kst * T + 2 * kChunkBytes<T, V>);
  const int tile = blockIdx.x, strip = blockIdx.y;
  const int4 hd = __ldg(heads + tile);  // first chunk, x0, chunks
  const int nstages = hd.z / 2;
  const int o0 = strip * T;
  const int rows = min(T, g.dst_h - o0);
  const int2 st = __ldg(starts + strip);
  const int nv12_rows = g.src_h * 3 / 2;

  if (tid == 0) {
    if (wgmma::smem_u32(smem) & 127) __trap();  // TMA's destinations
    for (int s = 0; s < kSlots; ++s)
      tma::mbar_init(full + s, by_tma ? 1 : kThreads);
    tma::fence_mbar_init();
  }
  __syncthreads();

  // Stage s (frame bytes x0 + 128 s on) into its slot: window row k at
  // k * 128, the luma rows from st.x, the chroma rows from src_h + st.y.
  const auto fill = [&](int s) {
    unsigned char* slot = ring + s % kSlots * kst * kStageCols;
    uint64_t* bar = full + s % kSlots;
    const int c0 = hd.y + s * kStageCols;
    if (by_tma) {
      if (tid != 0) return;
      fence_proxy_async();  // the slot's reads, then TMA's writes
      tma::mbar_expect(bar, kst * kStageCols);
      for (int k = 0; k < ky; k += kBox)
        tma::load_box(slot + k * kStageCols, &map, c0, st.x + k, blockIdx.z,
                      bar);
      for (int k = 0; k < kc; k += kBox)
        tma::load_box(slot + (ky + k) * kStageCols, &map, c0,
                      g.src_h + st.y + k, blockIdx.z, bar);
      return;
    }
    const uint8_t* frame = src + blockIdx.z * bs;
    for (int i = tid; i < kst * kStageCols; i += kThreads) {
      const int k = i / kStageCols, c = i % kStageCols;
      const int r = k < ky ? st.x + k : g.src_h + st.y + (k - ky);
      slot[i] = r < nv12_rows && c0 + c < g.src_w
                    ? __ldg(frame + static_cast<long long>(r) * rs + c0 + c)
                    : 0;
    }
    tma::mbar_arrive(bar);
  };
  for (int s = 0; s < kSlots && s < nstages; ++s) fill(s);
  const uint4* bsrc = b_tiles + static_cast<long long>(strip) * kst * T / 8;
  for (int i = tid; i < kst * T / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  fence_proxy_async();  // B, read by wgmma after the loop's first barrier

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int lcol = 16 * warp + 2 * gq;      // the thread's 2 chunk columns
  const uint64_t adesc = desc(op, kLbo, pitch);
  const uint64_t bdesc_y = desc(bw, 128, 256);
  const uint64_t bdesc_c = desc(bw + 2 * ky * T, 128, 256);
  const uint4* wf = frags + static_cast<long long>(hd.x) * kW * 128 + wt;
  // dc: D's [64, 2T] U and V sums, or B's and C's U sums then V sums; in
  // both the V sum of accumulator i is dc[i + T / 2]
  float dy[T / 2], dc[T];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) dy[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < T; ++i) dc[i] = 0.0f;

  for (int s = 0; s < nstages; ++s) {
    tma::mbar_wait(full + s % kSlots, (s / kSlots) & 1);
    if constexpr (!(kKnockout & 6))
      convert<V>(op, ring + s % kSlots * kst * kStageCols + 64 * wg, kst,
                 pitch, wt);
    fence_proxy_async();  // the operand, read by wgmma below
    __syncthreads();  // the slot converted by every thread: refill it
    if (s + kSlots < nstages) fill(s + kSlots);
    uint4 wa[kW];  // the chunk's W weights, loaded under the H pass
    if constexpr (!(kKnockout & 1)) {
      const uint4* f = wf + static_cast<long long>(2 * s + wg) * kW * 128;
#pragma unroll
      for (int i = 0; i < kW; ++i) wa[i] = __ldg(f + i * 128);
    }
    if constexpr (!(kKnockout & 2)) {
      float d[T / 2];
      // d[4 j + e], d[4 j + 2 + e]: row 8 j + 2 tq + e of chunk columns
      // lcol and lcol + 1 (luma: two pixels; chroma: U and V of one)
      h_chain<T>(d, adesc, ky / 16, bdesc_y);
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<unsigned*>(hy + h_off(8 * j + 2 * tq + e, lcol,
                                                  kGy)) =
              pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
      h_chain<T>(d, adesc + ((ky / 8 * kLbo) >> 4), kc / 16, bdesc_c);
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * tq + e;
          if constexpr (V == kD) {
            *reinterpret_cast<__nv_bfloat16*>(hc + h_off(r, lcol / 2, kGc)) =
                __float2bfloat16_rn(d[4 * j + e]);
            *reinterpret_cast<__nv_bfloat16*>(
                hc + h_off(T + r, lcol / 2, kGc)) =
                __float2bfloat16_rn(d[4 * j + 2 + e]);
          } else {
            *reinterpret_cast<unsigned*>(hc + h_off(r, lcol, kGy)) =
                pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
          }
        }
      fence_proxy_async();  // the H rows, read by wgmma below
      warpgroup_sync(wg);
    }
    if constexpr (!(kKnockout & 1)) {
      wgmma::fence();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wgmma::mma<T>(dy, wa[i], desc(hy + 2 * i * kGy, kGy, 128));
      if constexpr (V == kD) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wgmma::mma<2 * T>(dc, wa[4 + i], desc(hc + 2 * i * kGc, kGc, 128));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma::mma<T>(dc, wa[4 + i], desc(hc + 2 * i * kGy, kGy, 128));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma::mma<T>(dc + T / 2, wa[8 + i],
                        desc(hc + 2 * i * kGy, kGy, 128));
      }
      wgmma::commit();
      // before the next chunk's weights overwrite wa and its conversion
      // the operand: a wgmma reads them until its group completes
      wgmma::wait_all();
    }
  }
  __syncthreads();  // every stage landed and read: the ring's bytes are free
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
    if (((i & 3) >> 1) != wg) trade[(T / 2 + i) * 128 + wt] = dc[i];
  __syncthreads();
  uint8_t* ob = out + static_cast<long long>(blockIdx.z) * 3 * g.dst_h *
                          g.dst_w;
  const long long plane_sz = static_cast<long long>(g.dst_h) * g.dst_w;
  // pixel of accumulator 4 j + e: tile column 16 warp + gq + 8 (e / 2),
  // row 8 j + 2 tq + e mod 2; U from dc[4 j + e], V from dc[4 j + e +
  // T / 2]
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * tq + (e & 1);
      const int p = 64 * tile + 16 * warp + gq + 8 * (e >> 1);
      if ((e >> 1) == wg && r < rows && p < g.dst_w) {
        const int iy = 4 * j + e, iv = iy + T / 2;
        csc_store(ob, plane_sz, static_cast<long long>(o0 + r) * g.dst_w + p,
                  dy[iy] + trade[iy * 128 + wt],
                  dc[iy] + trade[(T / 2 + iy) * 128 + wt],
                  dc[iv] + trade[(T / 2 + iv) * 128 + wt], tl);
      }
    }
  }
}

// Shared memory of one block (bytes; lab/staged.py staged_smem_bytes):
// the landing ring (or the traded sums, the larger), the two operand
// buffers, B_y and B_c, the two warpgroups' H rows of a chunk and the
// ring's barriers.
template <int T, int V>
long long smem_bytes(int kst) {
  return ring_bytes<T>(kst) + 16LL * operand_pitch(kst) + 2LL * kst * T +
         2LL * kChunkBytes<T, V> + 8LL * kSlots;
}

template <int T, int V>
cudaError_t launch_tv(const CUtensorMap& map, int tiles, int strips,
                      int batch, cudaStream_t stream, const uint8_t* src,
                      long long bs, long long rs, int by_tma, const Tail& tl,
                      const Geometry& g, const uint4* b, const int2* starts,
                      int ky, int kc, const int4* heads, const uint4* frags,
                      uint8_t* out) {
  const long long smem = smem_bytes<T, V>(ky + kc);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem(nv12_staged_kernel<T, V>, static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  nv12_staged_kernel<T, V>
      <<<dim3(tiles, strips, batch), kThreads, static_cast<size_t>(smem),
         stream>>>(map, src, bs, rs, by_tma, tl, g, b, starts, ky, kc, heads,
                   frags, out);
  return cudaGetLastError();
}

// One m64n16k16 product with both operands in shared memory, A MN-major
// (TA 1) or K-major (TA 0): the test of the descriptors
// (nv12_staged_probe_launch).
template <int TA>
__global__ void __launch_bounds__(128)
staged_probe_kernel(const uint4* __restrict__ a_img, int a_words,
                    const uint4* __restrict__ b_img, int lbo, int sbo,
                    float* __restrict__ d_out) {
  __shared__ __align__(128) uint4 a_s[1024];
  __shared__ __align__(128) uint4 b_s[32];  // [16, 16] bf16, K-major
  const int t = threadIdx.x;
  for (int i = t; i < a_words; i += 128) a_s[i] = __ldg(a_img + i);
  for (int i = t; i < 32; i += 128) b_s[i] = __ldg(b_img + i);
  fence_proxy_async();
  __syncthreads();
  float d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = 0.0f;
  const uint64_t a = desc(a_s, lbo, sbo), b = desc(b_s, 128, 256);
  wgmma::fence();
  wgmma::mma_ss<16, TA>(d, a, b);
  wgmma::commit();
  wgmma::wait_all();
  const int warp = t >> 5, gq = (t & 31) >> 2, tq = t & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d_out[(16 * warp + gq + 8 * (e >> 1)) * 16 + 8 * j + 2 * tq + (e & 1)] =
          d[4 * j + e];
}

}  // namespace

extern "C" {

// `staged` over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes): variant 0 (B), 1
// (C) or 2 (D) on strips of `tile` output rows, (tile, variant) one of
// (16, B), (16, C), (16, D), (32, D). tail: the 18 floats of ops/banded.py
// tail_params. tma 1 stages by TMA (start and strides multiples of 16
// bytes), 0 by element loads. b_tiles, starts, k_luma, k_chroma, w_heads:
// S2's (nv12_static2_launch); w_frags: [chunks, 6, 128] 16-byte words for
// D (S2's), [chunks, 12, 128] for B and C (lab/staged.py
// interleaved_w_tables: 4 luma, 4 U, 4 V k-steps). out is a contiguous
// [batch, 3, dst_h, dst_w] uint8 tensor.
int nv12_staged_launch(const void* src, long long batch_stride,
                       long long row_stride, int buf_rows, int batch,
                       int src_h, int src_w, int dst_h, int dst_w,
                       const float* tail, int variant, int tile, int tma,
                       const void* b_tiles, const int* starts, int k_luma,
                       int k_chroma, const int* w_heads, const void* w_frags,
                       void* out, void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const int strips = tile > 0 ? (dst_h + tile - 1) / tile : 0;
  if (batch > 65535 || strips > 65535 || src_w <= 0 || (src_w & 1) ||
      src_h < 2 || buf_rows < src_h * 3 / 2 || k_luma < 16 ||
      k_luma % 16 != 0 || k_chroma < 16 || k_chroma % 16 != 0 ||
      !banded::aligned16(b_tiles) || !banded::aligned16(w_heads) ||
      !banded::aligned16(w_frags) ||
      (reinterpret_cast<uintptr_t>(starts) & 7) ||
      (tma && !tma::rows_mappable(src, row_stride, batch_stride)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = tile;
  const Tail tl = banded::unpack_tail(tail);
  CUtensorMap map{};
  if (tma) {
    const int e = tma::encode_rows(&map, src, src_w, src_h * 3 / 2, batch,
                                   row_stride, batch_stride, kBox,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  const int tiles = (dst_w + 63) / 64;
  auto go = [&](auto t, auto v) {
    return static_cast<int>(
        launch_tv<decltype(t)::value, decltype(v)::value>(
            map, tiles, strips, batch, static_cast<cudaStream_t>(stream),
            static_cast<const uint8_t*>(src), batch_stride, row_stride, tma,
            tl, g, static_cast<const uint4*>(b_tiles),
            reinterpret_cast<const int2*>(starts), k_luma, k_chroma,
            reinterpret_cast<const int4*>(w_heads),
            static_cast<const uint4*>(w_frags), static_cast<uint8_t*>(out)));
  };
  using I16 = std::integral_constant<int, 16>;
  if (tile == 16 && variant == kB)
    return go(I16(), std::integral_constant<int, kB>());
  if (tile == 16 && variant == kC)
    return go(I16(), std::integral_constant<int, kC>());
  if (tile == 16 && variant == kD)
    return go(I16(), std::integral_constant<int, kD>());
  if (tile == 32 && variant == kD)
    return go(std::integral_constant<int, 32>(),
              std::integral_constant<int, kD>());
  return static_cast<int>(cudaErrorInvalidValue);
}

// One m64n16k16 wgmma with A (64 x 16 bf16) from shared memory, as the
// staged kernel issues them: a_img (a_words 16-byte words, at most 1024)
// is copied into shared memory as it is and read through a descriptor
// with the given leading and stride byte offsets, MN-major (trans_a 1) or
// K-major (0); b_img [16, 16] bf16 in K-major core matrices (ops/banded.py
// core_matrix_order). d_out: [64, 16] float32, row-major.
int nv12_staged_probe_launch(const void* a_img, int a_words,
                             const void* b_img, int trans_a, int lbo,
                             int sbo, void* d_out, void* stream) {
  if (a_words < 1 || a_words > 1024 || lbo < 16 || lbo % 16 != 0 ||
      sbo < 16 || sbo % 16 != 0 || !banded::aligned16(a_img) ||
      !banded::aligned16(b_img))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = trans_a ? staged_probe_kernel<1> : staged_probe_kernel<0>;
  kern<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_img), a_words,
      static_cast<const uint4*>(b_img), lbo, sbo, static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
