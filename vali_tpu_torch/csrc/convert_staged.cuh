// The staged NV12 -> packed RGB block for Hopper (sm_90a), shared by the
// product kernel nv12_to_rgb (nv12_to_rgb.cu) and the convert lab's V1 / V2
// (nv12_convert_staged.cu): persistent blocks walking 64-row x 128-pixel
// tiles, each landed by TMA into an mbarrier ring, converted, and stored
// as packed bytes by TMA. Templated over the route V:
//   V = 1  the bf16 CSC on the tensor cores, V1: two m64n48k16 wgmma a
//          16-pixel span, A = the tile's luma and replicated chroma widened
//          once to bf16, B = the per-group matrices Ag16 and Bg16;
//   V = 2  the same with [luma 8 | chroma 8] x [Ag8; Bg8], one m64n24k16 a
//          group of 8 pixels {0, 1, 4, 5, ...} / {2, 3, 6, 7, ...} (the lab's
//          V2, half V1's products);
//   V = 0  the f32 CSC on the CUDA cores: channel()'s products and sums of
//          each landed sample, in nv12_to_rgb's order, into the output
//          tile (no operand, no B).
//
// What bounds it on this card: the bytes. A 64 x 1080p batch reads 199 MB
// and writes 398 MB: 0.178 ms at 3.35 TB/s. The products V1 issues, zeros
// included, are 192 FLOP a pixel (V2 96): 25.7 GFLOP, 0.026 ms at 989
// TFLOP/s (lab/timing.py convert_work).
//
// Design. Persistent blocks of one warpgroup (128 threads, two an SM) walk
// the batch's tiles, a tile 64 output rows (wgmma's M) by 128 pixels of one
// frame: 1080p has 17 bands (the last of 56 rows) of 15 tiles. Block k
// takes tiles k, k + blocks, k + 2 blocks, ...: the tiles in flight at once
// lie side by side in the frames, which the card's memory served faster
// than 264 runs of consecutive tiles far apart (0.88 of the time on an
// H100; PERF.md section 5). A block per band and frame would leave a fifth
// wave 12 % full.
//   - Staging: thread 0 copies a tile's 64 luma rows and its 32 chroma
//     rows (three TMA boxes of [32 rows, 128 B] with the 128-byte swizzle,
//     12 KB) into a ring of three slots, one mbarrier each; the next two
//     tiles land while this one is converted. TMA zero-fills what lies past
//     the frame's width or the buffer's rows; those bytes reach only output
//     bytes that the store clips.
//   - Convert once (V 1, 2): the warpgroup widens each landed sample to
//     bf16 by S2's magic chain (wgmma::byte_f, then cvt.rn.bf16x2.f32) into
//     the operand, K-major core matrices without swizzle: 8 rows of 16
//     bytes, K blocks kLbo = 128 B apart, M blocks kSbo = 4112 B apart (the
//     16 spare bytes put a quarter warp's chroma stores in distinct banks).
//     A 16-pixel span s owns K blocks 4 s .. 4 s + 3: V1 luma pixels 0-7,
//     8-15, chroma bytes 0-7, 8-15; V2 [luma | chroma] of pixels {0, 1, 4,
//     5, 8, 9, 12, 13}, then of the others. Chroma row i is written as A
//     rows 2 i and 2 i + 1: the replication. Then fence.proxy.async and a
//     barrier.
//   - Products (V 1, 2): per span, V1 D [64, 48] = A_luma x Ag16 +
//     A_chroma x Bg16 (two m64n48k16); V2 D [64, 24] = [luma 8 | chroma 8]
//     x ABg8 for each of its two 8-pixel groups (two m64n24k16). B's
//     columns are permuted (ops/nv12_to_rgb.py column_map) so that thread
//     tq's accumulators of a row are the output bytes 12 tq .. 12 tq + 11
//     of the span; B's rows are the coefficients' in output order, so BGR
//     is only another B. Each span's first k-step runs with scale-d 0: the
//     sum starts at zero. The next span's products are issued before this
//     span's epilogue.
//   - Epilogue (V 1, 2): + the channel's offset, the clip to [0, 255],
//     rounding half to even (+ 1.5 x 2^23), three 4-byte words a row into
//     the output tile, 64 rows x 384 B kept as three boxes of [64 rows, 128
//     B] in the 128-byte swizzle, so that a warp's stores fall in distinct
//     banks. Thread 0 stores the tile by TMA (one bulk group a tile; boxes
//     past the row are skipped, rows past the frame clipped). One output
//     tile: its store reads it out while the next tile is converted.
//   - V 0: a thread takes 16 pixels of a row (a quarter warp 8 rows of one
//     span, so that its slot reads and its tile writes fall in distinct
//     banks), computes each channel as channel() does, its rounding and
//     clip as the epilogue's quant, and writes its 48 bytes as three
//     16-byte words into the output tile; two output tiles alternate.
// What guards each reuse (no race checker runs on this card; the card
// tests replay the kernel 20 times against one reference):
//   - ring slot s is refilled by thread 0 only after the barrier that
//     follows every thread's reads of it, and is read only after its
//     mbarrier's phase completed;
//   - V 1, 2: the output tile is written only after thread 0 waited
//     (cp.async.bulk.wait_group.read 0, before the barrier after the
//     conversion) for the store issued from it a tile earlier, and is
//     stored only after every thread's fence.proxy.async and the barrier
//     after the epilogue; the operand is overwritten only after that last
//     barrier, which every thread reaches after wgmma.wait_group 0 of the
//     tile's products;
//   - V 0: output tile i % 2 is written in tile i only after thread 0
//     waited (wait_group.read 0, before tile i - 1's barrier) for the
//     store of tile i - 2 from it, and is stored only after every thread's
//     fence.proxy.async and tile i's barrier.
//
// Shared memory: ring 36,864 B, output tiles 24,576 each, operand 32,896,
// B 3,072 (V1) or 768 (V2), three barriers: 97,432 (V1), 95,128 (V2),
// 86,040 (V 0) B, two blocks an SM.
//
// Bits: every bf16-rounded coefficient carries at most 10 fractional bits,
// so each product with a uint8 sample and each partial sum (|sum| <= 835)
// is exact in fp32, in any order and with any number of zero terms: D is
// the pre-offset sum exactly, and the offset added after it gives
// channel()'s bits. V 0 runs channel()'s arithmetic itself; quant's clip
// then + 1.5 x 2^23 rounds half to even as rintf does, and the clip
// commutes with the rounding at the integers 0 and 255.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_common.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

namespace convert_staged {
// Internal linkage: the product's and the labs' libraries both include
// this block, and a function-local static of an inline or template
// function with external linkage (launch's resident blocks) would be one
// object across both loaded libraries (a GNU unique symbol), so that the
// second library's kernel would launch without its shared-memory
// allowance.
namespace {

using wgmma::byte_f;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::pack_bf16;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kBand = 64;              // output rows of a tile: wgmma's M
constexpr int kTileW = 128;            // pixels (and frame bytes) of a tile
constexpr int kSpans = kTileW / 16;    // 16-pixel spans of a tile
constexpr int kBoxRows = 32;           // rows of a TMA load box
constexpr int kSlots = 3;              // landing ring
constexpr int kSlotBytes = (kBand + kBand / 2) * kTileW;  // 12,288
constexpr int kLbo = 128;              // operand K blocks
constexpr int kSbo = 32 * kLbo + 16;   // operand M blocks
constexpr int kOperandBytes = kBand / 8 * kSbo;
constexpr int kOutBox = 128;           // bytes of an output box row
constexpr int kOutBoxBytes = kBand * kOutBox;
constexpr int kOutBytes = 3 * kOutBoxBytes;  // 64 rows x 384 B
constexpr int kBLayer = 48 * 16 * 2;   // one K-major [16, 48] bf16 B

// The f32 route's coefficients: row c = output channel c's Y, U, V.
struct Csc {
  float m[9];
};

// Bytes of B: V1 Ag16 then Bg16, V2 ABg8 ([16, 24]), V 0 none.
template <int V>
constexpr int kBBytes = V == 1 ? 2 * kBLayer : V == 2 ? kBLayer / 2 : 0;
// Output tiles: one, two on the f32 route.
template <int V>
constexpr int kOutTiles = V == 0 ? 2 : 1;
template <int V>
constexpr int kSmemBytes = kSlots * kSlotBytes + kOutTiles<V> * kOutBytes +
                           (V == 0 ? 0 : kOperandBytes) + kBBytes<V> +
                           8 * kSlots;

// channel c of one pixel in nv12_to_rgb's order: ((y m0 + (u m1 + v m2)) +
// off), round half to even, clip (no FMA contraction).
__device__ __forceinline__ uint32_t channel(float y, float u, float v,
                                            const Csc& k, const float* off,
                                            int c) {
  const float yc = __fmul_rn(y, k.m[3 * c]);
  const float uv =
      __fadd_rn(__fmul_rn(u, k.m[3 * c + 1]), __fmul_rn(v, k.m[3 * c + 2]));
  const float x = __fadd_rn(__fadd_rn(yc, uv), off[c]);
  return static_cast<uint32_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
}

// K block of span s holding `plane` (0 luma, 1 chroma) half `half`: V1
// luma 0-7, 8-15, chroma 0-7, 8-15; V2 luma and chroma of the first group,
// then of the second.
template <int V>
__device__ __forceinline__ int kblock(int s, int plane, int half) {
  return 4 * s + (V == 1 ? 2 * plane + half : plane + 2 * half);
}

// The 16 samples of `q` as two halves of 8 bf16 (S2's magic chain): V1
// bytes 0-7 and 8-15; V2 bytes {0, 1, 4, 5, 8, 9, 12, 13} and the others.
template <int V>
__device__ __forceinline__ void widen(const uint4& q, uint4& lo,
                                      uint4& hi) {
  if constexpr (V == 1) {
    lo = make_uint4(pack_bf16(byte_f(q.x, 0), byte_f(q.x, 1)),
                    pack_bf16(byte_f(q.x, 2), byte_f(q.x, 3)),
                    pack_bf16(byte_f(q.y, 0), byte_f(q.y, 1)),
                    pack_bf16(byte_f(q.y, 2), byte_f(q.y, 3)));
    hi = make_uint4(pack_bf16(byte_f(q.z, 0), byte_f(q.z, 1)),
                    pack_bf16(byte_f(q.z, 2), byte_f(q.z, 3)),
                    pack_bf16(byte_f(q.w, 0), byte_f(q.w, 1)),
                    pack_bf16(byte_f(q.w, 2), byte_f(q.w, 3)));
  } else {
    lo = make_uint4(pack_bf16(byte_f(q.x, 0), byte_f(q.x, 1)),
                    pack_bf16(byte_f(q.y, 0), byte_f(q.y, 1)),
                    pack_bf16(byte_f(q.z, 0), byte_f(q.z, 1)),
                    pack_bf16(byte_f(q.w, 0), byte_f(q.w, 1)));
    hi = make_uint4(pack_bf16(byte_f(q.x, 2), byte_f(q.x, 3)),
                    pack_bf16(byte_f(q.y, 2), byte_f(q.y, 3)),
                    pack_bf16(byte_f(q.z, 2), byte_f(q.z, 3)),
                    pack_bf16(byte_f(q.w, 2), byte_f(q.w, 3)));
  }
}

// A landed slot (luma row m at m * 128, chroma row i at (64 + i) * 128,
// 16-byte chunk c of row r at chunk c ^ (r mod 8)) into the operand. A
// thread takes 16 samples of a row; a quarter warp 8 consecutive rows of
// one span, so that its loads and its stores fall in distinct banks.
template <int V>
__device__ __forceinline__ void convert(unsigned char* op,
                                        const unsigned char* slot, int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {  // luma: 64 rows x 8 spans
    const int idx = tid + kThreads * it, m = idx & 63, s = idx >> 6;
    const uint4 q = *reinterpret_cast<const uint4*>(
        slot + m * kTileW + ((s ^ (m & 7)) << 4));
    uint4 lo, hi;
    widen<V>(q, lo, hi);
    unsigned char* row = op + (m >> 3) * kSbo + (m & 7) * 16;
    *reinterpret_cast<uint4*>(row + kblock<V>(s, 0, 0) * kLbo) = lo;
    *reinterpret_cast<uint4*>(row + kblock<V>(s, 0, 1) * kLbo) = hi;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {  // chroma: 32 rows x 8 spans, each twice
    const int idx = tid + kThreads * it, i = idx & 31, s = idx >> 5;
    const uint4 q = *reinterpret_cast<const uint4*>(
        slot + (kBand + i) * kTileW + ((s ^ (i & 7)) << 4));
    uint4 lo, hi;
    widen<V>(q, lo, hi);
    unsigned char* row = op + (i >> 2) * kSbo + ((2 * i) & 7) * 16;
    unsigned char* a = row + kblock<V>(s, 1, 0) * kLbo;
    unsigned char* b = row + kblock<V>(s, 1, 1) * kLbo;
    *reinterpret_cast<uint4*>(a) = lo;       // A row 2 i
    *reinterpret_cast<uint4*>(a + 16) = lo;  // A row 2 i + 1
    *reinterpret_cast<uint4*>(b) = hi;
    *reinterpret_cast<uint4*>(b + 16) = hi;
  }
}

// Span sp's products into d: V1 luma x Ag (scale-d 0) + chroma x Bg; V2
// each 8-pixel group's one k-step into its 12 accumulators (scale-d 0).
template <int V>
__device__ __forceinline__ void issue(float (&d)[24], uint64_t a,
                                      uint64_t b, int sp) {
  const uint64_t as = a + ((4 * sp * kLbo) >> 4);
  const uint64_t second = (2 * kLbo) >> 4;
  if constexpr (V == 1) {
    wgmma::mma_ss<48, 0, 0>(d, as, b);
    wgmma::mma_ss<48, 0, 1>(d, as + second, b + (kBLayer >> 4));
  } else {
    wgmma::mma_ss<24, 0, 0>(d, as, b);
    wgmma::mma_ss<24, 0, 0>(d + 12, as + second, b);
  }
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma wait or issue.
__device__ __forceinline__ void pin(float (&d)[24]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// fl(x + off) clipped to [0, 255] and rounded half to even: the low byte
// of the result's bits (x + 1.5 x 2^23 keeps the integer in the mantissa).
__device__ __forceinline__ unsigned quant(float x, float off) {
  const float t = fminf(fmaxf(__fadd_rn(x, off), 0.0f), 255.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// Byte offset of byte p (0 .. 383) of output row r in the output tile:
// box p / 128, its 16-byte chunk XORed with r mod 8.
__device__ __forceinline__ int out_off(int r, int p) {
  return (p >> 7) * kOutBoxBytes + r * kOutBox + ((p & 127) ^ ((r & 7) << 4));
}

// Four bytes (the low byte of each) as one word, a first.
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b,
                                          unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Span sp's bytes of rows row0 and row0 + 8: thread byte i (0 .. 11) of a
// row is accumulator 4 (i / 2) + 2 h + i mod 2 (h the row half), output
// byte 48 sp + 12 tq + i of the tile row, channel i mod 3.
__device__ __forceinline__ void epilogue(const float (&d)[24], int sp,
                                         unsigned char* ot, int row0,
                                         int tq, const float (&off)[3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      unsigned b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * k + e;
        b[e] = quant(d[4 * (i >> 1) + 2 * h + (i & 1)], off[i % 3]);
      }
      *reinterpret_cast<unsigned*>(ot + out_off(r, 48 * sp + 12 * tq + 4 * k)) =
          pack4(b[0], b[1], b[2], b[3]);
    }
  }
}

// The f32 route's tile: a thread's 16-pixel items (row m, span s) of a
// landed slot into the output tile, 48 bytes an item. Each channel is
// channel()'s products and sums in its order, (y m0 + (u m1 + v m2)),
// then the offset, the clip and the rounding as the bf16 epilogue does
// them (quant: the bits of rintf and the clip, without a conversion-unit
// F2I a byte); the samples are widened by byte_f (exact).
__device__ __forceinline__ void csc_f32(unsigned char* ot,
                                        const unsigned char* slot, int tid,
                                        const Csc& k, const float (&off)[3]) {
#pragma unroll 2
  for (int it = 0; it < 4; ++it) {
    const int idx = tid + kThreads * it, m = idx & 63, s = idx >> 6;
    const int i = m >> 1;  // the chroma row above luma row m
    const uint4 yq = *reinterpret_cast<const uint4*>(
        slot + m * kTileW + ((s ^ (m & 7)) << 4));
    const uint4 cq = *reinterpret_cast<const uint4*>(
        slot + (kBand + i) * kTileW + ((s ^ (i & 7)) << 4));
    const unsigned yw[4] = {yq.x, yq.y, yq.z, yq.w};
    const unsigned cw[4] = {cq.x, cq.y, cq.z, cq.w};
    unsigned o[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // pixels 4 j .. 4 j + 3: bytes 12 j ..
      unsigned b[12];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // a chroma pair, two pixels
        const float u = byte_f(cw[j], 2 * q), v = byte_f(cw[j], 2 * q + 1);
        float uv[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          uv[c] = __fadd_rn(__fmul_rn(u, k.m[3 * c + 1]),
                            __fmul_rn(v, k.m[3 * c + 2]));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * q + e;
          const float y = byte_f(yw[j], p);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            b[3 * p + c] =
                quant(__fadd_rn(__fmul_rn(y, k.m[3 * c]), uv[c]), off[c]);
        }
      }
#pragma unroll
      for (int w = 0; w < 3; ++w)
        o[3 * j + w] = pack4(b[4 * w], b[4 * w + 1], b[4 * w + 2],
                             b[4 * w + 3]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint4*>(ot + out_off(m, 48 * s + 16 * j)) =
          make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
}

// `b_tiles`: V 1, 2 the route's B (ops/nv12_to_rgb.py b_image); V 0 the
// nine f32 coefficients (struct Csc).
template <int V>
__global__ void __launch_bounds__(kThreads)
convert_staged_kernel(const __grid_constant__ CUtensorMap in_map,
                      const __grid_constant__ CUtensorMap out_map, int h,
                      int row_bytes, int bands, int tiles_w, int tiles,
                      const uint4* __restrict__ b_tiles, float off0,
                      float off1, float off2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* ot = ring + kSlots * kSlotBytes;  // the output tile(s)
  unsigned char* op = ot + kOutTiles<V> * kOutBytes;
  unsigned char* bw = op + (V == 0 ? 0 : kOperandBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bw + kBBytes<V>);
  const int tid = threadIdx.x;
  // the block's tiles: blockIdx.x + i * gridDim.x for i < n
  const int t0 = blockIdx.x, step = gridDim.x;
  const int n = (tiles - t0 + step - 1) / step;
  const int per_frame = bands * tiles_w;
  // (column tile, band, frame) of the block's i-th tile
  const auto tile = [&](int i) {
    const int t = t0 + i * step, z = t / per_frame, r = t - z * per_frame;
    const int band = r / tiles_w;
    return make_int3(r - band * tiles_w, band, z);
  };

  if (tid == 0) {
    if (wgmma::smem_u32(smem) & 1023) __trap();  // the swizzle's atoms
    for (int s = 0; s < kSlots; ++s) tma::mbar_init(full + s, 1);
    tma::fence_mbar_init();
  }
  __syncthreads();

  // Tile i's luma rows (two boxes) and chroma rows into slot i % kSlots.
  const auto fill = [&](int i) {
    const int3 c = tile(i);
    unsigned char* slot = ring + (i % kSlots) * kSlotBytes;
    uint64_t* bar = full + i % kSlots;
    const int x = c.x * kTileW;
    tma::mbar_expect(bar, kSlotBytes);
    tma::load_box(slot, &in_map, x, c.y * kBand, c.z, bar);
    tma::load_box(slot + kBoxRows * kTileW, &in_map, x,
                  c.y * kBand + kBoxRows, c.z, bar);
    tma::load_box(slot + kBand * kTileW, &in_map, x, h + c.y * (kBand / 2),
                  c.z, bar);
  };
  // Tile i's output tile `src` by TMA in one bulk group (boxes past the
  // row skipped).
  const auto store = [&](int i, const unsigned char* src) {
    const int3 c = tile(i);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int x = 3 * kTileW * c.x + kOutBox * b;
      if (x < row_bytes)
        tma::store_box(&out_map, src + b * kOutBoxBytes, x, c.y * kBand,
                       c.z);
    }
    tma::bulk_commit();
  };
  if (tid == 0)
    for (int i = 0; i < kSlots && i < n; ++i) fill(i);

  if constexpr (V == 0) {
    Csc k;
    const float* m = reinterpret_cast<const float*>(b_tiles);
#pragma unroll
    for (int j = 0; j < 9; ++j) k.m[j] = __ldg(m + j);
    const float off[3] = {off0, off1, off2};
    for (int i = 0; i < n; ++i) {
      const int s = i % kSlots;
      unsigned char* o = ot + (i & 1) * kOutBytes;
      tma::mbar_wait(full + s, (i / kSlots) & 1);
      csc_f32(o, ring + s * kSlotBytes, tid, k, off);
      fence_proxy_async();  // the output tile, read by TMA below
      // the store issued a tile earlier has read the other output tile
      if (tid == 0) tma::bulk_wait_read<0>();
      __syncthreads();  // slot s read and tile i's output written
      if (tid == 0) {
        if (i + kSlots < n) fill(i + kSlots);
        store(i, o);
      }
    }
  } else {
    for (int i = tid; i < kBBytes<V> / 16; i += kThreads)
      reinterpret_cast<uint4*>(bw)[i] = __ldg(b_tiles + i);
    fence_proxy_async();  // B, read by wgmma after the loop's first barrier

    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = 16 * warp + (lane >> 2), tq = lane & 3;
    const uint64_t adesc = desc(op, kLbo, kSbo);
    const uint64_t bdesc = desc(bw, 128, 256);
    const float off[3] = {off0, off1, off2};
    float acc[2][24];
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[0][i] = acc[1][i] = 0.0f;

    for (int i = 0; i < n; ++i) {
      const int s = i % kSlots;
      // the store issued a tile earlier has read the output tile
      if (tid == 0) tma::bulk_wait_read<0>();
      tma::mbar_wait(full + s, (i / kSlots) & 1);
      convert<V>(op, ring + s * kSlotBytes, tid);
      fence_proxy_async();  // the operand, read by wgmma below
      __syncthreads();      // slot s converted by every thread: refill it
      if (tid == 0 && i + kSlots < n) {
        fence_proxy_async();  // the slot's reads, then TMA's writes
        fill(i + kSlots);
      }
      pin(acc[0]);
      wgmma::fence();
      issue<V>(acc[0], adesc, bdesc, 0);
      wgmma::commit();
#pragma unroll
      for (int sp = 0; sp < kSpans; ++sp) {
        if (sp + 1 < kSpans) {
          pin(acc[(sp + 1) & 1]);
          wgmma::fence();
          issue<V>(acc[(sp + 1) & 1], adesc, bdesc, sp + 1);
          wgmma::commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        pin(acc[sp & 1]);
        epilogue(acc[sp & 1], sp, ot, row0, tq, off);
      }
      fence_proxy_async();  // the output tile, read by TMA below
      __syncthreads();
      if (tid == 0) store(i, ot);
    }
  }
  if (tid == 0) tma::bulk_wait<0>();
}

// Whether TMA can describe an NV12 buffer at `src` (row and batch strides
// `rs`, `bs` bytes) of width `w` and its packed output at `out`: w a
// multiple of 16, 16-byte aligned starts and strides that are multiples of
// 16 bytes.
inline bool tma_ok(const void* src, long long rs, long long bs, int w,
                   const void* out) {
  return w % 16 == 0 && tma::rows_mappable(src, rs, bs) &&
         banded::aligned16(out);
}

// The input and output tensor maps of a launch: frames of `rows` buffer
// rows (>= h * 3 / 2) in boxes of [32 rows, 128 B], the packed [batch, h,
// 3 w] output in boxes of [64 rows, 128 B]. Returns a cudaError_t.
inline int encode_maps(CUtensorMap* in_map, CUtensorMap* out_map,
                       const void* src, long long rs, long long bs, int rows,
                       int batch, int h, int w, void* out) {
  int e = tma::encode_rows(in_map, src, w, rows, batch, rs, bs, kBoxRows);
  if (e != 0) return e;
  return tma::encode_rows(out_map, out, 3 * w, h, batch, 3LL * w,
                          3LL * w * h, kBand);
}

// One launch of route V over `tiles` tiles (bands x tiles_w a frame):
// min(tiles, resident blocks) persistent blocks. The kernel's shared
// memory allowance and the card's resident blocks are set and asked once
// a device.
template <int V>
int launch(const CUtensorMap& in_map, const CUtensorMap& out_map, int h,
           int w, int bands, int tiles_w, int tiles, const void* b,
           const float* off, cudaStream_t stream) {
  const auto kern = convert_staged_kernel<V>;
  constexpr size_t smem = kSmemBytes<V>;
  static int resident[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per = 0, sms = 0;
    e = banded::allow_smem(kern, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern,
                                                        kThreads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per * sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
    resident[dev] = per * sms;
  }
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  kern<<<grid, kThreads, smem, stream>>>(
      in_map, out_map, h, 3 * w, bands, tiles_w, tiles,
      static_cast<const uint4*>(b), off[0], off[1], off[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace convert_staged
