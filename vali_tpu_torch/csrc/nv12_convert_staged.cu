// Lab kernels V1 and V2 of the NV12 -> RGB convert lab for Hopper
// (sm_90a): the bf16-staged convert, its colour-space conversion run as
// wgmma products with both operands in shared memory.
//
// Replaces variant_kernel of convert_lab.py (V1, V2; def :84, pallas_call
// :156 and :166). On the TPU each variant casts a frame's luma, and its
// chroma replicated to full height by a 0/1 product, into bf16 scratch
// once, then runs the CSC as matrix-unit products over 128-pixel groups:
// V1 as luma @ Ag + chroma @ Bg, V2 as one K = 256 product over [luma 128
// | chroma 128] against [Ag; Bg]; then round and clip. Its question: what
// does the staged copy cost against the per-pixel conversion of
// nv12_to_rgb? Here the same experiment meets the tensor cores' operand:
// each sample is widened once into the layout wgmma reads A from, and the
// products run at wgmma's k16.
//
// What bounds it on this card: the bytes. A 64 x 1080p batch reads 199 MB
// and writes 398 MB: 0.178 ms at 3.35 TB/s. The products it issues, zeros
// included, are 192 FLOP a pixel for V1 and 96 for V2 (25.7 and 12.8
// GFLOP, 0.026 and 0.013 ms at 989 TFLOP/s; lab/timing.py convert_work).
// Shared memory carries 4 B a pixel of operand and 3 B of output, each
// written once and read once.
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
//   - Convert once: the warpgroup widens each landed sample to bf16 by S2's
//     magic chain (wgmma::byte_f, then cvt.rn.bf16x2.f32) into the operand,
//     K-major core matrices without swizzle: 8 rows of 16 bytes, K blocks
//     kLbo = 128 B apart, M blocks kSbo = 4112 B apart (the 16 spare bytes
//     put a quarter warp's chroma stores in distinct banks). A 16-pixel
//     span s owns K blocks 4 s .. 4 s + 3: V1 luma pixels 0-7, 8-15, chroma
//     bytes 0-7, 8-15; V2 [luma | chroma] of pixels {0, 1, 4, 5, 8, 9, 12,
//     13}, then of the others. Chroma row i is written as A rows 2 i and
//     2 i + 1: the replication. Then fence.proxy.async and a barrier.
//   - Products: per span, V1 D [64, 48] = A_luma x Ag16 + A_chroma x Bg16
//     (two m64n48k16); V2 D [64, 24] = [luma 8 | chroma 8] x ABg8 for each
//     of its two 8-pixel groups (two m64n24k16: half V1's FLOPs). B's
//     columns are permuted (lab/convert_staged.py column_map) so that
//     thread tq's accumulators of a row are the output bytes 12 tq .. 12 tq
//     + 11 of the span. Each span's first k-step runs with scale-d 0: the
//     sum starts at zero. The next span's products are issued before this
//     span's epilogue.
//   - Epilogue: + the channel's offset, the clip to [0, 255], rounding half
//     to even (+ 1.5 x 2^23), three 4-byte words a row into the output
//     tile, 64 rows x 384 B kept as three boxes of [64 rows, 128 B] in the
//     128-byte swizzle, so that a warp's stores fall in distinct banks.
//     Thread 0 stores the tile by TMA (one bulk group a tile; boxes past
//     the row are skipped, rows past the frame clipped). One output tile:
//     its store reads it out while the next tile is converted.
// What guards each reuse (no race checker runs on this card; the card
// tests replay the kernel 20 times against one reference):
//   - ring slot s is refilled by thread 0 only after the barrier that
//     follows every thread's conversion from it, and is read only after
//     its mbarrier's phase completed;
//   - the output tile is written only after thread 0 waited
//     (cp.async.bulk.wait_group.read 0, before that same barrier) for the
//     store issued from it a tile earlier, and is stored only after every
//     thread's fence.proxy.async and the barrier after the epilogue;
//   - the operand is overwritten only after that last barrier, which every
//     thread reaches after wgmma.wait_group 0 of the tile's products.
//
// Shared memory: ring 36,864 B, the output tile 24,576, operand 32,896, B
// 3,072 (V1) or 768 (V2), three barriers: 97,432 or 95,128 B, two blocks
// an SM.
//
// Bits: every bf16-rounded coefficient carries at most 10 fractional bits,
// so each product with a uint8 sample and each partial sum (|sum| <= 835)
// is exact in fp32, in any order and with any number of zero terms: D is
// nv12_to_rgb's pre-offset sum exactly, and the offset added after it
// gives nv12_to_rgb's bits.
//
// The launcher encodes the frames' and the output's tensor maps on the
// host, returns cudaGetLastError() after the launch, runs on the caller's
// stream, and neither synchronises nor allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "banded_common.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

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
constexpr int kProbeWords = kOperandBytes / 16;  // the probe's A image

// Bytes of B: V1 Ag16 then Bg16, V2 ABg8 ([16, 24]).
template <int V>
constexpr int kBBytes = V == 1 ? 2 * kBLayer : kBLayer / 2;
template <int V>
constexpr int kSmemBytes = kSlots * kSlotBytes + kOutBytes + kOperandBytes +
                           kBBytes<V> + 8 * kSlots;

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
      const unsigned word = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                                        __byte_perm(b[2], b[3], 0x0040),
                                        0x5410);
      *reinterpret_cast<unsigned*>(ot + out_off(r, 48 * sp + 12 * tq + 4 * k)) =
          word;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
convert_staged_kernel(const __grid_constant__ CUtensorMap in_map,
                      const __grid_constant__ CUtensorMap out_map, int h,
                      int row_bytes, int bands, int tiles_w, int tiles,
                      const uint4* __restrict__ b_tiles, float off0,
                      float off1, float off2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* ot = ring + kSlots * kSlotBytes;  // the output tile
  unsigned char* op = ot + kOutBytes;
  unsigned char* bw = op + kOperandBytes;
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
  if (tid == 0)
    for (int i = 0; i < kSlots && i < n; ++i) fill(i);
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
    if (tid == 0) {
      const int3 c = tile(i);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int x = 3 * kTileW * c.x + kOutBox * b;
        if (x < row_bytes)
          tma::store_box(&out_map, ot + b * kOutBoxBytes, x, c.y * kBand,
                         c.z);
      }
      tma::bulk_commit();
    }
  }
  if (tid == 0) tma::bulk_wait<0>();
}

template <int V>
int launch(const CUtensorMap& in_map, const CUtensorMap& out_map, int h,
           int w, int bands, int tiles_w, int tiles, const uint4* b,
           const float* off, cudaStream_t stream) {
  const auto kern = convert_staged_kernel<V>;
  constexpr size_t smem = kSmemBytes<V>;
  cudaError_t e = banded::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // resident blocks of the card, asked once a device
  static int resident[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads,
                                                      smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per * sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
    resident[dev] = per * sms;
  }
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  kern<<<grid, kThreads, smem, stream>>>(in_map, out_map, h, 3 * w, bands,
                                         tiles_w, tiles, b, off[0], off[1],
                                         off[2]);
  return static_cast<int>(cudaGetLastError());
}

// One m64nNk16 wgmma with both operands in shared memory, A and B K-major,
// the first with scale-d 0 over NaN accumulators, TWICE a second with
// scale-d 1: the test of the instances the kernel issues
// (nv12_convert_staged_probe_launch).
template <int N, int TWICE>
__global__ void __launch_bounds__(128)
convert_staged_probe_kernel(const uint4* __restrict__ a_img, int a_words,
                            const uint4* __restrict__ b_img, int b_words,
                            int lbo, int sbo, float* __restrict__ d_out) {
  __shared__ __align__(128) uint4 a_s[kProbeWords];
  __shared__ __align__(128) uint4 b_s[kBLayer / 16];
  const int t = threadIdx.x;
  for (int i = t; i < a_words; i += 128) a_s[i] = __ldg(a_img + i);
  for (int i = t; i < b_words; i += 128) b_s[i] = __ldg(b_img + i);
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = __int_as_float(0x7FC00000);
  const uint64_t a = desc(a_s, lbo, sbo), b = desc(b_s, 128, 256);
  wgmma::fence();
  wgmma::mma_ss<N, 0, 0>(d, a, b);
  if constexpr (TWICE) wgmma::mma_ss<N, 0, 1>(d, a, b);
  wgmma::commit();
  wgmma_wait<0>();
  const int warp = t >> 5, gq = (t & 31) >> 2, tq = t & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d_out[(16 * warp + gq + 8 * (e >> 1)) * N + 8 * j + 2 * tq + (e & 1)] =
          d[4 * j + e];
}

}  // namespace

extern "C" {

// V1 (variant 1) or V2 (variant 2) of the staged convert: `src` is frame 0
// of a uint8 [batch, rows, w] NV12 buffer (rows >= h * 3 / 2) with the
// given batch and row strides (bytes; start and strides multiples of 16
// bytes, as TMA needs), `coef` a host array of 12 floats (nv12_to_rgb's:
// the 3x3 matrix, then the three offsets, read here), `b_tiles` the
// variant's B on the device (lab/convert_staged.py b_image: V1 Ag16 then
// Bg16, V2 ABg8, columns permuted, in K-major core matrices), `out` a
// contiguous uint8 [batch, h, 3w]. w a multiple of 16. One launch.
int nv12_convert_staged_launch(const void* src, long long batch_stride,
                               long long row_stride, int rows, int batch,
                               int h, int w, const float* coef, int variant,
                               const void* b_tiles, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (h <= 0 || w <= 0 || (h & 1) || w % 16 != 0 || rows < h * 3 / 2 ||
      (variant != 1 && variant != 2) ||
      !tma::rows_mappable(src, row_stride, batch_stride) ||
      !banded::aligned16(out) || !banded::aligned16(b_tiles) ||
      w > INT_MAX / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (h + kBand - 1) / kBand;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(batch) * bands * tiles_w;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap in_map{}, out_map{};
  int e = tma::encode_rows(&in_map, src, w, rows, batch, row_stride,
                           batch_stride, kBoxRows);
  if (e != 0) return e;
  e = tma::encode_rows(&out_map, out, 3 * w, h, batch, 3LL * w,
                       3LL * w * h, kBand);
  if (e != 0) return e;
  const auto* b = static_cast<const uint4*>(b_tiles);
  const auto s = static_cast<cudaStream_t>(stream);
  return variant == 1
             ? launch<1>(in_map, out_map, h, w, bands, tiles_w,
                         static_cast<int>(tiles), b, coef + 9, s)
             : launch<2>(in_map, out_map, h, w, bands, tiles_w,
                         static_cast<int>(tiles), b, coef + 9, s);
}

// One m64nNk16 wgmma (n 24 or 48) with A and B K-major in shared memory,
// as the staged convert issues them: a_img (a_words 16-byte words, at most
// an operand's 2056) is copied into shared memory as it is and read through a
// descriptor with the given leading and stride byte offsets; b_img (b_words
// words, at most 96) [16, n] bf16 in K-major core matrices (leading byte
// offset 128, stride 256). The product runs with scale-d 0 over NaN
// accumulators, and with `twice` once more with scale-d 1. d_out: [64, n]
// float32, row-major.
int nv12_convert_staged_probe_launch(const void* a_img, int a_words,
                                     const void* b_img, int b_words, int n,
                                     int twice, int lbo, int sbo,
                                     void* d_out, void* stream) {
  if (a_words < 1 || a_words > kProbeWords || b_words < 1 ||
      b_words > kBLayer / 16 || (n != 24 && n != 48) || lbo < 16 ||
      lbo % 16 != 0 || sbo < 16 || sbo % 16 != 0 ||
      !banded::aligned16(a_img) || !banded::aligned16(b_img))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern =
      n == 24 ? (twice ? convert_staged_probe_kernel<24, 1>
                       : convert_staged_probe_kernel<24, 0>)
              : (twice ? convert_staged_probe_kernel<48, 1>
                       : convert_staged_probe_kernel<48, 0>);
  kern<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_img), a_words,
      static_cast<const uint4*>(b_img), b_words, lbo, sbo,
      static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
