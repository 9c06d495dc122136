// Lab probes of the NV12 -> packed RGB kernel for Hopper (sm_90a):
// measuring instruments beside nv12_to_rgb (nv12_to_rgb.cu), on no product
// path.
//
// Replaces the TPU lab-notebook kernel probe_kernel of convert_lab.py (dma,
// inonly, outonly, outband, noquant, noh) -> nv12_convert_probe_launch.
// The notebook's variant_kernel (V1, V2) is nv12_convert_staged.cu.
//
// What bounds them on this card: what bounds nv12_to_rgb. One 64 x 1080p
// batch reads 199 MB and writes 398 MB for ~9 FLOP per output byte, so the
// floor is bytes: 597 MB at 3.35 TB/s, ~0.18 ms. The probes split
// nv12_to_rgb into read, store, quantisation and chroma replication. dma
// and inonly read the whole frame, as the TPU's DMA does, and XOR every
// word they read into a sink, so no load is dead; dma, outonly and outband
// store row 0 of the frame broadcast over the [H, 3W] output (dma and
// outonly from blocks of kOutRows output rows, outband from blocks of
// 216); noquant and noh are the product's per-pixel kernel with the
// store's round/clip, or the chroma row's replication, knocked out.
//
// The launcher takes uint8 NV12 frames whose width is a multiple of 16,
// with 16-byte aligned rows (the wrapper checks), returns
// cudaGetLastError() after its launch, runs on the caller's stream, and
// neither synchronises nor allocates.

#include "banded_common.cuh"

namespace {

using banded::sink_xor;
using banded::stream_rows;

constexpr int kThreads = 256;
constexpr int kPix = 16;      // pixels per thread: one 16-byte load
constexpr int kOutRows = 8;   // output rows per block of dma, inonly, outonly
constexpr int kBandRows = 216;  // output rows per block of outband
constexpr int kInRows = 8;    // inonly: rows, lanes and row step of its sum
constexpr int kInLanes = 128;
constexpr int kInStep = 512;
constexpr int kTile = 32;     // noh: output rows of one chroma copy

enum Probe : int {
  kDma = 0, kInOnly = 1, kOutOnly = 2, kOutBand = 3, kNoQuant = 4, kNoH = 5
};

struct Csc {
  float m[9];    // row c: coefficients of Y, U, V for output channel c
  float off[3];  // per output channel
};

// The product's arithmetic (nv12_to_rgb.cu): ((Y*m0 + (U*m1 + V*m2)) + off)
// without FMA contraction; QUANT rounds half to even and clips, else the
// value is truncated to int and cut to its low byte.
template <bool QUANT>
__device__ __forceinline__ uint32_t channel(float y, float u, float v,
                                            const Csc& k, int c) {
  const float yc = __fmul_rn(y, k.m[3 * c]);
  const float uv =
      __fadd_rn(__fmul_rn(u, k.m[3 * c + 1]), __fmul_rn(v, k.m[3 * c + 2]));
  const float x = __fadd_rn(__fadd_rn(yc, uv), k.off[c]);
  if (QUANT) return static_cast<uint32_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
  return static_cast<uint32_t>(static_cast<int>(x)) & 0xFFu;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& q, int i) {
  const uint32_t w = i < 4 ? q.x : i < 8 ? q.y : i < 12 ? q.z : q.w;
  return (w >> (8 * (i & 3))) & 0xFFu;
}

// Converts 16 pixels with their 16 chroma lanes (8 UV pairs) and stores the
// 48 output bytes of group g (numbered over the contiguous [B, H, 3W]
// output) through the warp's 96 staged words: a warp's groups are
// consecutive, so it stores 1536 contiguous bytes. Every lane of the warp
// calls it, lane i with group g0 + i; `live` lanes have a group, and the
// groups below `limit` are stored.
template <bool QUANT>
__device__ __forceinline__ void store_group(const float* y, const float* c,
                                            const Csc& k, bool live,
                                            long long g, long long limit,
                                            uint4* ws, uint8_t* out) {
  const int lane = threadIdx.x & 31;
  if (live) {
    uint32_t o[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) o[i] = 0;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int pos = 3 * i + ch;
        o[pos >> 2] |= channel<QUANT>(y[i], c[i & ~1], c[i | 1], k, ch)
                       << (8 * (pos & 3));
      }
    }
    ws[3 * lane] = make_uint4(o[0], o[1], o[2], o[3]);
    ws[3 * lane + 1] = make_uint4(o[4], o[5], o[6], o[7]);
    ws[3 * lane + 2] = make_uint4(o[8], o[9], o[10], o[11]);
  }
  __syncwarp();
  const long long g0 = g - lane;
  uint4* ob = reinterpret_cast<uint4*>(out) + g0 * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int word = lane + 32 * i;
    if (g0 + word / 3 < limit) ob[word] = ws[word];
  }
  __syncwarp();
}

// ---- probes -------------------------------------------------------------

// dma, inonly, outonly, outband: block (output-row block, frame). dma and
// inonly fold the block's share of the frame's `rows` rows into the sink;
// outonly and outband fold the frame's first kInRows rows (block 0 only).
// dma, outonly and outband write their output rows as row 0 of the frame
// on each of the three W-wide blocks of a row; inonly's block 0 writes the
// frame's [kInRows, kInLanes] sums.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
probe_stream_kernel(const uint8_t* __restrict__ src, long long bs,
                    long long rs, int rows, int h, int w, unsigned* sink,
                    int sink_words, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t row0[4096];
  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const int nb = gridDim.x;
  const uint8_t* frame = src + b * bs;
  if (MODE == kDma || MODE == kInOnly) {
    const int r0 = static_cast<int>(static_cast<long long>(rows) * k / nb);
    const int r1 = static_cast<int>(static_cast<long long>(rows) * (k + 1) / nb);
    sink_xor(stream_rows(frame, rs, r0, r1, w, true), sink, sink_words,
             static_cast<long long>(b) * nb + k);
  } else if (k == 0) {
    sink_xor(stream_rows(frame, rs, 0, min(kInRows, rows), w, true), sink,
             sink_words, b);
  }
  if (MODE == kInOnly) {
    if (k != 0) return;
    // sum of f[t + i, j] over t in range(0, rows, kInStep), rows past the
    // frame and lanes past w as 0; fp32 sums of integers (exact), the low
    // byte of the truncated sum
    for (int e = threadIdx.x; e < kInRows * kInLanes; e += blockDim.x) {
      const int i = e / kInLanes;
      const int j = e - i * kInLanes;
      float acc = 0.0f;
      for (int t = 0; t < rows; t += kInStep)
        if (t + i < rows && j < w)
          acc += static_cast<float>(
              __ldg(frame + static_cast<long long>(t + i) * rs + j));
      out[(static_cast<long long>(b) * kInRows + i) * kInLanes + j] =
          static_cast<uint8_t>(static_cast<int>(acc) & 0xFF);
    }
    return;
  }
  // row 0 once into shared memory, then 16-byte stores of it
  const int chunks = w / 16;
  for (int x = threadIdx.x; x < chunks; x += blockDim.x)
    reinterpret_cast<uint4*>(row0)[x] = __ldg(reinterpret_cast<const uint4*>(frame) + x);
  __syncthreads();
  const int per = MODE == kOutBand ? kBandRows : kOutRows;
  const int o0 = k * per;
  const int n = min(per, h - o0);
  const long long row_words = 3LL * chunks;  // 16-byte words of an output row
  uint4* ob = reinterpret_cast<uint4*>(out) +
              (static_cast<long long>(b) * h + o0) * row_words;
  for (long long e = threadIdx.x; e < n * row_words; e += blockDim.x)
    ob[e] = reinterpret_cast<const uint4*>(row0)[(e % row_words) % chunks];
}

// noquant, noh: the product's 16-pixel-a-thread kernel (nv12_to_rgb_vec)
// with one part knocked out. noquant stores the truncated value's low byte;
// noh reads chroma row h + (y / kTile) * (kTile / 2) + y % kTile for output
// row y (the TPU probe's copy of the half-height rows in place of the
// replication product), rows at or past `rows` as 0.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
probe_csc_kernel(const uint8_t* __restrict__ src, long long bs, long long rs,
                 int rows, int batch, int h, int w, Csc k,
                 uint8_t* __restrict__ out) {
  __shared__ uint4 stage[kThreads * 3];
  const int groups = w / kPix;
  const long long total = static_cast<long long>(batch) * h * groups;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = g < total;
  float y[kPix], c[kPix];
  if (live) {
    const int x = static_cast<int>(g % groups);
    const long long fr = g / groups;
    const int row = static_cast<int>(fr % h);
    const uint8_t* frame = src + (fr / h) * bs;
    const uint4 yq = __ldg(reinterpret_cast<const uint4*>(
                               frame + static_cast<long long>(row) * rs) + x);
    const int crow = MODE == kNoH
                         ? h + (row / kTile) * (kTile / 2) + row % kTile
                         : h + row / 2;
    const uint4 cq =
        crow < rows ? __ldg(reinterpret_cast<const uint4*>(
                                frame + static_cast<long long>(crow) * rs) + x)
                    : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      y[i] = static_cast<float>(byte_of(yq, i));
      c[i] = static_cast<float>(byte_of(cq, i));
    }
  }
  store_group<MODE != kNoQuant>(y, c, k, live, g, total,
                                stage + (threadIdx.x >> 5) * 96, out);
}

Csc unpack(const float* coef) {
  Csc k;
  for (int i = 0; i < 9; ++i) k.m[i] = coef[i];
  for (int i = 0; i < 3; ++i) k.off[i] = coef[9 + i];
  return k;
}

bool frames_ok(const void* src, long long bs, long long rs, int h, int w) {
  return h > 0 && w > 0 && !((h | w) & 1) && w % kPix == 0 &&
         banded::aligned16(src) && bs % 16 == 0 && rs % 16 == 0;
}

}  // namespace

extern "C" {

// `src` is frame 0 of a uint8 [batch, >= h*3/2, w] NV12 buffer with the
// given batch and row strides (bytes); `coef` a host array of 12 floats (the
// 3x3 matrix, row c = output channel c, then the three offsets), as
// nv12_to_rgb_launch takes it.

// The probe `mode` (0 dma, 1 inonly, 2 outonly, 3 outband, 4 noquant,
// 5 noh) on frames of `rows` buffer rows, into a contiguous uint8 output:
// [batch, 8, 128] for inonly, else [batch, h, 3w]. dma and inonly XOR every
// 32-bit word of the frames' rows into sink[block % sink_words]; outonly
// and outband those of each frame's first 8 rows (int32 words, not cleared
// here). One launch.
int nv12_convert_probe_launch(const void* src, long long batch_stride,
                              long long row_stride, int rows, int batch,
                              int h, int w, const float* coef, int mode,
                              void* sink, int sink_words, void* out,
                              void* stream) {
  if (batch <= 0) return 0;
  if (!frames_ok(src, batch_stride, row_stride, h, w) ||
      !banded::aligned16(out) || mode < kDma || mode > kNoH ||
      rows < h * 3 / 2 || batch > 65535 ||
      (mode <= kOutBand && (sink == nullptr || sink_words < 1 || w > 4096)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint8_t*>(out);
  auto* sk = static_cast<unsigned*>(sink);
  const dim3 rows_grid((h + kOutRows - 1) / kOutRows, batch);
  const dim3 band_grid((h + kBandRows - 1) / kBandRows, batch);
  const long long total = static_cast<long long>(batch) * h * (w / kPix);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const Csc k = unpack(coef);
  switch (mode) {
    case kDma:
      probe_stream_kernel<kDma><<<rows_grid, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, h, w, sk, sink_words, o);
      break;
    case kInOnly:
      probe_stream_kernel<kInOnly><<<rows_grid, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, h, w, sk, sink_words, o);
      break;
    case kOutOnly:
      probe_stream_kernel<kOutOnly><<<rows_grid, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, h, w, sk, sink_words, o);
      break;
    case kOutBand:
      probe_stream_kernel<kOutBand><<<band_grid, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, h, w, sk, sink_words, o);
      break;
    case kNoQuant:
      probe_csc_kernel<kNoQuant><<<blocks, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, batch, h, w, k, o);
      break;
    default:
      probe_csc_kernel<kNoH><<<blocks, kThreads, 0, s>>>(
          in, batch_stride, row_stride, rows, batch, h, w, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
