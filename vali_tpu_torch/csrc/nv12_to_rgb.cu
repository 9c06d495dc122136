// NV12 -> packed RGB / BGR at full resolution for Hopper (sm_90a).
//
// Replaces pallas_nv12_to_rgb / _pallas_nv12_to_rgb_jit
// (vali_tpu/ops/pallas_fused.py). For every pixel: chroma upsampled by
// nearest neighbour on both axes (pixel (x, y) reads the UV pair of
// (x/2, y/2)), the 3x3 CSC, round half to even, clip, three bytes out.
// The TPU kernel folds the upsample and the RGB interleave into selection-
// matrix products only because Mosaic has no strided lane stores; here it
// is a per-pixel kernel.
//
// What bounds it on this card: bytes. One 64 x 1080p batch reads 199 MB
// and writes 398 MB for ~9 FLOP per output byte, so the floor is 597 MB at
// 3.35 TB/s (~0.18 ms). The design reads Y and UV with 16-byte loads (one
// thread: 16 pixels of one row and the 8 UV pairs above them), and stages
// each thread's 48 output bytes through shared memory so that a warp
// stores 96 contiguous 16-byte words instead of 3-byte pixels. Rows whose
// width or alignment does not allow 16-byte access take a per-pixel
// kernel.
//
// Arithmetic, in the order of the TPU kernel's matrix products: for output
// channel c, ((Y*m0 + (U*m1 + V*m2)) + off) with explicit __fmul_rn /
// __fadd_rn (no FMA contraction), then rintf and a clip to [0, 255]. The
// host passes m already in the compute type (bf16-rounded by default, so
// every product is exact in fp32) and the per-channel offset
// -(m0*y_off + (m1+m2)*128) computed from the unrounded matrix, rows
// already in output order (BGR swaps them).
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include "banded_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;  // pixels per thread on the 16-byte path

struct Csc {
  float m[9];    // row c: coefficients of Y, U, V for output channel c
  float off[3];  // per output channel
};

__device__ __forceinline__ uint32_t channel(float y, float u, float v,
                                            const Csc& k, int c) {
  const float yc = __fmul_rn(y, k.m[3 * c]);
  const float uv =
      __fadd_rn(__fmul_rn(u, k.m[3 * c + 1]), __fmul_rn(v, k.m[3 * c + 2]));
  const float x = __fadd_rn(__fadd_rn(yc, uv), k.off[c]);
  return static_cast<uint32_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& q, int i) {
  const uint32_t w = i < 4 ? q.x : i < 8 ? q.y : i < 12 ? q.z : q.w;
  return (w >> (8 * (i & 3))) & 0xFFu;
}

// One thread: 16 pixels of one row. Groups are numbered frame-major over
// [B, H, W/16], so group g's 48 output bytes start at byte 48*g of the
// contiguous [B, H, 3W] output.
__global__ void __launch_bounds__(kThreads)
nv12_to_rgb_vec(const uint8_t* __restrict__ src, long long bs, long long rs,
                int batch, int h, int w, Csc k, uint8_t* __restrict__ out) {
  __shared__ uint4 stage[kThreads * 3];
  const int groups = w / kPix;
  const long long total = static_cast<long long>(batch) * h * groups;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  uint4* ws = stage + (threadIdx.x >> 5) * 96;
  if (g < total) {
    const int x = static_cast<int>(g % groups);
    const long long fr = g / groups;
    const int y = static_cast<int>(fr % h);
    const long long b = fr / h;
    const uint8_t* frame = src + b * bs;
    const uint4 yq = __ldg(reinterpret_cast<const uint4*>(
                               frame + static_cast<long long>(y) * rs) + x);
    const uint4 cq = __ldg(reinterpret_cast<const uint4*>(
                               frame + static_cast<long long>(h + y / 2) * rs) +
                           x);
    uint32_t o[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) o[i] = 0;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const float yv = static_cast<float>(byte_of(yq, i));
      const float uv = static_cast<float>(byte_of(cq, i & ~1));
      const float vv = static_cast<float>(byte_of(cq, i | 1));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int pos = 3 * i + c;
        o[pos >> 2] |= channel(yv, uv, vv, k, c) << (8 * (pos & 3));
      }
    }
    ws[3 * lane] = make_uint4(o[0], o[1], o[2], o[3]);
    ws[3 * lane + 1] = make_uint4(o[4], o[5], o[6], o[7]);
    ws[3 * lane + 2] = make_uint4(o[8], o[9], o[10], o[11]);
  }
  __syncwarp();
  // the warp's groups are consecutive, so its 96 words are contiguous
  const long long g0 = g - lane;
  uint4* ob = reinterpret_cast<uint4*>(out) + g0 * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int word = lane + 32 * i;
    if (g0 + word / 3 < total) ob[word] = ws[word];
  }
}

// One thread: one pixel; any even width and any strides.
__global__ void __launch_bounds__(kThreads)
nv12_to_rgb_scalar(const uint8_t* __restrict__ src, long long bs,
                   long long rs, int batch, int h, int w, Csc k,
                   uint8_t* __restrict__ out) {
  const long long total = static_cast<long long>(batch) * h * w;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = static_cast<int>(i % w);
  const long long fr = i / w;
  const int y = static_cast<int>(fr % h);
  const uint8_t* frame = src + (fr / h) * bs;
  const uint8_t* crow = frame + static_cast<long long>(h + y / 2) * rs;
  const float yv = static_cast<float>(
      __ldg(frame + static_cast<long long>(y) * rs + x));
  const float uv = static_cast<float>(__ldg(crow + (x & ~1)));
  const float vv = static_cast<float>(__ldg(crow + (x | 1)));
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * i + c] = static_cast<uint8_t>(channel(yv, uv, vv, k, c));
}

}  // namespace

extern "C" {

// `src` is frame 0 of a uint8 [B, >= H*3/2, W] NV12 plane with the given
// batch and row strides (bytes); `out` a contiguous uint8 [B, H, 3W].
// `coef` is a host array of 12 floats: the 3x3 matrix (row c = output
// channel c), then the three offsets.
int nv12_to_rgb_launch(const void* src, long long batch_stride,
                       long long row_stride, int batch, int h, int w,
                       const float* coef, void* out, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if ((h | w) & 1) return static_cast<int>(cudaErrorInvalidValue);
  Csc k;
  for (int i = 0; i < 9; ++i) k.m[i] = coef[i];
  for (int i = 0; i < 3; ++i) k.off[i] = coef[9 + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint8_t*>(out);
  if (w % kPix == 0 && banded::aligned16(src) && banded::aligned16(out) &&
      batch_stride % 16 == 0 && row_stride % 16 == 0) {
    const long long total = static_cast<long long>(batch) * h * (w / kPix);
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    nv12_to_rgb_vec<<<blocks, kThreads, 0, s>>>(in, batch_stride,
                                                row_stride, batch, h, w, k,
                                                o);
  } else {
    const long long total = static_cast<long long>(batch) * h * w;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    nv12_to_rgb_scalar<<<blocks, kThreads, 0, s>>>(in, batch_stride,
                                                   row_stride, batch, h, w,
                                                   k, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
