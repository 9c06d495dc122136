// Lab variant G of the banded NV12 preprocess kernel for Hopper (sm_90a):
// the H pass as a dense block-diagonal product on the tensor cores.
//
// Replaces grouped_kernel of bench_kernel_variants.py: on the TPU one
// M = 128 product runs 2 luma + 2 chroma 32-row tiles over their stacked
// windows, the block-diagonal zeros spent as real FLOPs to fill the
// matrix unit. Its counterpart here is the warp-level tensor-core product,
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// What bounds it on this card: the function is the product kernel's, so
// its bytes bound it (199 MB in, 9.6 MB out per 64 x 1080p -> 224 batch:
// 0.062 ms at 3.35 TB/s). The dense product is ~21 GFLOP a batch, 8.6x the
// banded FMAs, yet only ~0.021 ms at the data sheet's 989 TFLOP/s bf16: the
// question this variant answers is whether the matrix unit's zero tax is
// cheaper than the banded FMA loop on the CUDA cores (80-92 % of the
// product kernel's time).
//
// Design. One block per group: two consecutive 8-output-row strips of one
// frame (14 groups per 1080p frame at 224 rows). The host builds, once per
// geometry (ops/banded.py grouped_tables), A = [32, K] bf16 per group:
// rows 0-15 the two luma strips' weights over their windows of ly source
// rows, rows 16-31 the two chroma strips' over windows of lc interleaved
// chroma rows; K = 2 ly + 2 lc padded to a multiple of 16 with zero
// columns (190 -> 192 at 1080p -> 224). Windows lie inside their planes.
// The block copies its A to shared memory, then walks the frame in column
// tiles of 128: each tile of the stacked window is converted u8 -> bf16
// into shared memory ([K][128 + 8]: rows padded by 16 B, so ldmatrix's
// eight row reads fall in eight distinct 16-byte bank groups), and each of
// the 8 warps multiplies A by 16 of its columns (2 m16 x 2 n8 tiles,
// K / 16 steps, A through ldmatrix, B through ldmatrix.trans). The fp32
// result is rounded to bf16 into the H rows (luma rows 0-15, chroma 16-31),
// then the product's W pass and tail (banded::wpass_store). No TMA, no
// wgmma and no overlap of staging with the product: a right mma.sync
// kernel first.
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order and precision, so a sum may
// round apart from the banded FMA chain. The lab holds G to the
// kernels' envelope against nv12_preprocess and counts its differing
// samples.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_preprocess.cuh"

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tables;
using banded::Tail;

using T = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps, 16 columns of a tile each
constexpr int kGroupRows = 16;  // output rows of a group: two 8-row strips
constexpr int kM = 32;          // rows of A: 16 luma, 16 chroma
constexpr int kTileN = 128;     // columns of a staged window tile
constexpr int kPad = 8;         // bf16 padding of a shared-memory row

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; thread t gives the address of row t % 8 of
// matrix t / 8.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Frame row of row k of the group's stacked window: the two luma windows
// (starts st.x, st.y), then the two chroma windows (st.z, st.w, rows of the
// interleaved chroma plane under the src_h luma rows).
__device__ __forceinline__ int window_row(int k, int ly, int lc, int4 st,
                                          int src_h) {
  if (k < ly) return st.x + k;
  if (k < 2 * ly) return st.y + k - ly;
  if (k < 2 * ly + lc) return src_h + st.z + k - 2 * ly;
  return src_h + st.w + k - 2 * ly - lc;
}

__global__ void __launch_bounds__(kThreads)
nv12_grouped_kernel(const uint8_t* __restrict__ src, long long bs,
                    long long rs, int vec, Tables t, Tail tl, Geometry g,
                    const T* __restrict__ a_blocks,
                    const int4* __restrict__ starts, int ly, int lc, int kp,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = g.src_w;
  const int ap = kp + kPad;      // pitch of A
  const int bp = kTileN + kPad;  // pitch of a window tile
  T* yh = reinterpret_cast<T*>(smem);  // [16][W] luma H rows
  T* ch = yh + kGroupRows * W;         // [16][W] interleaved chroma H rows
  T* as = ch + kGroupRows * W;         // [32][ap] A
  T* win = as + kM * ap;               // [kp][bp] window tile
  const int grp = blockIdx.x;
  const int b = blockIdx.y;
  const int o0 = grp * kGroupRows;
  const int rows = min(kGroupRows, g.dst_h - o0);
  const uint8_t* frame = src + b * bs;
  const int4 st = __ldg(starts + grp);
  const int kw = 2 * ly + 2 * lc;  // window rows; rows kw .. kp - 1 are 0

  const T* ag = a_blocks + static_cast<long long>(grp) * kM * kp;
  for (int i = threadIdx.x; i < kM * kp / 8; i += blockDim.x) {
    const int r = i / (kp / 8);
    const int c = (i - r * (kp / 8)) * 8;
    *reinterpret_cast<uint4*>(as + r * ap + c) =
        __ldg(reinterpret_cast<const uint4*>(ag + r * kp + c));
  }
  const T zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < (kp - kw) * bp; i += blockDim.x)
    win[kw * bp + i] = zero;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = warp * 16;  // the warp's first column of a tile
  for (int n0 = 0; n0 < W; n0 += kTileN) {
    const int tw = min(kTileN, W - n0);
    // ---- the stacked window's columns [n0, n0 + 128) in bf16 -----------
    if (vec && tw == kTileN) {
      // 8 samples a thread: one 8-byte load, one 16-byte store
      for (int i = threadIdx.x; i < kw * (kTileN / 8); i += blockDim.x) {
        const int k = i / (kTileN / 8);
        const int c = (i - k * (kTileN / 8)) * 8;
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(
            frame + static_cast<long long>(window_row(k, ly, lc, st,
                                                      g.src_h)) * rs +
            n0 + c));
        *reinterpret_cast<uint4*>(win + k * bp + c) = make_uint4(
            pack_bf16(q.x & 0xFFu, (q.x >> 8) & 0xFFu),
            pack_bf16((q.x >> 16) & 0xFFu, q.x >> 24),
            pack_bf16(q.y & 0xFFu, (q.y >> 8) & 0xFFu),
            pack_bf16((q.y >> 16) & 0xFFu, q.y >> 24));
      }
    } else {
      for (int i = threadIdx.x; i < kw * kTileN; i += blockDim.x) {
        const int k = i / kTileN;
        const int c = i - k * kTileN;
        win[k * bp + c] =
            c < tw ? __int2bfloat16_rn(static_cast<int>(__ldg(
                         frame +
                         static_cast<long long>(
                             window_row(k, ly, lc, st, g.src_h)) * rs +
                         n0 + c)))
                   : zero;
      }
    }
    __syncthreads();

    // ---- [32, kp] x [kp, 16] per warp on the tensor cores --------------
    if (nw < tw) {
      float acc[2][2][4] = {};
      const int j = lane & 7, half = (lane >> 3) & 1, quad = lane >> 4;
      for (int k0 = 0; k0 < kp; k0 += 16) {
        unsigned a[2][4], bf[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], as + (mt * 16 + j + 8 * half) * ap + k0 + 8 * quad);
        ldsm_x4_trans(bf, win + (k0 + j + 8 * half) * bp + nw + 8 * quad);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][0], a[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][1], a[mt], bf[2], bf[3]);
        }
      }
      // fragment rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + 0/1
      const int r = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        T* dst = mt == 0 ? yh : ch;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = n0 + nw + nt * 8 + c2;
          if (col < W) {  // W is even: col + 1 < W too
            *reinterpret_cast<__nv_bfloat162*>(dst + r * W + col) =
                __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * W + col) =
                __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites the window
  }

  banded::wpass_store<false, banded::kInterleaved>(
      yh, ch, W, W, rows, o0, g.dst_h, g.dst_w, 0, g.dst_w, 0, 0, t, tl,
      out + static_cast<long long>(b) * 3 * g.dst_h * g.dst_w);
}

}  // namespace

extern "C" {

// G over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12 buffer
// with the given batch and row strides (bytes). Tables and tail as
// nv12_variant_launch takes them (only the W tables are read). a_blocks:
// [groups, 32, k_pad] bf16 on the device, groups = ceil(dst_h / 16);
// starts: [groups, 4] int32 on the device, the first rows of the group's
// two luma windows (of luma_rows rows) and two chroma windows (of
// chroma_rows interleaved chroma rows); k_pad a multiple of 16 at least
// 2 (luma_rows + chroma_rows). out is a contiguous [batch, 3, dst_h,
// dst_w] uint8 tensor.
int nv12_grouped_launch(const void* src, long long batch_stride,
                        long long row_stride, int buf_rows, int batch,
                        int src_h, int src_w, int dst_h, int dst_w,
                        const int* index, const float* weights, int hy_k,
                        int hc_k, int wy_k, int wc_k, const float* tail,
                        const void* a_blocks, const int* starts,
                        int luma_rows, int chroma_rows, int k_pad, void* out,
                        void* stream) {
  (void)wc_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (src_w <= 0 || (src_w & 1) || buf_rows < src_h * 3 / 2 ||
      luma_rows < 1 || luma_rows > src_h || chroma_rows < 1 ||
      chroma_rows > src_h / 2 || k_pad % 16 != 0 ||
      k_pad < 2 * (luma_rows + chroma_rows) || !aligned16(a_blocks) ||
      !aligned16(starts))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      2LL * (2 * kGroupRows * src_w + kM * (k_pad + kPad) +
             static_cast<long long>(k_pad) * (kTileN + kPad));
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = kGroupRows;
  const Tables t = banded::unpack_tables(index, weights, dst_h, dst_w, hy_k,
                                         hc_k, wy_k);
  const Tail tl = banded::unpack_tail(tail);
  const int vec = aligned16(src) && src_w % 16 == 0 &&
                  batch_stride % 16 == 0 && row_stride % 16 == 0;
  const cudaError_t e =
      allow_smem(nv12_grouped_kernel, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((dst_h + kGroupRows - 1) / kGroupRows, batch);
  nv12_grouped_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), batch_stride, row_stride, vec, t, tl,
      g, static_cast<const T*>(a_blocks), reinterpret_cast<const int4*>(starts),
      luma_rows, chroma_rows, k_pad, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
