// Lab variant G of the banded NV12 preprocess kernel for Hopper (sm_90a):
// the resize passes as dense block-diagonal products on the tensor cores,
// wgmma fed by an asynchronous staging ring.
//
// Replaces grouped_kernel of bench_kernel_variants.py: on the TPU one
// M = 128 product runs 2 luma + 2 chroma 32-row tiles over their stacked
// windows (the block-diagonal zeros spent as real FLOPs to fill the matrix
// unit), and the W pass is a dense product over all source columns.
//
// What bounds it on this card: the function is the product kernel's, so
// its bytes bound it (199 MB in, 9.6 MB out per 64 x 1080p -> 224 batch:
// 0.062 ms at 3.35 TB/s). The dense H products are ~10.6 GFLOP a batch
// (4.4x the banded FMAs), ~0.011 ms at the data sheet's 989 TFLOP/s bf16:
// the question this variant answers is whether the tensor cores, zero tax
// included, carry the resize passes faster than the product kernel's
// banded FMA loops on the CUDA cores.
//
// Design. One block per (frame, strip of 8 output rows): 28 blocks per
// 1080p frame at 224 rows, two warpgroups of 128 threads, two blocks an SM.
// The host builds, once per geometry (ops/banded.py grouped_tables), the
// strip's luma window of ly rows and chroma window of lc interleaved chroma
// rows (both inside their planes) and B = [K, 16] bf16, K = ly + lc padded
// to a multiple of 16 (95 -> 96 at 1080p -> 224): columns 0-7 the luma
// rows' weights over the luma window, 8-15 the chroma rows' over the chroma
// window, zeros elsewhere, laid out as wgmma's K-major core matrices.
//   - H pass, the transposed product: D [64 frame columns, 16 rows] =
//     A [64 columns, K] x B, wgmma.mma_async m64n16k16 bf16 -> fp32 with A
//     from registers. (With output rows as wgmma's 64-row M, a block would
//     hold 64 H rows of 1920 bf16, 246 KB, over the 227 KB a block may
//     have; with frame columns as M a strip's H rows take 69 KB and two
//     blocks share an SM.) The kernel is compiled per K / 16 (NK), so that
//     no wgmma sits under a branch: ptxas serializes wgmmas whose A
//     registers are written under one. The stacked window streams through a
//     ring of kStages stages of [K, 128 columns] raw bytes in shared memory by
//     16-byte cp.async copies issued kStages - 1 stages ahead (element
//     loads for views whose rows are not 16-byte aligned), one commit
//     group and one barrier a stage: the copies of stage s + 2 fly while
//     stage s is converted and multiplied. Each warpgroup takes 64 columns
//     of a stage. A thread builds its A fragments from the raw bytes: row
//     m of the fragment is frame column 2 (m mod 8) + (m / 8 mod 2) of its
//     warp's 16, so one 16-bit load brings both of its columns of a window
//     row, and a byte permute into 2^23 + x less 2^23 makes each sample an
//     exact float, packed to bf16 (exact: 0..255). The raw rows' 16-byte
//     chunks are XOR-swizzled by row pair so that those loads do not
//     conflict. No bf16 copy of the window is written to shared memory.
//     The fp32 sums round to bf16 (the TPU kernels' cast point) into the
//     H rows: the strip's 8 luma rows over the full width and its 8 U and
//     8 V rows (the chroma sums deinterleaved as they are stored), each
//     kept as 8 x 8 core matrices, column groups 144 bytes apart (16 bytes
//     of padding spread the banks).
//   - W pass, by the build knob NV12_GROUPED_WPASS: `mma` (the notebook's
//     MXU W pass) runs, for each tile of 64 output columns, D [64 columns,
//     8 luma rows] = A [64, K] x the luma H rows (wgmma m64n8k16) and D
//     [64 columns, 8 U | 8 V rows] = A [64, K] x the U and V rows (m64n16k16:
//     one A of chroma weights serves both channels), B read from the H
//     rows in place. A holds the bf16 W weights of the tile over its band
//     of source columns only (ops/banded.py grouped_w_tables), stored in
//     register-fragment order so that a thread's share of a k-step is one
//     16-byte word; fragment row m is output column m of the tile in both
//     products, so every thread ends with Y, U and V of the same four
//     pixels in its registers. `banded` runs the product kernel's banded W
//     loop on the CUDA cores over the same H rows. The CSC, round and clip
//     are the product's.
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order and precision, so a sum may
// round apart from the banded FMA chain. The lab holds G to the kernels'
// envelope against nv12_preprocess and counts its differing samples.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "banded_preprocess.cuh"
#include "wgmma_common.cuh"

// Build knobs of the A/B lab (vali_tpu_torch/lab/grouped_ab.py), at their
// defaults here. WPASS: the W pass, `mma` (the faster, measured in PERF.md)
// or `banded`. KNOCKOUT: bit 1 skips the W pass, bit 2 the H pass's
// conversion and products (3: the staging ring alone).
#define NV12_GROUPED_WPASS_banded 0
#define NV12_GROUPED_WPASS_mma 1
#ifndef NV12_GROUPED_WPASS
#define NV12_GROUPED_WPASS mma
#endif
#define NV12_GROUPED_CAT_(a, b) a##b
#define NV12_GROUPED_CAT(a, b) NV12_GROUPED_CAT_(a, b)
#ifndef NV12_GROUPED_KNOCKOUT
#define NV12_GROUPED_KNOCKOUT 0
#endif

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::csc_store;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tables;
using banded::Tail;
using banded::tab;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::kStageCols;
using wgmma::pack_bf16;

constexpr bool kWpassMma =
    NV12_GROUPED_CAT(NV12_GROUPED_WPASS_, NV12_GROUPED_WPASS) == 1;
constexpr int kKnockout = NV12_GROUPED_KNOCKOUT;

constexpr int kThreads = 256;    // two warpgroups
constexpr int kStrip = 8;        // output rows of a strip, in each plane
constexpr int kN = 16;           // N of the H product: 8 luma | 8 chroma
constexpr int kStages = 3;       // ring depth: two stages in flight
constexpr int kMaxKSteps = 16;   // K <= 256 window rows
constexpr int kGroupBytes = 144; // one 8-column group of 8 H rows, padded

// Byte offset of H element (row r, column c) in the tiled H rows.
__device__ __forceinline__ int h_off(int r, int c) {
  return wgmma::h_off(r, c, kGroupBytes);
}

__device__ __forceinline__ float h_at(const unsigned char* h, int r,
                                      int c) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(h + h_off(r, c)));
}

// Frame row of row k of the strip's stacked window.
__device__ __forceinline__ int window_row(int k, int ly, int2 st,
                                          int src_h) {
  return k < ly ? st.x + k : src_h + st.y + k - ly;
}

// The product kernel's banded W pass over the tiled H rows: one thread an
// (output row, output column) item, the taps in ascending order.
__device__ __forceinline__ void wpass_banded(const unsigned char* hy,
                                             const unsigned char* hu,
                                             const unsigned char* hv,
                                             int rows, int o0,
                                             const Geometry& g,
                                             const Tables& t,
                                             const Tail& tl, uint8_t* ob) {
  const int DW = g.dst_w;
  const long long plane_sz = static_cast<long long>(g.dst_h) * DW;
  for (int item = threadIdx.x; item < rows * DW; item += kThreads) {
    const int r = item / DW;
    const int p = item - r * DW;
    float ya = 0.0f;
    const int ys = tab<false>(t.wy_start + p), yn = tab<false>(t.wy_count + p);
    for (int k = 0; k < yn; ++k)
      ya = fmaf(tab<false>(t.wy_w + k * DW + p), h_at(hy, r, ys + k), ya);
    float ua = 0.0f, va = 0.0f;
    const int cs = tab<false>(t.wc_start + p), cn = tab<false>(t.wc_count + p);
    for (int k = 0; k < cn; ++k) {
      const float wk = tab<false>(t.wc_w + k * DW + p);
      ua = fmaf(wk, h_at(hu, r, cs + k), ua);
      va = fmaf(wk, h_at(hv, r, cs + k), va);
    }
    csc_store(ob, plane_sz, static_cast<long long>(o0 + r) * DW + p, ya, ua,
              va, tl);
  }
}

// NK = k_pad / 16, the H pass's k-steps: compiled per count, so that no
// wgmma of the H pass sits under a branch (ptxas would serialize them).
template <int NK>
__global__ void __launch_bounds__(kThreads, 2)
nv12_grouped_kernel(const uint8_t* __restrict__ src, long long bs,
                    long long rs, int vec, Tables t, Tail tl, Geometry g,
                    const uint4* __restrict__ b_tiles,
                    const int2* __restrict__ starts, int ly, int lc, int kp,
                    const int* __restrict__ w_heads,
                    const uint4* __restrict__ w_frags,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = g.src_w, CW = W / 2;  // luma, chroma samples a row
  const int wp = (W + 15) & ~15;      // H columns; [W, wp) are zeros
  const int cwp = (CW + 15) & ~15;    // U, V columns; [CW, cwp) zeros
  unsigned char* hy = smem;                           // luma H rows
  unsigned char* hu = hy + wp / 8 * kGroupBytes;      // U H rows
  unsigned char* hv = hu + cwp / 8 * kGroupBytes;     // V H rows
  unsigned char* bw = hv + cwp / 8 * kGroupBytes;     // B: [K, 16]
  unsigned char* ring = bw + kp * kN * 2;  // kStages x [kp, 128] bytes
  const int tid = threadIdx.x;
  const int strip = blockIdx.x;
  const int o0 = strip * kStrip;
  const int rows = min(kStrip, g.dst_h - o0);
  const uint8_t* frame = src + blockIdx.y * bs;
  const int2 st = __ldg(starts + strip);
  const int kw = ly + lc;  // window rows; rows kw .. kp - 1 weigh 0
  const int nstages = (W + kStageCols - 1) / kStageCols;
  const auto row_of = [=](int k) { return window_row(k, ly, st, g.src_h); };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages)
      wgmma::issue_stage<kThreads>(ring + s * kp * kStageCols, frame, rs,
                                   s * kStageCols, kw, W, vec, row_of);
    else
      cp_async_commit();
  }
  const uint4* bsrc = b_tiles + static_cast<long long>(strip) * kp * kN / 8;
  for (int i = tid; i < kp * kN / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  const int zy = kStrip * (wp - W), zc = kStrip * (cwp - CW);
  for (int i = tid; i < zy + 2 * zc; i += kThreads) {
    unsigned char* h = i < zy ? hy : i < zy + zc ? hu : hv;
    const int j = i < zy ? i : (i - zy) % zc;
    const int n = i < zy ? wp - W : cwp - CW;
    *reinterpret_cast<__nv_bfloat16*>(
        h + h_off(j / n, (i < zy ? W : CW) + j % n)) =
        __float2bfloat16_rn(0.0f);
  }
  fence_proxy_async();  // B and the zero columns, read by wgmma

  const int wg = tid >> 7;                  // warpgroup: 64 stage columns
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * wg + 16 * warp + 2 * gq;  // the thread's 2 columns
  const uint64_t bdesc = desc(bw, 128, 256);

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; slot (s - 1) % kStages is free
    if (s + kStages - 1 < nstages)
      wgmma::issue_stage<kThreads>(
          ring + (s + kStages - 1) % kStages * kp * kStageCols, frame, rs,
          (s + kStages - 1) * kStageCols, kw, W, vec, row_of);
    else
      cp_async_commit();
    if (kKnockout & 2) continue;
    const unsigned char* slot = ring + s % kStages * kp * kStageCols;
    unsigned a[NK][4];
    wgmma::ring_fragments<NK>(a, slot, ccol, tq);
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = 0.0f;
    wgmma::fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma::mma<16>(d, make_uint4(a[ks][0], a[ks][1], a[ks][2], a[ks][3]),
                     bdesc + ((ks * 512) >> 4));
    wgmma::commit();
    wgmma::wait_all();
    // d[0..3]: luma rows 2 tq, 2 tq + 1 of columns c, c + 1; d[4..7]
    // the same chroma rows, U and V of chroma column c / 2
    const int c = s * kStageCols + ccol;
    if (c < W) {  // W is even: c + 1 < W too
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<unsigned*>(hy + h_off(2 * tq + e, c)) =
            pack_bf16(d[e], d[2 + e]);
        *reinterpret_cast<__nv_bfloat16*>(hu + h_off(2 * tq + e, c / 2)) =
            __float2bfloat16_rn(d[4 + e]);
        *reinterpret_cast<__nv_bfloat16*>(hv + h_off(2 * tq + e, c / 2)) =
            __float2bfloat16_rn(d[6 + e]);
      }
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the H rows, read by wgmma in the W pass
  __syncthreads();
  if (kKnockout & 1) return;

  uint8_t* ob = out + static_cast<long long>(blockIdx.y) * 3 * g.dst_h *
                          g.dst_w;
  if constexpr (!kWpassMma) {
    wpass_banded(hy, hu, hv, rows, o0, g, t, tl, ob);
  } else {
    const int DW = g.dst_w;
    const long long plane_sz = static_cast<long long>(g.dst_h) * DW;
    const int wt = tid & 127;
    const unsigned uv_sbo = static_cast<unsigned>(hv - hu);
    for (int tile = wg; tile < (DW + 63) / 64; tile += 2) {
      const int* hd = w_heads + 6 * tile;  // (first k-step, c0, nk) x 2
      float dy[4], dc[8];
      wgmma::wpass_product<8>(
          dy, w_frags + static_cast<long long>(hd[0]) * 128, hd[2], hy,
          hd[1], kGroupBytes, 0, wt);
      wgmma::wpass_product<16>(
          dc, w_frags + static_cast<long long>(hd[3]) * 128, hd[5], hu,
          hd[4], kGroupBytes, uv_sbo, wt);
      // pixel e: column p of the tile's fragment rows 16 warp + gq (+8),
      // row 2 tq (+1); Y from dy, U from dc[0..3], V from dc[4..7]
      const int pa = 64 * tile + 16 * warp + gq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pa + 8 * (e >> 1), r = 2 * tq + (e & 1);
        if (p < DW && r < rows)
          csc_store(ob, plane_sz, static_cast<long long>(o0 + r) * DW + p,
                    dy[e], dc[e], dc[4 + e], tl);
      }
    }
  }
}

// Shared memory of one block (bytes): the tiled luma, U and V H rows, B,
// and the ring (ops/banded.py grouped_smem_bytes).
long long smem_bytes(int src_w, int k_pad) {
  return ((src_w + 15) / 16 * 2 + 2LL * ((src_w / 2 + 15) / 16 * 2)) *
             kGroupBytes +
         2LL * k_pad * kN +
         static_cast<long long>(kStages) * k_pad * kStageCols;
}

template <int NK, typename... Args>
cudaError_t launch_nk(dim3 grid, size_t smem, cudaStream_t stream,
                      Args... args) {
  const cudaError_t e = allow_smem(nv12_grouped_kernel<NK>, smem);
  if (e != cudaSuccess) return e;
  nv12_grouped_kernel<NK><<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// G over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12 buffer
// with the given batch and row strides (bytes). Tables: the product's
// bf16 band tables (ops/banded.py device_tables; only the W tables are
// read, by the banded W pass); tail: the 18 floats of tail_params. b_tiles: [strips, k_pad, 16] bf16 on the device in
// wgmma core-matrix order, strips = ceil(dst_h / 8); starts: [strips, 2]
// int32 on the device, the first rows of the strip's luma window (of
// luma_rows rows) and chroma window (of chroma_rows interleaved chroma
// rows); k_pad a multiple of 16, at least luma_rows + chroma_rows and at
// most 256. w_heads: [ceil(dst_w / 64), 2, 3] int32 and w_frags:
// [k-steps, 128] 16-byte words on the device, the mma W pass's weights
// (ops/banded.py grouped_w_tables). out is a contiguous [batch, 3, dst_h,
// dst_w] uint8 tensor.
int nv12_grouped_launch(const void* src, long long batch_stride,
                        long long row_stride, int buf_rows, int batch,
                        int src_h, int src_w, int dst_h, int dst_w,
                        const int* index, const float* weights, int hy_k,
                        int hc_k, int wy_k, int wc_k, const float* tail,
                        const void* b_tiles, const int* starts,
                        int luma_rows, int chroma_rows, int k_pad,
                        const int* w_heads, const void* w_frags, void* out,
                        void* stream) {
  (void)wc_k;
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (src_w <= 0 || (src_w & 1) || buf_rows < src_h * 3 / 2 ||
      luma_rows < 1 || luma_rows > src_h || chroma_rows < 1 ||
      chroma_rows > src_h / 2 || k_pad % 16 != 0 ||
      k_pad < luma_rows + chroma_rows || k_pad > 16 * kMaxKSteps ||
      !aligned16(b_tiles) || !aligned16(w_frags) ||
      (reinterpret_cast<uintptr_t>(starts) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(src_w, k_pad);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = kStrip;
  const Tables t = banded::unpack_tables(index, weights, dst_h, dst_w, hy_k,
                                         hc_k, wy_k);
  const Tail tl = banded::unpack_tail(tail);
  const int vec = aligned16(src) && src_w % 16 == 0 &&
                  batch_stride % 16 == 0 && row_stride % 16 == 0;
  const dim3 grid((dst_h + kStrip - 1) / kStrip, batch);
  auto go = [&](auto nk) {
    return static_cast<int>(launch_nk<decltype(nk)::value>(
        grid, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream),
        static_cast<const uint8_t*>(src), batch_stride, row_stride, vec, t,
        tl, g, static_cast<const uint4*>(b_tiles),
        reinterpret_cast<const int2*>(starts), luma_rows, chroma_rows, k_pad,
        w_heads, static_cast<const uint4*>(w_frags),
        static_cast<uint8_t*>(out)));
  };
  switch (k_pad / 16) {
#define NV12_GROUPED_NK(n) \
  case n:                  \
    return go(std::integral_constant<int, n>());
    NV12_GROUPED_NK(1) NV12_GROUPED_NK(2) NV12_GROUPED_NK(3)
    NV12_GROUPED_NK(4) NV12_GROUPED_NK(5) NV12_GROUPED_NK(6)
    NV12_GROUPED_NK(7) NV12_GROUPED_NK(8) NV12_GROUPED_NK(9)
    NV12_GROUPED_NK(10) NV12_GROUPED_NK(11) NV12_GROUPED_NK(12)
    NV12_GROUPED_NK(13) NV12_GROUPED_NK(14) NV12_GROUPED_NK(15)
    NV12_GROUPED_NK(16)
#undef NV12_GROUPED_NK
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
