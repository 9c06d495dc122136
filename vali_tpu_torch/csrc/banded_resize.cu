// Banded separable resize for Hopper (sm_90a), streaming source rows.
//
// Replaces three TPU kernels of vali_tpu/ops/pallas_fused.py, which are one
// algorithm over source lanes of stride C:
//   - pallas_plane_resize  (planes [B, H, W], C = 1)
//   - pallas_packed_resize (packed RGB [B, H, W*3], C = 3: output lane
//                           C*p + c reads input lanes C*q + c only)
//   - pallas_nv12_resize   (NV12 / P010 / P012: luma with C = 1, then the
//                           interleaved UV rows at row H with C = 2 on the
//                           half grid, both into one [B, DH*3/2, DW] tensor)
// Samples are uint8, uint16 or float32; the output has the input's type.
//
// What bounds it on this card: 64 x 1080p RGB -> 224 moves 408 MB for
// ~2.9 G FMAs and 16 x 4K NV12 -> 1080p 249 MB for ~1.2 G, far under the
// H100's ~295 FLOP/byte ridge: bytes bound it. The earlier design of this
// file (8-row strips; every source row of a strip added into all 8 rows,
// zero weights included; one dependent 4-byte load a row; each W tap a
// global weight load) ran 2.2-5.2x the FMAs the bands need and sat at ~8x
// the byte bound. This design:
//
// One block: (frame, tile of tile_w output pixels, strip of strip_rows
// output rows). It walks its strip top to bottom in stages of stage_rows
// output rows, with one barrier per stage.
//   - Ring: the source rows of the tile's window (its start rounded down
//     to 16 bytes) pass through a ring of ring_rows rows in shared memory.
//     Each row is fetched from device memory once per block, by 16-byte
//     cp.async copies (element loads for views whose rows are not 16-byte
//     aligned), kLookahead stages ahead of the stage being summed, one
//     commit group a stage: a fetch takes ~4 us under load, about a stage
//     of work. ops/banded.py ring_rows sizes the ring and refuses bands
//     that do not slide down the image.
//   - H pass: output row r sums h_w[r][k] * x[h_start[r] + k] for
//     k < h_count[r] from the ring: its own band only, 16 bytes of lanes a
//     thread, fp32 fmaf from 0.0f in ascending k, rounded once to the
//     compute type (bf16 or fp32: the TPU kernels' cast point). These are
//     exactly the non-zero FMAs of the earlier design in the same order
//     (fmaf(0, x, acc) leaves acc's bits unchanged for finite x), so no
//     output bit moved. Samples are converted on each use (uint8 and
//     uint16 by a byte permute into 2^23 + x and a subtraction, both
//     exact); the ring stays in the sample type, which keeps it small
//     enough for two or more blocks an SM.
//   - W pass: the stage's H rows, double-buffered in shared memory, are
//     resampled one stage behind the H pass in the same barrier interval,
//     on the threads the H pass leaves idle first. A thread takes one
//     output lane over kRowBlock rows: the same column taps, so one weight
//     load (the tile's column weights are staged once per block) feeds
//     kRowBlock independent fp32 chains, ascending taps from 0.0f; then
//     integers round half to even and clamp.
// The tile, stage height, ring depth and strip height come from the host
// (ops/banded.py stream_geometry: the estimated fastest block that fits,
// for the batch at hand). Tensor cores are not used: their sums run in
// another order and would move bits, and uint16 / float32 need fp32.
//
// Tables (ops/banded.py stream_resize_tables, from resize_weights): per
// output row or column the first source index, the tap count and the
// weights, padded to the largest tap count and already rounded to the
// compute type; column weights transposed. A band lies inside its image,
// so the kernel never reads outside it: no pad rows, and padded or strided
// batches are accepted.
//
// Each launcher returns cudaGetLastError() after its launches, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <climits>

#include "banded_common.cuh"

// Measuring knob of the A/B lab (vali_tpu_torch/lab/resize_ab.py
// --knockouts), 0 in the product build: bit 1 skips the W pass, bit 2 the
// H pass (3: the ring fill alone).
#ifndef BANDED_RESIZE_KNOCKOUT
#define BANDED_RESIZE_KNOCKOUT 0
#endif

namespace {

using banded::Mid;

constexpr int kThreads = 256;
constexpr int kRowBlock = 4;   // W-pass output rows per thread: one weight
                               // load serves kRowBlock independent chains
constexpr int kLookahead = 2;  // stages fetched ahead of the one summed

// exact float of byte or half-word `sel` of `w`: 2^23 + x, less 2^23
__device__ __forceinline__ float lane_u8(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | sel)) -
         8388608.0f;
}
__device__ __forceinline__ float lane_u16(unsigned w, unsigned hi) {
  return __uint_as_float(
             __byte_perm(w, 0x4B000000u, hi ? 0x7432u : 0x7410u)) -
         8388608.0f;
}

// the 16 / sizeof(T) lanes of 16 staged bytes as exact floats
template <typename T> struct Sample;
template <> struct Sample<uint8_t> {
  static __device__ __forceinline__ void get16(uint4 q, float* x) {
    const unsigned v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = lane_u8(v[i / 4], i % 4);
  }
  static __device__ __forceinline__ void store(uint8_t* p, float x) {
    *p = static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
  }
};
template <> struct Sample<uint16_t> {
  static __device__ __forceinline__ void get16(uint4 q, float* x) {
    const unsigned v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = lane_u16(v[i / 2], i % 2);
  }
  static __device__ __forceinline__ void store(uint16_t* p, float x) {
    *p = static_cast<uint16_t>(fminf(fmaxf(rintf(x), 0.0f), 65535.0f));
  }
};
template <> struct Sample<float> {
  static __device__ __forceinline__ void get16(uint4 q, float* x) {
    x[0] = __uint_as_float(q.x);
    x[1] = __uint_as_float(q.y);
    x[2] = __uint_as_float(q.z);
    x[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

// 16 bytes of H-pass values in the compute type
__device__ __forceinline__ uint4 pack16(const float* x, float) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack16(const float* x, __nv_bfloat16) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kLookahead - 1 groups are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLookahead - 1)
               : "memory");
}

// Band tables of one image and the block geometry (ops/banded.py
// StreamTables).
struct Bands {
  const int* h_start; const int* h_count; const float* h_w; int h_k;
  const int* w_start; const int* w_count; const float* w_w;  // [k][dst_w]
  int w_k;
  int tile_w;      // output pixels per block tile
  int pitch;       // lanes of a ring row (the widest window, 16-byte units)
  int stage_rows;  // output rows summed per stage
  int ring_rows;   // source rows the ring holds
  int strip_rows;  // output rows per block, a multiple of stage_rows
};

// Geometry of one image: sizes in pixels, strides in elements.
struct Image {
  int src_h, src_w, dst_h, dst_w;
  long long in_bs, in_rs, out_bs, out_rs;
};

// Column weights of one tile pixel in shared memory: w_k rounded up to
// odd, so that neighbouring pixels' weights fall in different banks.
__host__ __device__ inline int w_pitch(int w_k) { return w_k | 1; }

// Shared memory of one block (ops/banded.py stream_smem).
template <typename T, bool F32>
size_t smem_bytes(const Bands& bd) {
  return static_cast<size_t>(bd.ring_rows) * bd.pitch * sizeof(T) +
         2 * static_cast<size_t>(bd.stage_rows) * bd.pitch *
             sizeof(typename Mid<F32>::T) +
         static_cast<size_t>(bd.tile_w) * (4 * w_pitch(bd.w_k) + 8);
}

template <typename T, bool F32, int C>
__global__ void __launch_bounds__(kThreads, 2)
banded_resize_kernel(const T* __restrict__ src, T* __restrict__ out,
                     Bands bd, Image im) {
  using M = Mid<F32>;
  using MT = typename M::T;
  constexpr int V = 16 / sizeof(T);  // lanes of one 16-byte item
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [ring_rows][pitch]
  MT* mid = reinterpret_cast<MT*>(        // [2][stage_rows][pitch]
      smem + static_cast<size_t>(bd.ring_rows) * bd.pitch * sizeof(T));
  const int wkp = w_pitch(bd.w_k);
  float* wcol = reinterpret_cast<float*>(  // [tile_w][wkp]
      mid + 2 * bd.stage_rows * bd.pitch);
  int* wofs = reinterpret_cast<int*>(wcol + wkp * bd.tile_w);  // [tile_w]
  int* wcnt = wofs + bd.tile_w;                                // [tile_w]
  __shared__ int s_lo, s_hi;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * bd.tile_w;
  const int cols = min(bd.tile_w, im.dst_w - p0);
  const int o0 = blockIdx.y * bd.strip_rows;
  const int o1 = min(o0 + bd.strip_rows, im.dst_h);
  const int G = bd.stage_rows, D = bd.ring_rows, pitch = bd.pitch;

  // ---- the tile's column tables and source window ----------------------
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  for (int j = tid; j < cols; j += kThreads) {
    const int s = __ldg(bd.w_start + p0 + j);
    const int n = __ldg(bd.w_count + p0 + j);
    atomicMin(&s_lo, s);
    atomicMax(&s_hi, s + n);
    wcnt[j] = n;
    for (int k = 0; k < bd.w_k; ++k)
      wcol[j * wkp + k] =
          __ldg(bd.w_w + static_cast<long long>(k) * im.dst_w + p0 + j);
  }
  __syncthreads();
  const int lane0 = s_lo * C / V * V;  // window start, 16-byte aligned
  const int nl = s_hi * C - lane0;     // window lanes, <= pitch
  const int nv = (nl + V - 1) / V;     // 16-byte items of a row
  for (int j = tid; j < cols; j += kThreads)
    wofs[j] = __ldg(bd.w_start + p0 + j) * C - lane0;

  // ---- ring fill: source rows [r0, r1) into slots row % D --------------
  const T* base = src + static_cast<long long>(b) * im.in_bs + lane0;
  const int avail = im.src_w * C - lane0;  // lanes of a row from lane0 on
  const bool vec = (reinterpret_cast<uintptr_t>(base) & 15u) == 0 &&
                   (im.in_rs * static_cast<long long>(sizeof(T))) % 16 == 0;
  auto fetch = [&](int r0, int r1) {
    if (vec) {
      for (int i = tid; i < (r1 - r0) * nv; i += kThreads) {
        const int row = r0 + i / nv;
        const int l = (i % nv) * V;
        const int bytes = max(0, min(V, avail - l)) * static_cast<int>(
                                                          sizeof(T));
        cp_async16(ring + (row % D) * pitch + l,
                   base + static_cast<long long>(row) * im.in_rs +
                       (bytes > 0 ? l : 0),
                   bytes);
      }
    } else {
      for (int i = tid; i < (r1 - r0) * nl; i += kThreads) {
        const int row = r0 + i / nl;
        const int l = i % nl;
        ring[(row % D) * pitch + l] =
            __ldg(base + static_cast<long long>(row) * im.in_rs + l);
      }
    }
  };
  // source rows [lo, hi] of stage s (hi < lo: none)
  auto stage_band = [&](int s, int& lo, int& hi) {
    lo = INT_MAX;
    hi = -1;
    for (int g = 0; g < G; ++g) {
      const int r = o0 + s * G + g;
      if (r >= o1) break;
      const int n = __ldg(bd.h_count + r);
      if (n > 0) {
        const int s0 = __ldg(bd.h_start + r);
        lo = min(lo, s0);
        hi = max(hi, s0 + n - 1);
      }
    }
  };

  const int stages = (o1 - o0 + G - 1) / G;
  int fetched = -1;  // the highest source row fetched so far
  // the rows of stage s that are not in the ring yet; they overwrite only
  // rows below the band of the stage kLookahead earlier (ring_rows covers
  // kLookahead + 1 stages). One commit group per stage, empty or not.
  auto fetch_stage = [&](int s) {
    int lo = INT_MAX, hi = -1;
    if (s < stages) stage_band(s, lo, hi);
    const int r0 = max(lo, fetched + 1);
    if (hi >= r0) fetch(r0, hi + 1);
    fetched = max(fetched, hi);
    cp_async_commit();
  };
  for (int s = 0; s < kLookahead; ++s) fetch_stage(s);
  T* ob = out + static_cast<long long>(b) * im.out_bs +
          static_cast<long long>(p0) * C;
  const int olanes = cols * C;

  for (int s = 0; s <= stages; ++s) {
    cp_async_wait_stage();
    __syncthreads();  // stage s's rows landed; stage s - 1 summed
    fetch_stage(s + kLookahead);

    // ---- H pass of stage s: each output row over its own band ----------
    if (s < stages && !(BANDED_RESIZE_KNOCKOUT & 2)) {
      const int r_base = o0 + s * G;
      const int rows = min(G, o1 - r_base);
      MT* m = mid + (s & 1) * G * pitch;
      for (int i = tid; i < rows * nv; i += kThreads) {
        const int g = i / nv;
        const int v = i - g * nv;
        const int r = r_base + g;
        const int n = __ldg(bd.h_count + r);
        const float* w = bd.h_w + static_cast<long long>(r) * bd.h_k;
        const T* col = ring + v * V;
        int slot = n > 0 ? __ldg(bd.h_start + r) % D : 0;
        float acc[V];
#pragma unroll
        for (int l = 0; l < V; ++l) acc[l] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          float x[V];
          Sample<T>::get16(*reinterpret_cast<const uint4*>(col + slot * pitch),
                           x);
          const float wk = __ldg(w + k);
#pragma unroll
          for (int l = 0; l < V; ++l) acc[l] = fmaf(wk, x[l], acc[l]);
          slot = slot + 1 == D ? 0 : slot + 1;
        }
        uint4* dst = reinterpret_cast<uint4*>(m + g * pitch + v * V);
#pragma unroll
        for (int l = 0; l < V; l += 16 / sizeof(MT))
          dst[l / (16 / sizeof(MT))] = pack16(acc + l, MT());
      }
    }

    // ---- W pass of stage s - 1 and quantise ----------------------------
    // one output lane over kRowBlock rows: the same taps and weights, so
    // one weight load feeds kRowBlock independent chains. Items are dealt
    // from the last thread down, to the threads the H pass left idle.
    if (s > 0 && !(BANDED_RESIZE_KNOCKOUT & 1)) {
      const int r_base = o0 + (s - 1) * G;
      const int rows = min(G, o1 - r_base);
      const MT* m = mid + ((s - 1) & 1) * G * pitch;
      T* orow = ob + static_cast<long long>(r_base) * im.out_rs;
      const int items = (rows + kRowBlock - 1) / kRowBlock * olanes;
      for (int i = kThreads - 1 - tid; i < items; i += kThreads) {
        const int g0 = i / olanes * kRowBlock;
        const int j = i - g0 / kRowBlock * olanes;
        const int q = j / C;
        const int n = wcnt[q];
        const float* wq = wcol + q * wkp;
        const MT* mj = m + wofs[q] + (j - q * C);
        const MT* mu[kRowBlock];
        float acc[kRowBlock];
#pragma unroll
        for (int u = 0; u < kRowBlock; ++u) {
          mu[u] = mj + min(g0 + u, rows - 1) * pitch;  // past the strip:
          acc[u] = 0.0f;                                // computed, not kept
        }
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float wk = wq[k];
#pragma unroll
          for (int u = 0; u < kRowBlock; ++u)
            acc[u] = fmaf(wk, M::get(mu[u][k * C]), acc[u]);
        }
#pragma unroll
        for (int u = 0; u < kRowBlock; ++u)
          if (g0 + u < rows)
            Sample<T>::store(
                orow + static_cast<long long>(g0 + u) * im.out_rs + j,
                acc[u]);
      }
    }
  }
}

template <typename T, bool F32, int C>
cudaError_t launch_typed(const void* src, void* out, const Bands& bd,
                         const Image& im, int batch, cudaStream_t stream) {
  if (bd.pitch % (16 / static_cast<int>(sizeof(T))) != 0)
    return cudaErrorInvalidValue;
  auto kern = banded_resize_kernel<T, F32, C>;
  const size_t smem = smem_bytes<T, F32>(bd);
  cudaError_t e = banded::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((im.dst_w + bd.tile_w - 1) / bd.tile_w,
                  (im.dst_h + bd.strip_rows - 1) / bd.strip_rows, batch);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(src),
                                         static_cast<T*>(out), bd, im);
  return cudaGetLastError();
}

// in_kind 0 = uint8 (bf16 or fp32 compute), 1 = uint16, 2 = float32 (fp32
// compute only).
template <int C>
cudaError_t launch(int in_kind, int f32, const void* src, void* out,
                   const Bands& bd, const Image& im, int batch,
                   cudaStream_t s) {
  if (batch <= 0 || im.dst_h <= 0 || im.dst_w <= 0) return cudaSuccess;
  if (im.src_h <= 0 || im.src_w <= 0 || bd.tile_w <= 0 || bd.pitch <= 0 ||
      bd.stage_rows <= 0 || bd.ring_rows <= 0 || bd.strip_rows <= 0 ||
      bd.strip_rows % bd.stage_rows != 0)
    return cudaErrorInvalidValue;
  switch (in_kind) {
    case 0:
      return f32 ? launch_typed<uint8_t, true, C>(src, out, bd, im, batch, s)
                 : launch_typed<uint8_t, false, C>(src, out, bd, im, batch,
                                                   s);
    case 1:
      if (!f32) return cudaErrorInvalidValue;
      return launch_typed<uint16_t, true, C>(src, out, bd, im, batch, s);
    case 2:
      if (!f32) return cudaErrorInvalidValue;
      return launch_typed<float, true, C>(src, out, bd, im, batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

Bands bands(int dst_h, int dst_w, const int* index, const float* weights,
            int h_k, int w_k, int tile_w, int pitch, int stage_rows,
            int ring_rows, int strip_rows) {
  Bands bd;
  bd.h_start = index;
  bd.h_count = index + dst_h;
  bd.w_start = index + 2 * dst_h;
  bd.w_count = bd.w_start + dst_w;
  bd.h_w = weights;
  bd.h_k = h_k;
  bd.w_w = weights + static_cast<long long>(dst_h) * h_k;
  bd.w_k = w_k;
  bd.tile_w = tile_w;
  bd.pitch = pitch;
  bd.stage_rows = stage_rows;
  bd.ring_rows = ring_rows;
  bd.strip_rows = strip_rows;
  return bd;
}

int elem_bytes(int in_kind) { return in_kind == 0 ? 1 : in_kind == 1 ? 2 : 4; }

}  // namespace

extern "C" {

// Planes: `src` is frame 0 of [B, >= src_h, src_w] samples with the given
// batch and row strides (elements); `out` is frame 0 of [B, dst_h, dst_w]
// with its own strides. Tables and geometry as ops/banded.py
// StreamTables.args(strip_rows).
int plane_resize_launch(const void* src, int in_kind, long long batch_stride,
                        long long row_stride, int batch, int src_h,
                        int src_w, int dst_h, int dst_w, const int* index,
                        const float* weights, int h_k, int w_k, int tile_w,
                        int pitch, int stage_rows, int ring_rows,
                        int strip_rows, int f32_compute, void* out,
                        long long out_batch_stride, long long out_row_stride,
                        void* stream) {
  const Image im{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                 out_batch_stride, out_row_stride};
  return static_cast<int>(launch<1>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, index, weights, h_k, w_k, tile_w, pitch,
            stage_rows, ring_rows, strip_rows),
      im, batch, static_cast<cudaStream_t>(stream)));
}

// Packed 3-channel samples: `src` is frame 0 of [B, >= src_h, src_w * 3],
// `out` of [B, dst_h, dst_w * 3]; widths are in pixels, strides in
// elements. Everything else as plane_resize_launch.
int packed_resize_launch(const void* src, int in_kind,
                         long long batch_stride, long long row_stride,
                         int batch, int src_h, int src_w, int dst_h,
                         int dst_w, const int* index, const float* weights,
                         int h_k, int w_k, int tile_w, int pitch,
                         int stage_rows, int ring_rows, int strip_rows,
                         int f32_compute, void* out,
                         long long out_batch_stride,
                         long long out_row_stride, void* stream) {
  const Image im{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                 out_batch_stride, out_row_stride};
  return static_cast<int>(launch<3>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, index, weights, h_k, w_k, tile_w, pitch,
            stage_rows, ring_rows, strip_rows),
      im, batch, static_cast<cudaStream_t>(stream)));
}

// NV12 / P010 / P012: `src` is frame 0 of [B, >= src_h*3/2, src_w] with
// the given strides (elements), in_kind 0 = uint8, 1 = uint16. `out` is a
// contiguous [B, dst_h*3/2, dst_w] tensor of the same type: luma rows
// first, then the interleaved UV rows. The first table set resizes luma
// (src_h x src_w -> dst_h x dst_w), the second the chroma pairs on the
// half grid (src_h/2 x src_w/2 -> dst_h/2 x dst_w/2). Two launches.
int nv12_resize_launch(const void* src, int in_kind, long long batch_stride,
                       long long row_stride, int batch, int src_h, int src_w,
                       int dst_h, int dst_w, const int* y_index,
                       const float* y_weights, int y_h_k, int y_w_k,
                       int y_tile_w, int y_pitch, int y_stage_rows,
                       int y_ring_rows, int y_strip_rows,
                       const int* c_index, const float* c_weights,
                       int c_h_k, int c_w_k, int c_tile_w, int c_pitch,
                       int c_stage_rows, int c_ring_rows, int c_strip_rows,
                       int f32_compute, void* out, void* stream) {
  if ((src_h | src_w | dst_h | dst_w) & 1 || in_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long out_bs = static_cast<long long>(dst_h) * 3 / 2 * dst_w;
  const Image luma{src_h, src_w, dst_h, dst_w, batch_stride, row_stride,
                   out_bs, dst_w};
  cudaError_t e = launch<1>(
      in_kind, f32_compute, src, out,
      bands(dst_h, dst_w, y_index, y_weights, y_h_k, y_w_k, y_tile_w,
            y_pitch, y_stage_rows, y_ring_rows, y_strip_rows),
      luma, batch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int eb = elem_bytes(in_kind);
  const void* c_src = static_cast<const char*>(src) +
                      static_cast<long long>(src_h) * row_stride * eb;
  void* c_out = static_cast<char*>(out) +
                static_cast<long long>(dst_h) * dst_w * eb;
  const Image chroma{src_h / 2, src_w / 2, dst_h / 2, dst_w / 2,
                     batch_stride, row_stride, out_bs, dst_w};
  return static_cast<int>(launch<2>(
      in_kind, f32_compute, c_src, c_out,
      bands(dst_h / 2, dst_w / 2, c_index, c_weights, c_h_k, c_w_k,
            c_tile_w, c_pitch, c_stage_rows, c_ring_rows, c_strip_rows),
      chroma, batch, s));
}

}  // extern "C"
