// Banded fused YUV -> RGB preprocess for Hopper (sm_90a), streaming source
// rows.
//
// Replaces the four TPU kernels of vali_tpu/ops/pallas_fused.py on the
// decode -> preprocess path:
//   - pallas_nv12_preprocess   (NV12 / P010 / P012: Y plane stacked on
//                               interleaved UV rows)
//   - pallas_yuv420_preprocess (planar I420, 8-bit or LSB-aligned 10-bit)
//   - pallas_yuv422_preprocess (planar 4:2:2, 8-bit: full-height,
//                               half-width U and V)
//   - pallas_yuv444_preprocess (planar 4:4:4, 8-bit: full-resolution U, V)
// All compute the same thing: a banded H pass over luma and chroma rows,
// a banded W pass, a 3x3 CSC, then round/clip to uint8 or scale (and
// optionally normalise) to float. They differ only in how chroma is
// addressed (the Layout template parameter), so one template serves all
// four. The host builds the chroma tables of each layout: 4:2:2 chroma
// rows use the luma row bands, 4:4:4 chroma uses both luma band sets.
//
// What bounds it on this card: one 64 x 1080p -> 224x224 batch reads
// 199 MB (4:2:0), 265 MB (4:2:2) or 398 MB (4:4:4) for 1.5-2.9 G FMAs,
// ~15 FLOP/byte, far under the H100's ~295 FLOP/byte ridge: bytes bound
// it (0.062 / 0.082 / 0.122 ms at 3.35 TB/s). The earlier design of this
// file (8-row strips over whole rows, one thread an (output row, 16
// columns) item) fetched and converted every source sample once per
// output row that reads it, about 6 times at 1080 -> 224, ran each W tap
// as a dependent chain with a global weight load, and kept its H and W
// passes apart across a barrier: 0.47 ms (4:2:0) to 1.01 ms (4:4:4), 7.5-8x
// its byte bound. This design, and what it does about each of those:
//
// One block: (frame, tile of tile_w output pixels, strip of strip_rows
// output rows). It walks its strip top to bottom in stages of stage_rows
// output rows, with one barrier per stage.
//   - Fetched once per block: the source rows of the tile's luma and
//     chroma windows (each start rounded down to 16 bytes) pass through a
//     ring of raw samples per plane in shared memory (one interleaved UV
//     plane for NV12, U and V otherwise; 4:2:0 chroma rows slide at half
//     the luma rate, so each plane has its own depth), by 16-byte cp.async
//     copies (element loads for views whose rows are not 16-byte aligned)
//     two stages ahead of the stage that reads them, one commit group a
//     stage. ops/banded.py ring_rows sizes the rings and refuses bands
//     that do not slide down the image. Strips are tall (32 to 224 rows),
//     so a row is fetched once where the earlier design read it ~6 times.
//   - Converted once per item, not once per use: an H item sums two
//     output rows (kHRows) over 16 bytes of lanes. It walks the source rows
//     of both rows' bands in ascending order, converts each 16-byte group
//     once (a byte permute into 2^23 + x less 2^23, exact) and adds it into
//     every row whose band covers it, in three branch-free segments (row 0
//     alone, both, row 1 alone: the bands start and end in order). Each row
//     still sums h_w[r][k] * x[h_start[r] + k] for k < h_count[r], fp32
//     fmaf from 0.0f in ascending k, rounded once to the compute type (bf16
//     or fp32, the TPU kernels' cast point): the earlier design's FMAs in
//     the same order, so no output bit moved. No zero-weight FMA runs.
//     Departures from the plan this replaced, each measured with the A/B
//     lab (PERF.md section 6): a convert-once ring of exact floats in shared
//     memory (bf16 for uint8, or float32) was 1.6-3x slower than converting
//     in registers, since each tap then re-reads 2-4x the bytes from shared
//     memory, and was removed; items of four rows spilled at the 128
//     registers of two blocks an SM, so an item sums one or two rows.
//   - W pass on row blocks with staged weights: the tile's column starts,
//     counts and weights are staged in shared memory once per block (each
//     pixel's weights padded to an odd count against bank conflicts). One
//     thread takes one output pixel over kRowBlock rows (4, or 2 for 4:4:4,
//     whose chroma has twice the column taps, and for uint16 samples): one
//     weight load feeds kRowBlock independent fp32 chains each for Y, U and
//     V, ascending taps from 0.0f. Then the CSC in fp32 without FMA
//     contraction and the quantise/normalise tail, written to
//     out[b, c, o, p].
//   - Overlap: the W pass of stage s - 1 runs in the same barrier interval
//     as the H pass of stage s, on the threads the H pass leaves idle
//     first (W items are dealt from the last thread down), and two blocks
//     share an SM. The knock-outs show they overlap in part only.
// The tile, stage height, ring depths and strip height come from the host
// (ops/banded.py stream_preprocess_tables: the estimated fastest block
// that fits with two blocks an SM, for the batch at hand). Tensor cores
// are not used: their sums run in another order and would move bits, and
// uint16 needs fp32.
//
// Tables (ops/banded.py device_tables): per output row or column the first
// source index, the tap count and the weights padded to the largest tap
// count, already rounded to the compute type; column weights transposed. A
// band lies inside its plane, so the kernel never reads outside a plane:
// no pad rows, and padded or strided batches are accepted.
//
// Each launcher returns cudaGetLastError() after its launch, runs on the
// caller's stream, and neither synchronises nor allocates. The frame and
// table descriptions and the output stores it shares with the tensor-core
// lab kernels are in banded_preprocess.cuh; this file takes its Tables,
// Tail and Out (and banded_common.cuh's Mid).

#include <climits>
#include <type_traits>

#include "banded_preprocess.cuh"

// Measuring knobs of the A/B lab (vali_tpu_torch/lab/preprocess_ab.py),
// at their product values here. KNOCKOUT (--knockouts): bit 1 skips the W
// pass, bit 2 the H pass (3: the ring fill alone).
#ifndef BANDED_PREPROCESS_KNOCKOUT
#define BANDED_PREPROCESS_KNOCKOUT 0
#endif
// Output rows an H item sums while it streams their bands' source rows
// (ops/banded.py PREPROCESS_H_ROWS, 1 or 2), and output rows a W item
// resamples (by default 2 for 4:4:4, whose chroma W taps are twice as
// many, and for uint16 samples, else 4: ops/banded.py preprocess_w_rows).
#ifndef BANDED_PREPROCESS_H_ROWS
#define BANDED_PREPROCESS_H_ROWS 2
#endif

namespace {

using banded::kI420;
using banded::kI422;
using banded::kI444;
using banded::kNV12;
using banded::Mid;
using banded::Out;
using banded::Tables;
using banded::Tail;

constexpr int kThreads = 256;
constexpr int kHRows = BANDED_PREPROCESS_H_ROWS;  // H-pass output rows a
                              // thread: each source sample converted once
                              // for all of them
// W-pass output rows a thread: one weight load serves this many
// independent chains
template <int L, typename T>
__host__ __device__ constexpr int w_rows() {
#ifdef BANDED_PREPROCESS_W_ROWS
  return BANDED_PREPROCESS_W_ROWS;
#else
  return L == kI444 || sizeof(T) == 2 ? 2 : 4;
#endif
}
constexpr int kAhead = 2;     // stages between the rows read and the
                              // newest fetched
static_assert(kHRows == 1 || kHRows == 2, "an H item sums one or two rows");

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

// The samples of 16 ring bytes (uint8 or uint16) as exact floats.
template <typename T> struct Lanes;
template <> struct Lanes<uint8_t> {
  static constexpr int kN = 16;
  static __device__ __forceinline__ void get(uint4 q, float* x) {
    const unsigned v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = lane_u8(v[i / 4], i % 4);
  }
};
template <> struct Lanes<uint16_t> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void get(uint4 q, float* x) {
    const unsigned v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = lane_u16(v[i / 2], i % 2);
  }
};
// N H-pass values in the compute type, stored as 16- or 8-byte words
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
template <int N>
__device__ __forceinline__ void store_mid(float* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_mid(__nv_bfloat16* dst,
                                          const float* x) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8)
      *reinterpret_cast<uint4*>(dst + i) =
          make_uint4(pack_bf16(x[i], x[i + 1]), pack_bf16(x[i + 2], x[i + 3]),
                     pack_bf16(x[i + 4], x[i + 5]),
                     pack_bf16(x[i + 6], x[i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<uint2*>(dst + i) =
          make_uint2(pack_bf16(x[i], x[i + 1]), pack_bf16(x[i + 2], x[i + 3]));
  }
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
// wait until at most kAhead - 1 groups are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// Block geometry (ops/banded.py PreprocessTables).
struct Block {
  int tile_w;      // output pixels per block tile
  int y_pitch;     // lanes of a luma ring row (16-byte multiple)
  int c_pitch;     // lanes of a chroma ring row, per chroma plane
  int stage_rows;  // output rows summed per stage
  int strip_rows;  // output rows per block, a multiple of stage_rows
  int y_ring, c_ring;  // source rows each ring holds
  int wy_k, wc_k;      // column tap counts (padded)
};

// One source plane: frame 0, strides in elements.
struct Src {
  const void* p;
  long long bs, rs;
};

struct Dims {
  int src_w, dst_h, dst_w;
  int cw;  // samples in one chroma plane row
};

// Column weights of one tile pixel in shared memory: taps rounded up to
// odd, so that neighbouring pixels' weights fall in different banks.
__host__ __device__ inline int w_pitch(int k) { return k | 1; }
__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory carve of one block (ops/banded.py preprocess_smem): byte
// offsets of the luma and chroma rings, the two stages of H rows, the
// tile's column tables and the strip's stage bands; off[5] is the total.
__host__ __device__ inline void carve(const Block& bk, int nc, int sb,
                                      int mb, size_t* off) {
  const size_t parts[5] = {
      static_cast<size_t>(bk.y_ring) * bk.y_pitch * sb,
      static_cast<size_t>(nc) * bk.c_ring * bk.c_pitch * sb,
      2 * static_cast<size_t>(bk.stage_rows) * (bk.y_pitch + nc * bk.c_pitch) *
          mb,
      static_cast<size_t>(bk.tile_w) *
          (4 * w_pitch(bk.wy_k) + 4 * w_pitch(bk.wc_k) + 16),
      16 * static_cast<size_t>(bk.strip_rows / bk.stage_rows)};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += up16(parts[i]);
  }
  off[5] = at;
}

// Calls f(row, col) for the items i = threadIdx.x, + kThreads, ... of a
// [rows][per] grid, without a division per item.
template <typename F>
__device__ __forceinline__ void for_grid(int rows, int per, F&& f) {
  if (rows <= 0 || per <= 0) return;
  const int dr = kThreads / per, dc = kThreads - dr * per;
  int r = threadIdx.x / per, c = threadIdx.x - r * per;
  for (; r < rows;) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

template <typename T, typename TOut, bool F32, int L>
__global__ void __launch_bounds__(kThreads, 2)
preprocess_kernel(Src sy, Src su, Src sv, Tables t, Tail tl, Block bk,
                  Dims d, TOut* __restrict__ out) {
  using M = Mid<F32>;
  using MT = typename M::T;
  constexpr int NC = L == kNV12 ? 1 : 2;  // chroma planes in a ring
  constexpr int CC = L == kNV12 ? 2 : 1;  // lanes a chroma sample takes
  constexpr int VI = Lanes<T>::kN;        // lanes of 16 bytes: an H item
  constexpr int kRowBlock = w_rows<L, T>();

  extern __shared__ __align__(16) unsigned char smem[];
  size_t off[6];
  carve(bk, NC, sizeof(T), sizeof(MT), off);
  T* ring_y = reinterpret_cast<T*>(smem + off[0]);  // [y_ring][y_pitch]
  T* ring_c = reinterpret_cast<T*>(smem + off[1]);  // [NC][c_ring][c_pitch]
  MT* mid = reinterpret_cast<MT*>(smem + off[2]);
  // mid: [2][stage_rows][y_pitch] luma, then [2][NC][stage_rows][c_pitch]
  const int G = bk.stage_rows;
  MT* mid_c = mid + 2 * G * bk.y_pitch;
  const int wyp = w_pitch(bk.wy_k), wcp = w_pitch(bk.wc_k);
  float* wy_tab = reinterpret_cast<float*>(smem + off[3]);  // [tile][wyp]
  float* wc_tab = wy_tab + bk.tile_w * wyp;                 // [tile][wcp]
  int* y_ofs = reinterpret_cast<int*>(wc_tab + bk.tile_w * wcp);
  int* y_cnt = y_ofs + bk.tile_w;
  int* c_ofs = y_cnt + bk.tile_w;
  int* c_cnt = c_ofs + bk.tile_w;
  // per stage of the strip: the luma and chroma source rows [lo, hi]
  int4* bands = reinterpret_cast<int4*>(smem + off[4]);
  __shared__ int s_lo[2], s_hi[2];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * bk.tile_w;
  const int cols = min(bk.tile_w, d.dst_w - p0);
  const int o0 = blockIdx.y * bk.strip_rows;
  const int o1 = min(o0 + bk.strip_rows, d.dst_h);
  const int stages = (o1 - o0 + G - 1) / G;
  const int DW = d.dst_w;

  // ---- the tile's column tables, source windows and stage bands --------
  if (tid < 2) {
    s_lo[tid] = INT_MAX;
    s_hi[tid] = -1;
  }
  __syncthreads();
  for (int j = tid; j < cols; j += kThreads) {
    const int p = p0 + j;
    const int ys = __ldg(t.wy_start + p), yn = __ldg(t.wy_count + p);
    const int cs = __ldg(t.wc_start + p), cn = __ldg(t.wc_count + p);
    atomicMin(&s_lo[0], ys);
    atomicMax(&s_hi[0], ys + yn);
    atomicMin(&s_lo[1], cs);
    atomicMax(&s_hi[1], cs + cn);
    y_cnt[j] = yn;
    c_cnt[j] = cn;
  }
  for_grid(bk.wy_k, cols, [&](int k, int j) {
    wy_tab[j * wyp + k] = __ldg(t.wy_w + static_cast<long long>(k) * DW +
                                p0 + j);
  });
  for_grid(bk.wc_k, cols, [&](int k, int j) {
    wc_tab[j * wcp + k] = __ldg(t.wc_w + static_cast<long long>(k) * DW +
                                p0 + j);
  });
  for (int s = tid; s < stages; s += kThreads) {
    int4 bd = make_int4(INT_MAX, -1, INT_MAX, -1);
    for (int g = 0; g < G; ++g) {
      const int r = o0 + s * G + g;
      if (r >= o1) break;
      const int yn = __ldg(t.hy_count + r), cn = __ldg(t.hc_count + r);
      if (yn > 0) {
        const int y0 = __ldg(t.hy_start + r);
        bd.x = min(bd.x, y0);
        bd.y = max(bd.y, y0 + yn - 1);
      }
      if (cn > 0) {
        const int c0 = __ldg(t.hc_start + r);
        bd.z = min(bd.z, c0);
        bd.w = max(bd.w, c0 + cn - 1);
      }
    }
    bands[s] = bd;
  }
  __syncthreads();
  const int y_lane0 = s_lo[0] / VI * VI;  // window starts, 16-byte aligned
  const int c_lane0 = s_lo[1] * CC / VI * VI;
  const int y_nl = s_hi[0] - y_lane0;     // window lanes, <= pitch
  const int c_nl = s_hi[1] * CC - c_lane0;
  for (int j = tid; j < cols; j += kThreads) {
    y_ofs[j] = __ldg(t.wy_start + p0 + j) - y_lane0;
    c_ofs[j] = __ldg(t.wc_start + p0 + j) * CC - c_lane0;
  }

  // ---- ring fill: source rows [r0, r1) of one plane into slots row % D --
  // (a stage brings at most D rows, so slot r0 % D + i wraps at most once)
  const T* ybase = static_cast<const T*>(sy.p) + b * sy.bs + y_lane0;
  const T* ubase = static_cast<const T*>(su.p) + b * su.bs + c_lane0;
  const T* vbase = static_cast<const T*>(sv.p) + b * sv.bs + c_lane0;
  auto aligned = [](const T* p, long long rs) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 &&
           (rs * static_cast<long long>(sizeof(T))) % 16 == 0;
  };
  const bool y_vec = aligned(ybase, sy.rs);
  const bool c_vec = aligned(ubase, su.rs) && (NC == 1 || aligned(vbase, sv.rs));
  auto fetch = [&](T* ring, int pitch, int D, const T* base, long long rs,
                   int nl, int avail, bool vec, int r0, int r1) {
    const int s0 = r0 % D;
    if (vec) {
      for_grid(r1 - r0, (nl + VI - 1) / VI, [&](int i, int v) {
        const int l = v * VI;
        const int slot = s0 + i < D ? s0 + i : s0 + i - D;
        const int bytes =
            max(0, min(VI, avail - l)) * static_cast<int>(sizeof(T));
        cp_async16(ring + slot * pitch + l,
                   base + static_cast<long long>(r0 + i) * rs +
                       (bytes > 0 ? l : 0),
                   bytes);
      });
    } else {
      for_grid(r1 - r0, nl, [&](int i, int l) {
        const int slot = s0 + i < D ? s0 + i : s0 + i - D;
        ring[slot * pitch + l] =
            __ldg(base + static_cast<long long>(r0 + i) * rs + l);
      });
    }
  };

  const int y_avail = d.src_w - y_lane0, c_avail = d.cw * CC - c_lane0;
  int y_fetched = -1, c_fetched = -1;  // the highest rows fetched so far
  // the rows of stage s not in the rings yet; one commit group a stage,
  // empty or not
  auto fetch_stage = [&](int s) {
    if (s < stages) {
      const int4 bd = bands[s];
      int lo = max(bd.x, y_fetched + 1);
      if (bd.y >= lo)
        fetch(ring_y, bk.y_pitch, bk.y_ring, ybase, sy.rs, y_nl, y_avail,
              y_vec, lo, bd.y + 1);
      y_fetched = max(y_fetched, bd.y);
      lo = max(bd.z, c_fetched + 1);
      if (bd.w >= lo) {
        fetch(ring_c, bk.c_pitch, bk.c_ring, ubase, su.rs, c_nl, c_avail,
              c_vec, lo, bd.w + 1);
        if (NC == 2)
          fetch(ring_c + bk.c_ring * bk.c_pitch, bk.c_pitch, bk.c_ring, vbase,
                sv.rs, c_nl, c_avail, c_vec, lo, bd.w + 1);
      }
      c_fetched = max(c_fetched, bd.w);
    }
    cp_async_commit();
  };

  for (int s = 0; s < kAhead; ++s) fetch_stage(s);
  const long long plane_sz = static_cast<long long>(d.dst_h) * DW;
  TOut* ob = out + static_cast<long long>(b) * 3 * plane_sz + p0;
  const int y_items = (y_nl + VI - 1) / VI;
  const int c_items = (c_nl + VI - 1) / VI;

  for (int s = 0; s <= stages; ++s) {
    cp_async_wait_stage();
    __syncthreads();  // stage s's rows landed; stage s - 1 summed
    fetch_stage(s + kAhead);

    // ---- H pass of stage s: kHRows (1 or 2) output rows an item ---------
    // An item walks the source rows of its rows' bands in ascending order
    // and adds each sample into every row whose band covers it: with two
    // rows, in three branch-free segments (row 0 alone, both, row 1 alone;
    // the bands start and end in order), each sample converted once for
    // both. No zero-weight FMA runs, and each row still sums its own taps
    // in ascending k from 0.0f.
    if (s < stages && !(BANDED_PREPROCESS_KNOCKOUT & 2)) {
      const int r_base = o0 + s * G;
      const int rows = min(G, o1 - r_base);
      const int blocks = (rows + kHRows - 1) / kHRows;
      MT* my = mid + (s & 1) * G * bk.y_pitch;
      MT* mc = mid_c + (s & 1) * NC * G * bk.c_pitch;
      // items: blocks x y_items luma, then NC x blocks x c_items chroma (a
      // division or two an item of its rows' taps x VI lanes)
      const int ny = blocks * y_items;
      const int total = ny + NC * blocks * c_items;
      for (int i = tid; i < total; i += kThreads) {
        const bool luma = i < ny;
        int c = 0, g0, v;
        if (luma) {
          g0 = i / y_items;
          v = i - g0 * y_items;
        } else {
          const int e = i - ny;
          c = NC == 2 && e >= blocks * c_items;
          const int f = e - c * blocks * c_items;
          g0 = f / c_items;
          v = f - g0 * c_items;
        }
        g0 *= kHRows;
        const int pitch = luma ? bk.y_pitch : bk.c_pitch;
        const int D = luma ? bk.y_ring : bk.c_ring;
        const T* col = luma ? ring_y + v * VI
                            : ring_c + c * D * pitch + v * VI;
        MT* dst = luma ? my + g0 * pitch + v * VI
                       : mc + (c * G + g0) * pitch + v * VI;
        const int* start = luma ? t.hy_start : t.hc_start;
        const int* count = luma ? t.hy_count : t.hc_count;
        const int k_max = luma ? t.hy_k : t.hc_k;
        const float* w = (luma ? t.hy_w : t.hc_w) +
                         static_cast<long long>(r_base + g0) * k_max;
        const int n0 = __ldg(count + r_base + g0);
        const int a0 = n0 > 0 ? __ldg(start + r_base + g0) : 0;
        const int n1 = kHRows > 1 && g0 + 1 < rows
                           ? __ldg(count + r_base + g0 + 1) : 0;
        const int a1 = n1 > 0 ? __ldg(start + r_base + g0 + 1) : 0;
        float acc[kHRows][VI];
#pragma unroll
        for (int u = 0; u < kHRows; ++u)
#pragma unroll
          for (int l = 0; l < VI; ++l) acc[u][l] = 0.0f;
        // source rows [r0, r1) into row 0 (from its tap r0 - a0) and / or
        // row 1 (from its tap r0 - a1)
        auto walk = [&](auto use0, auto use1, int r0, int r1) {
          if (r1 <= r0) return;
          int slot = r0 % D;
          const float* p0 = w + (r0 - a0);
          const float* p1 = w + k_max + (r0 - a1);
#pragma unroll 2
          for (int r = r0; r < r1; ++r) {
            float x[VI];
            Lanes<T>::get(
                *reinterpret_cast<const uint4*>(col + slot * pitch), x);
            if constexpr (decltype(use0)::value) {
              const float wk = __ldg(p0++);
#pragma unroll
              for (int l = 0; l < VI; ++l)
                acc[0][l] = fmaf(wk, x[l], acc[0][l]);
            }
            if constexpr (kHRows > 1 && decltype(use1)::value) {
              const float wk = __ldg(p1++);
#pragma unroll
              for (int l = 0; l < VI; ++l)
                acc[kHRows - 1][l] = fmaf(wk, x[l], acc[kHRows - 1][l]);
            }
            slot = slot + 1 == D ? 0 : slot + 1;
          }
        };
        using Y = std::true_type;
        using N = std::false_type;
        const int e0 = a0 + n0, e1 = a1 + n1;
        if (n1 == 0) {
          walk(Y(), N(), a0, e0);
        } else if (n0 == 0) {
          walk(N(), Y(), a1, e1);
        } else {  // bands start and end in order: a0 <= a1, e0 <= e1
          walk(Y(), N(), a0, min(a1, e0));
          walk(Y(), Y(), a1, e0);
          walk(N(), Y(), max(a1, e0), e1);
        }
        store_mid<VI>(dst, acc[0]);
        if (kHRows > 1 && g0 + 1 < rows)
          store_mid<VI>(dst + pitch, acc[kHRows - 1]);
      }
    }

    // ---- W pass of stage s - 1, CSC, quantise/normalise ----------------
    // one output pixel over kRowBlock rows: the same taps and weights, so
    // one weight load feeds kRowBlock independent chains. Items are dealt
    // from the last thread down, to the threads the H pass left idle.
    if (s > 0 && !(BANDED_PREPROCESS_KNOCKOUT & 1)) {
      const int r_base = o0 + (s - 1) * G;
      const int rows = min(G, o1 - r_base);
      const MT* my = mid + ((s - 1) & 1) * G * bk.y_pitch;
      const MT* mc = mid_c + ((s - 1) & 1) * NC * G * bk.c_pitch;
      const int items = (rows + kRowBlock - 1) / kRowBlock * cols;
      int g0 = (kThreads - 1 - tid) / cols;
      int q = kThreads - 1 - tid - g0 * cols;
      g0 *= kRowBlock;
      const int dg = kThreads / cols, dq = kThreads - dg * cols;
      for (int i = kThreads - 1 - tid; i < items; i += kThreads) {
        float ya[kRowBlock], ua[kRowBlock], va[kRowBlock];
        int gr[kRowBlock];
#pragma unroll
        for (int u = 0; u < kRowBlock; ++u) {
          gr[u] = min(g0 + u, rows - 1);  // past the stage: computed, not
          ya[u] = ua[u] = va[u] = 0.0f;   // kept
        }
        {
          const int n = y_cnt[q];
          const float* wq = wy_tab + q * wyp;
          const MT* mj = my + y_ofs[q];
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            const float wk = wq[k];
#pragma unroll
            for (int u = 0; u < kRowBlock; ++u)
              ya[u] = fmaf(wk, M::get(mj[gr[u] * bk.y_pitch + k]), ya[u]);
          }
        }
        {
          const int n = c_cnt[q];
          const float* wq = wc_tab + q * wcp;
          const MT* mu = mc + c_ofs[q];
          const MT* mv = L == kNV12 ? mu + 1 : mu + G * bk.c_pitch;
#pragma unroll 2
          for (int k = 0; k < n; ++k) {
            const float wk = wq[k];
#pragma unroll
            for (int u = 0; u < kRowBlock; ++u) {
              const int at = gr[u] * bk.c_pitch + CC * k;
              ua[u] = fmaf(wk, M::get(mu[at]), ua[u]);
              va[u] = fmaf(wk, M::get(mv[at]), va[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRowBlock; ++u) {
          if (g0 + u >= rows) break;
          const float yv = __fsub_rn(ya[u], tl.y_off);
          const float uu = __fsub_rn(ua[u], tl.c_off);
          const float vv = __fsub_rn(va[u], tl.c_off);
          TOut* o = ob + static_cast<long long>(r_base + g0 + u) * DW + q;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            // no FMA contraction: same rounding as three separate products
            const float x = __fadd_rn(
                __fadd_rn(__fmul_rn(tl.m[3 * c], yv),
                          __fmul_rn(tl.m[3 * c + 1], uu)),
                __fmul_rn(tl.m[3 * c + 2], vv));
            Out<TOut>::store(o + c * plane_sz, x, c, tl);
          }
        }
        g0 += dg * kRowBlock;
        q += dq;
        if (q >= cols) {
          q -= cols;
          g0 += kRowBlock;
        }
      }
    }
  }
}

template <typename T, typename TOut, bool F32, int L>
cudaError_t launch_typed(Src sy, Src su, Src sv, const Tables& t,
                         const Tail& tl, const Block& bk, const Dims& d,
                         int batch, void* out, cudaStream_t stream) {
  auto kern = preprocess_kernel<T, TOut, F32, L>;
  size_t off[6];
  carve(bk, L == kNV12 ? 1 : 2, sizeof(T), sizeof(typename Mid<F32>::T),
        off);
  const cudaError_t e = banded::allow_smem(kern, off[5]);
  if (e != cudaSuccess) return e;
  const dim3 grid((d.dst_w + bk.tile_w - 1) / bk.tile_w,
                  (d.dst_h + bk.strip_rows - 1) / bk.strip_rows, batch);
  kern<<<grid, kThreads, off[5], stream>>>(sy, su, sv, t, tl, bk, d,
                                           static_cast<TOut*>(out));
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t pick(int out_kind, int f32, Src sy, Src su, Src sv,
                 const Tables& t, const Tail& tl, const Block& bk,
                 const Dims& d, int batch, void* out, cudaStream_t s) {
  // uint16 samples compute in fp32 only: bf16 cannot hold them
  if (sizeof(T) == 2 && !f32) return cudaErrorInvalidValue;
#define VALI_PICK(TOUT)                                                  \
  return f32 ? launch_typed<T, TOUT, true, L>(sy, su, sv, t, tl, bk, d, \
                                              batch, out, s)            \
             : launch_typed<T, TOUT, sizeof(T) == 2, L>(                \
                   sy, su, sv, t, tl, bk, d, batch, out, s)
  switch (out_kind) {
    case 0: VALI_PICK(uint8_t);
    case 1: VALI_PICK(float);
    case 2: VALI_PICK(__nv_bfloat16);
    default: return cudaErrorInvalidValue;
  }
#undef VALI_PICK
}

// Shared part of the launchers: tables, tail, geometry, dispatch. 4:2:2
// and 4:4:4 take uint8 samples only, as their TPU kernels do.
template <int L>
cudaError_t launch(Src sy, Src su, Src sv, int in_bytes, int batch,
                   int src_h, int src_w, int dst_h, int dst_w,
                   const int* index, const float* weights, int hy_k,
                   int hc_k, int wy_k, int wc_k, const int* geometry,
                   const float* tail, int f32, void* out, int out_kind,
                   cudaStream_t stream) {
  constexpr bool kWide = L == kNV12 || L == kI420;  // takes uint16 samples
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return cudaSuccess;
  if ((in_bytes != 1 && !(kWide && in_bytes == 2)) || src_w <= 0 ||
      src_h <= 0 || (L != kI444 && (src_w & 1)))
    return cudaErrorInvalidValue;
  Block bk;
  bk.tile_w = geometry[0];
  bk.y_pitch = geometry[1];
  bk.c_pitch = geometry[2];
  bk.stage_rows = geometry[3];
  bk.strip_rows = geometry[4];
  bk.y_ring = geometry[5];
  bk.c_ring = geometry[6];
  bk.wy_k = wy_k;
  bk.wc_k = wc_k;
  const int vec = 16 / in_bytes;
  if (bk.tile_w <= 0 || bk.stage_rows <= 0 || bk.strip_rows <= 0 ||
      bk.strip_rows % bk.stage_rows != 0 || bk.y_pitch <= 0 ||
      bk.c_pitch <= 0 || bk.y_pitch % vec || bk.c_pitch % vec ||
      bk.y_ring <= 0 || bk.c_ring <= 0)
    return cudaErrorInvalidValue;
  const Tables t = banded::unpack_tables(index, weights, dst_h, dst_w, hy_k,
                                         hc_k, wy_k);
  const Tail tl = banded::unpack_tail(tail);
  const Dims d{src_w, dst_h, dst_w, banded::chroma_cols(L, src_w)};
  if (in_bytes == 1)
    return pick<uint8_t, L>(out_kind, f32, sy, su, sv, t, tl, bk, d, batch,
                            out, stream);
  if constexpr (kWide)
    return pick<uint16_t, L>(out_kind, f32, sy, su, sv, t, tl, bk, d, batch,
                             out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// NV12 / P010 / P012: `src` is frame 0 of a [B, >= H*3/2, W] plane with
// the given batch and row strides (elements); the interleaved UV rows
// start at row H. in_bytes 1 = uint8, 2 = uint16 (fp32 compute only). out
// is a contiguous [B, 3, dst_h, dst_w] tensor: out_kind 0 = uint8, 1 =
// float32, 2 = bfloat16. `index` / `weights` / taps are ops/banded.py
// DeviceTables; `geometry` is a host array of the 7 ints of
// PreprocessTables (tile_w, y_pitch, c_pitch, stage_rows, strip_rows,
// y_ring, c_ring); `tail` is a host array of 18 floats
// (ops/banded.py tail_params).
int nv12_preprocess_launch(const void* src, int in_bytes,
                           long long batch_stride, long long row_stride,
                           int batch, int src_h, int src_w, int dst_h,
                           int dst_w, const int* index, const float* weights,
                           int hy_k, int hc_k, int wy_k, int wc_k,
                           const int* geometry, const float* tail,
                           int f32_compute, void* out, int out_kind,
                           void* stream) {
  const Src y{src, batch_stride, row_stride};
  const Src uv{static_cast<const char*>(src) +
                   static_cast<long long>(src_h) * row_stride * in_bytes,
               batch_stride, row_stride};
  return static_cast<int>(launch<kNV12>(
      y, uv, uv, in_bytes, batch, src_h, src_w, dst_h, dst_w, index, weights,
      hy_k, hc_k, wy_k, wc_k, geometry, tail, f32_compute, out, out_kind,
      static_cast<cudaStream_t>(stream)));
}

// Planar I420 (8-bit or LSB-aligned 10-bit): y [B, >= H, W], u and v
// [B, >= H/2, W/2], each frame 0 of a plane with its own strides
// (elements). Everything else as nv12_preprocess_launch.
int yuv420_preprocess_launch(const void* y, const void* u, const void* v,
                             int in_bytes, long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const int* geometry, const float* tail,
                             int f32_compute, void* out, int out_kind,
                             void* stream) {
  return static_cast<int>(launch<kI420>(
      Src{y, y_batch_stride, y_row_stride},
      Src{u, u_batch_stride, u_row_stride},
      Src{v, v_batch_stride, v_row_stride}, in_bytes, batch, src_h, src_w,
      dst_h, dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, geometry, tail,
      f32_compute, out, out_kind, static_cast<cudaStream_t>(stream)));
}

// Planar 4:2:2, uint8: y [B, >= H, W], u and v [B, >= H, W/2]. The chroma
// row tables of the geometry are the luma row tables. Everything else as
// yuv420_preprocess_launch.
int yuv422_preprocess_launch(const void* y, const void* u, const void* v,
                             long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const int* geometry, const float* tail,
                             int f32_compute, void* out, int out_kind,
                             void* stream) {
  return static_cast<int>(launch<kI422>(
      Src{y, y_batch_stride, y_row_stride},
      Src{u, u_batch_stride, u_row_stride},
      Src{v, v_batch_stride, v_row_stride}, 1, batch, src_h, src_w, dst_h,
      dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, geometry, tail,
      f32_compute, out, out_kind, static_cast<cudaStream_t>(stream)));
}

// Planar 4:4:4, uint8: y, u and v [B, >= H, W]. The chroma tables of the
// geometry are the luma tables. Everything else as
// yuv420_preprocess_launch.
int yuv444_preprocess_launch(const void* y, const void* u, const void* v,
                             long long y_batch_stride,
                             long long y_row_stride, long long u_batch_stride,
                             long long u_row_stride, long long v_batch_stride,
                             long long v_row_stride, int batch, int src_h,
                             int src_w, int dst_h, int dst_w,
                             const int* index, const float* weights,
                             int hy_k, int hc_k, int wy_k, int wc_k,
                             const int* geometry, const float* tail,
                             int f32_compute, void* out, int out_kind,
                             void* stream) {
  return static_cast<int>(launch<kI444>(
      Src{y, y_batch_stride, y_row_stride},
      Src{u, u_batch_stride, u_row_stride},
      Src{v, v_batch_stride, v_row_stride}, 1, batch, src_h, src_w, dst_h,
      dst_w, index, weights, hy_k, hc_k, wy_k, wc_k, geometry, tail,
      f32_compute, out, out_kind, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
