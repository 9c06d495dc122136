// Lab kernel `streamed` of the 4K NV12 resize lab for Hopper (sm_90a): the
// NV12 resize with each block walking down the frame, its source rows
// staged in bands by TMA into an mbarrier ring, both passes on wgmma.
//
// Replaces streamed of resize_diag.py: on the TPU the frame stays in HBM
// and the kernel streams bands of `band` rows into VMEM with double-
// buffered async copies (two bands in flight), running each row tile's H
// product as soon as its window's last band has landed, then the W
// products. Its question: do explicit async bulk copies, overlapped with
// the products, beat staging whole blocks? Here the matching tools are the
// Tensor Memory Accelerator and mbarriers.
//
// What bounds it on this card: the bytes. 16 x 4K NV12 -> 1080p reads
// 199 MB and writes 50 MB (0.074 ms at 3.35 TB/s); the products issue
// ~35 GFLOP with the zeros (aligned's tables at 8x32, 0.035 ms at
// 989 TFLOP/s bf16).
//
// Design. The products are `aligned`'s at h_align 8, w_align 32
// (aligned_passes.cuh, the same host tables): 32-row strips over windows
// of k_pad rows, B per strip, 64-pixel W tiles with their fragment-order
// A. What differs is how the bytes reach shared memory and the walk.
//   - A block is persistent: it walks a static list of runs (range, frame,
//     first strip, strips) the host cut so that every SM gets the same
//     tensor-core work within one strip's (lab/resize_diag.py
//     streamed_plan). One launch a plane, compiled per K / 16 and plane so
//     that no wgmma sits under a branch.
//   - The ring: `slots` slots of one band each, a band being plane rows
//     [k band, (k + 1) band) of the range's 128-byte column chunks, each
//     chunk one TMA box [band, 128] swizzled by 128 bytes (so the rows
//     2 tq, 2 tq + 2, ... that a warp reads at once fall in distinct
//     banks). Slots: those one window can span plus one band in flight
//     where shared memory allows (the host sizes the column ranges so that
//     ring, H rows and B fit a block).
//   - Copies: one thread (the first of the last warpgroup, which takes
//     the fewest chunks and tiles) arms a slot's "full" mbarrier with the
//     whole band's bytes (TMA counts the zero-filled rows and columns past
//     the plane too) and issues the band's boxes; B of each strip comes by
//     one bulk copy under its own "full" barrier. A slot is reissued right
//     after the barrier that ends the H pass of the strip that last reads
//     it (that barrier is the "empty" signal: every thread's reads of the
//     slot are done), so the next bands and B land during the W pass and
//     the next strip's H pass. Where the frames cannot be a tensor map (a
//     start or a stride not a multiple of 16 bytes) every thread fills its
//     share of the same slots, swizzled alike, with element loads.
//   - Four warpgroups per strip: wait for the bands of the strip's window
//     and for B; the H product per chunk (warpgroups 0 and 1 take the
//     even chunks, 2 and 3 the odd ones, each 64 byte columns, A built
//     from the ring's raw bytes, window rows past the plane read its last
//     row with weight 0, their ring offsets from a table the last
//     warpgroup built during the strip before: no division in the
//     products); aligned's W product per tile (tile t to warpgroup
//     t mod 4); uint8 out. One block an SM, 16 warps (128 registers a
//     thread).
//   - Hazards: the copies into a slot are issued only after the barrier
//     that follows every thread's last read of it, behind a proxy fence;
//     a band that lands unread (between two windows) is waited for before
//     its slot is reused; parity per slot from the band's running count;
//     the H rows (generic stores, read by wgmma) are fenced and barriered
//     before the W pass, and the next strip's barrier comes before its H
//     rows overwrite them; the row tables and B alternate with that
//     barrier too. Every wait traps after ~2 s.
//
// Bits: the same A fragments, B, k-step order and W tables as aligned at
// 8x32, so the output equals aligned8x32's; that is within the uint8
// envelope of nv12_resize (the tensor cores add a k-step's products in
// their own order).
//
// The launcher encodes the two planes' tensor maps on the host, returns
// cudaGetLastError() after its launches, runs on the caller's stream, and
// neither synchronises nor allocates.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_passes.cuh"
#include "banded_common.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/streamed_ab.py), 0 here,
// 1 to 6 there: bit 1 skips the W pass, bit 2 the H pass's conversion and
// products (3: the staging alone: the bands and B still land and are
// released), bit 4 the copies (the issuing thread arrives on the full
// barriers without them: 4 the products alone, 5 the H pass alone, 6 the
// W pass alone).
#ifndef NV12_STREAMED_KNOCKOUT
#define NV12_STREAMED_KNOCKOUT 0
#endif

namespace {

using banded::allow_smem;
using banded::kSmemLimit;
using passes::kGroupBytes;
using passes::kRows;

constexpr int kKnockout = NV12_STREAMED_KNOCKOUT;
constexpr int kGroups = 4;              // warpgroups
constexpr int kThreads = 128 * kGroups;
constexpr int kChunk = 128;             // bytes of a box row
constexpr int kMaxKSteps = 16;          // k_pad <= 256 window rows
constexpr int kMaxBand = 256;           // rows of one TMA box
constexpr int kBarrier = 1;             // the strips' named barrier
// The thread that issues the copies: the first of the last warpgroup,
// which takes the fewest chunks and tiles of a strip.
constexpr int kIssuer = kThreads - 128;

// One plane's launch: its frames, output and tables (lab/resize_diag.py
// StreamedPlane).
struct Plane {
  const uint8_t* src;  // plane row 0 of frame 0
  long long bs, rs;    // batch and row strides of the frames (bytes)
  int rows, bytes;     // plane rows; bytes of a row
  int tma;             // TMA boxes (else element loads)
  uint8_t* out;        // output plane row 0 of frame 0
  long long out_bs;    // output batch stride
  int dst_rows, dst_w;  // output rows; bytes of an output row
  const uint4* b;       // [strips][k_pad * kRows / 8] bf16, core matrices
  const int* starts;    // [strips] first plane row of each window
  int k_pad;
  const int4* ranges;   // [ranges]: first tile, tiles, first H pixel, H pixels
  int hcols;            // H columns (pixels) of the widest range
  const int* heads;     // [tiles][3]: first k-step, first pixel, k-steps
  const uint4* frags;   // [k-steps][128] bf16 A fragments
  int slots, band;      // ring slots; rows of a band
  int chunks;           // 128-byte chunks of the widest range: a slot's boxes
  const int4* runs;     // [runs]: range, frame, first strip, strips
  const int* blocks;    // [blocks + 1]: each block's first run
};

// First and last band of strip s's window (rows past the plane read its
// last row).
__device__ __forceinline__ int2 strip_bands(const Plane& p, int s) {
  const int w0 = __ldg(p.starts + s);
  return make_int2(w0 / p.band, (min(w0 + p.k_pad, p.rows) - 1) / p.band);
}

__host__ __device__ __forceinline__ int chunks_of(int hpx, int ch) {
  return (hpx * ch + kChunk - 1) / kChunk;
}

template <int NK, int CH>
__global__ void __launch_bounds__(kThreads, 1)
    streamed_kernel(__grid_constant__ const CUtensorMap map, Plane p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr int kp = 16 * NK;
  const int box = p.band * kChunk;  // bytes of one [band, 128] box
  const int slot_bytes = box * p.chunks;
  unsigned char* ring = smem;                          // slots of boxes
  unsigned char* hrows = ring + p.slots * slot_bytes;  // tiled H rows
  unsigned char* bw = hrows + p.hcols / 8 * kGroup;    // B: [kp, kRows]
  int* rowtab = reinterpret_cast<int*>(bw + kp * kRows * 2);  // [2][kp]
  uint64_t* full = reinterpret_cast<uint64_t*>(rowtab + 2 * kp);
  uint64_t* bfull = full + p.slots;
  const int tid = threadIdx.x;
  const int r0 = __ldg(p.blocks + blockIdx.x);
  const int r1 = __ldg(p.blocks + blockIdx.x + 1);
  if (tid == 0) {
    if (tma::smem_u32(smem) & 1023) __trap();  // the swizzle's atoms
    for (int i = 0; i <= p.slots; ++i) tma::mbar_init(full + i, 1);
    tma::fence_mbar_init();
  }
  __syncthreads();

  // The copies, in the order the strips read them: band counter k of the
  // block (over its runs) goes to slot k mod slots once the band k - slots
  // has been released; (cr, cb, ce): the run of the next band, that band,
  // the run's last. The issuer alone keeps the cursor and issues TMA's
  // boxes; with element loads every thread keeps it and copies its share.
  const bool issuer = tid == kIssuer;
  int cr = r0, cb = 0, ce = -1, issued = 0;
  const auto open_run = [&] {
    if (cr < r1) {
      const int4 run = __ldg(p.runs + cr);
      cb = strip_bands(p, run.z).x;
      ce = strip_bands(p, run.z + run.w - 1).y;
    }
  };
  open_run();
  const auto stage = [&](int released) {  // band counters < released free
    if (p.tma && !issuer) return;
    while (cr < r1 && issued < released + p.slots) {
      const int4 run = __ldg(p.runs + cr);
      const int4 rg = __ldg(p.ranges + run.x);
      const int xb0 = rg.z * CH, nch = chunks_of(rg.w, CH);
      uint64_t* bar = full + issued % p.slots;
      unsigned char* dst = ring + issued % p.slots * slot_bytes;
      if (kKnockout & 4) {
        if (issuer) tma::mbar_arrive(bar);
      } else if (p.tma) {
        wgmma::fence_proxy_async();  // the slot's reads, then TMA's writes
        tma::mbar_expect(bar, nch * box);
        for (int c = 0; c < nch; ++c)
          tma::load_box(dst + c * box, &map, xb0 + c * kChunk, cb * p.band,
                        run.y, bar);
      } else {
        const uint8_t* frame = p.src + run.y * p.bs;
        for (int i = tid; i < nch * box; i += kThreads) {
          const int c = i / box, x = i - c * box;
          const int r = cb * p.band + x / kChunk;
          const int col = xb0 + c * kChunk + x % kChunk;
          dst[c * box + tma::swizzle128(x)] =
              r < p.rows && col < p.bytes ? __ldg(frame + r * p.rs + col) : 0;
        }
        // the other threads' copies are seen through the barriers between
        // here and the strip that reads the band
        if (issuer) tma::mbar_arrive(bar);
      }
      ++issued;
      if (++cb > ce) {
        ++cr;
        open_run();
      }
    }
  };
  const unsigned b_bytes = kp * kRows * 2;
  const auto stage_b = [&](int s) {  // B of strip s into its buffer
    if (!issuer) return;
    if (kKnockout & 4) {
      tma::mbar_arrive(bfull);
    } else {
      tma::mbar_expect(bfull, b_bytes);
      tma::bulk_load(bw, p.b + static_cast<long long>(s) * kp * kRows / 8,
                     b_bytes, bfull);
    }
  };
  // ring offset of each window row of strip s in chunk 0, before the
  // swizzle (rows past the plane read its last row), into table t; the
  // band counter n is that of the run's first band lo0
  const auto fill_rows = [&](int t, int s, int n, int lo0) {
    for (int k = tid - kIssuer; k >= 0 && k < kp; k += 128) {
      const int row = min(__ldg(p.starts + s) + k, p.rows - 1);
      const int band = row / p.band;
      rowtab[t * kp + k] = (n + band - lo0) % p.slots * slot_bytes +
                           (row - band * p.band) * kChunk;
    }
  };
  stage(0);
  if (r0 < r1) {
    const int s0 = __ldg(p.runs + r0).z;
    stage_b(s0);
    fill_rows(0, s0, 0, strip_bands(p, s0).x);
  }

  const int wg = tid >> 7;  // warpgroup: 64 columns of every other chunk
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * (wg & 1) + 16 * warp + 2 * gq;  // its 2 columns
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);
  int n = 0, sc = 0;  // the run's first band counter; strips read
  for (int ri = r0; ri < r1; ++ri) {
    const int4 run = __ldg(p.runs + ri);
    const int4 rg = __ldg(p.ranges + run.x);
    const int xb0 = rg.z * CH;      // the range's first byte of a row
    const int hbytes = rg.w * CH;   // bytes of its H columns
    const int nch = chunks_of(rg.w, CH);
    const int end = p.bytes - xb0;  // bytes of a row from the range's start
    uint8_t* ob = p.out + run.y * p.out_bs;
    const int lo0 = strip_bands(p, run.z).x;
    const auto wait_band = [&](int b) {
      const int k = n + b - lo0;
      tma::mbar_wait(full + k % p.slots, (k / p.slots) & 1);
    };
    int waited = lo0;  // the next band to wait for
    for (int s = run.z; s < run.z + run.w; ++s) {
      const int2 bands = strip_bands(p, s);
      const int* rows_of = rowtab + (sc & 1) * kp;  // written a strip ago
      for (; waited <= bands.y; ++waited) wait_band(waited);
      tma::mbar_wait(bfull, sc & 1);
      // the strip before done with the H rows (and its row table written)
      tma::named_sync(kBarrier, kThreads);
      if (!(kKnockout & 2)) {
        // the thread's window rows 16 ks + 2 tq (+1, +8, +9) at its byte
        // columns, swizzled as TMA lays them out
        int off[NK][4];
#pragma unroll
        for (int ks = 0; ks < NK; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            off[ks][j] = tma::swizzle128(
                rows_of[16 * ks + 2 * tq + (j & 1) + 8 * (j >> 1)] + ccol);
        for (int c = wg >> 1; c < nch; c += kGroups / 2) {
          unsigned a[NK][4];
#pragma unroll
          for (int ks = 0; ks < NK; ++ks) {
            const uint4 f = wgmma::ring_step(ring + c * box, off[ks]);
            a[ks][0] = f.x;
            a[ks][1] = f.y;
            a[ks][2] = f.z;
            a[ks][3] = f.w;
          }
          float d[kRows / 2];
          passes::h_product<NK>(d, a, bdesc);
          passes::store_h<CH>(hrows, d, c * kChunk + ccol, hbytes, end, tq);
        }
      }
      const bool last = s + 1 == run.z + run.w;
      const int next_lo = last ? bands.y + 1 : strip_bands(p, s + 1).x;
      // a band between two windows lands unread: wait for it before its
      // slot is reused
      for (; waited < next_lo; ++waited) wait_band(waited);
      wgmma::fence_proxy_async();  // the H rows, read by wgmma in the W pass
      // every read of the ring, B and the row table by the H pass done:
      // the bands the next strip does not read are free, and B
      tma::named_sync(kBarrier, kThreads);
      stage(n + next_lo - lo0);
      // B and the row table of the next strip (the next run's first)
      if (!last) {
        stage_b(s + 1);
        fill_rows((sc + 1) & 1, s + 1, n, lo0);
      } else if (ri + 1 < r1) {
        const int s1 = __ldg(p.runs + ri + 1).z;
        stage_b(s1);
        fill_rows((sc + 1) & 1, s1, n + bands.y - lo0 + 1,
                  strip_bands(p, s1).x);
      }
      ++sc;
      if (!(kKnockout & 1)) {
        const int o0 = s * kRows;
        const int rows = min(kRows, p.dst_rows - o0);
        for (int t = rg.x + wg; t < rg.x + rg.y; t += kGroups)
          passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads,
                             p.frags, t, rg.z, tid & 127, warp, gq, tq);
      }
    }
    n += strip_bands(p, run.z + run.w - 1).y - lo0 + 1;
  }
}

// Shared memory of one block of a plane (lab/resize_diag.py
// streamed_smem_bytes): the ring, the tiled H rows of its widest range,
// B, the row table and the barriers.
long long smem_bytes(const Plane& p, int ch) {
  return static_cast<long long>(p.slots) * p.band * kChunk * p.chunks +
         static_cast<long long>(p.hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) +
         2LL * p.k_pad * kRows + 8LL * p.k_pad + 8LL * (p.slots + 1);
}

template <int NK, int CH>
cudaError_t launch_nk(const CUtensorMap& map, const Plane& p, int nblocks,
                      cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(p, CH));
  const cudaError_t e = allow_smem(streamed_kernel<NK, CH>, smem);
  if (e != cudaSuccess) return e;
  streamed_kernel<NK, CH><<<nblocks, kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_plane(const CUtensorMap& map, const Plane& p, int nblocks,
                         cudaStream_t stream) {
  switch (p.k_pad / 16) {
#define NV12_STREAMED_NK(n) \
  case n:                   \
    return launch_nk<n, CH>(map, p, nblocks, stream);
    NV12_STREAMED_NK(1) NV12_STREAMED_NK(2) NV12_STREAMED_NK(3)
    NV12_STREAMED_NK(4) NV12_STREAMED_NK(5) NV12_STREAMED_NK(6)
    NV12_STREAMED_NK(7) NV12_STREAMED_NK(8) NV12_STREAMED_NK(9)
    NV12_STREAMED_NK(10) NV12_STREAMED_NK(11) NV12_STREAMED_NK(12)
    NV12_STREAMED_NK(13) NV12_STREAMED_NK(14) NV12_STREAMED_NK(15)
    NV12_STREAMED_NK(16)
#undef NV12_STREAMED_NK
  }
  return cudaErrorInvalidValue;
}

// A plane's tables as the launcher takes them, checked.
bool plane_ok(const Plane& p, int ch, int nranges, int nblocks) {
  return p.k_pad >= 16 && p.k_pad % 16 == 0 &&
         p.k_pad <= 16 * kMaxKSteps && nranges >= 1 && p.hcols >= 16 &&
         p.hcols % 16 == 0 && banded::aligned16(p.b) &&
         banded::aligned16(p.ranges) && banded::aligned16(p.frags) &&
         banded::aligned16(p.runs) && p.starts != nullptr &&
         p.heads != nullptr && p.blocks != nullptr && p.slots >= 1 &&
         nblocks >= 1 && p.chunks >= 1 && smem_bytes(p, ch) <= kSmemLimit;
}

}  // namespace

extern "C" {

// `streamed` over frame 0 of a [batch, >= src_h * 3 / 2, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes) into a contiguous
// [batch, dst_h * 3 / 2, dst_w] uint8 output. Per plane (luma, then the
// interleaved chroma rows; lab/resize_diag.py StreamedPlane, on the
// device): b [strips, k_pad * 32] bf16, starts [strips] int32, k_pad (a
// multiple of 16, at most 256), ranges [nranges, 4] int32, hcols (a
// multiple of 16), heads [tiles, 3] int32, frags [k-steps, 128] 16-byte
// words, the ring's slots, runs [nruns, 4] int32 and blocks [nblocks + 1]
// int32. `band` rows (a multiple of 8, at most 256) a box; `tma` 1 stages
// by TMA (the frames' start and strides must be multiples of 16 bytes),
// 0 by element loads. Two launches.
int nv12_resize_streamed_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_ranges, int y_nranges,
    int y_hcols, const int* y_heads, const void* y_frags, int y_slots,
    const int* y_runs, const int* y_blocks, int y_nblocks, const void* c_b,
    const int* c_starts, int c_k_pad, const int* c_ranges, int c_nranges,
    int c_hcols, const int* c_heads, const void* c_frags, int c_slots,
    const int* c_runs, const int* c_blocks, int c_nblocks, int band, int tma,
    void* out, void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (src_w <= 0 || src_h <= 0 || (src_w & 1) || (src_h & 1) ||
      (dst_w & 1) || (dst_h & 1) || band < 8 || band % 8 ||
      band > kMaxBand ||
      (tma && !tma::rows_mappable(src, row_stride, batch_stride)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plane y{static_cast<const uint8_t*>(src), batch_stride, row_stride, src_h,
          src_w, tma, static_cast<uint8_t*>(out),
          static_cast<long long>(dst_h) * 3 / 2 * dst_w, dst_h, dst_w,
          static_cast<const uint4*>(y_b), y_starts, y_k_pad,
          reinterpret_cast<const int4*>(y_ranges), y_hcols, y_heads,
          static_cast<const uint4*>(y_frags), y_slots, band,
          chunks_of(y_hcols, 1), reinterpret_cast<const int4*>(y_runs),
          y_blocks};
  Plane c = y;
  c.src = y.src + static_cast<long long>(src_h) * row_stride;
  c.rows = src_h / 2;
  c.out = y.out + static_cast<long long>(dst_h) * dst_w;
  c.dst_rows = dst_h / 2;
  c.b = static_cast<const uint4*>(c_b);
  c.starts = c_starts;
  c.k_pad = c_k_pad;
  c.ranges = reinterpret_cast<const int4*>(c_ranges);
  c.hcols = c_hcols;
  c.heads = c_heads;
  c.frags = static_cast<const uint4*>(c_frags);
  c.slots = c_slots;
  c.chunks = chunks_of(c_hcols, 2);
  c.runs = reinterpret_cast<const int4*>(c_runs);
  c.blocks = c_blocks;
  if (!plane_ok(y, 1, y_nranges, y_nblocks) ||
      !plane_ok(c, 2, c_nranges, c_nblocks))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ymap{}, cmap{};
  if (tma) {
    int e = tma::encode_rows(&ymap, y.src, src_w, src_h, batch, row_stride,
                             batch_stride, band);
    if (e == 0)
      e = tma::encode_rows(&cmap, c.src, src_w, src_h / 2, batch,
                           row_stride, batch_stride, band);
    if (e != 0) return e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_plane<1>(ymap, y, y_nblocks, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_plane<2>(cmap, c, c_nblocks, s));
}

#ifdef NV12_STREAMED_ENCODE
// The host work TMA adds to a launch: both planes' tensor maps encoded
// `reps` times for the launcher's frames. Only the A/B lab's build
// (lab/streamed_ab.py, -D NV12_STREAMED_ENCODE) has it, to time that work
// apart from the kernels. Returns a cudaError_t.
int nv12_streamed_encode(const void* src, long long batch_stride,
                         long long row_stride, int batch, int src_h,
                         int src_w, int band, int reps) {
  CUtensorMap map;
  const uint8_t* chroma =
      static_cast<const uint8_t*>(src) + static_cast<long long>(src_h) *
                                             row_stride;
  for (int i = 0; i < reps; ++i) {
    int e = tma::encode_rows(&map, src, src_w, src_h, batch, row_stride,
                             batch_stride, band);
    if (e == 0)
      e = tma::encode_rows(&map, chroma, src_w, src_h / 2, batch, row_stride,
                           batch_stride, band);
    if (e != 0) return e;
  }
  return 0;
}
#endif  // NV12_STREAMED_ENCODE

}  // extern "C"
