// Lab kernel `slabs` of the 4K NV12 resize lab for Hopper (sm_90a): the
// NV12 resize with each H-pass sum split by the buffer's row slabs,
// aligned's tensor-core passes fed by TMA boxes, one mbarrier a slab piece.
//
// Replaces slabs of resize_diag.py: on the TPU the NV12 buffer's rows are
// cut into `nslabs` slabs, each strip's window is copied slab by slab with
// its own DMA and semaphore, and each piece's rows are multiplied into
// their own fp32 partial as soon as they land, the partials added in slab
// order (split-K). Its question: do several copies in flight per block,
// summed as they land, beat one copy? Here: TMA boxes against one mbarrier
// per piece under aligned's products.
//
// What bounds it on this card: the bytes. 16 x 4K NV12 -> 1080p reads
// 199 MB and writes 50 MB (0.074 ms at 3.35 TB/s); the products issue
// ~35 GFLOP with the zeros (aligned's tables at 8x32, plus a chain a piece
// in the strips that straddle a slab edge: 0.036 ms at 989 TFLOP/s bf16).
//
// Design. aligned's block (nv12_aligned.cu): one launch a plane, compiled
// per K / 16 (NK) and plane (CH) so that no wgmma sits under a branch,
// blocks of (column range, strip of kRows output rows, frame), 256
// threads, two blocks an SM, its window starts, W tables and W pass
// (aligned_passes.cuh). The host (lab/resize_diag.py slabs_plane_tables)
// cuts each strip's window at the buffer's slab edges (buffer rows that
// are multiples of slab_rows; the luma plane starts at buffer row 0, the
// chroma plane at src_h) and lists the pieces with a nonzero weight in
// slab order: each piece's k-steps (those of its nonzero rows: a k-step
// that straddles an edge belongs to both pieces), its B_p (aligned's B at
// those k-steps with the rows outside the piece zero) and its boxes (its
// k-steps not already the piece before's).
//   - Staging: a ring of kStages stages of [k_pad, 128 bytes], one stage a
//     128-byte column chunk of the range, filled two stages ahead. Each
//     issued k-step of the window is one TMA box [16 rows, 128 bytes] from
//     the window's first row (any alignment: the 128-byte swizzle follows
//     the shared-memory address, so window row k lands at k * 128, its
//     16-byte chunk c at c ^ (k mod 8)), counted against the barrier of
//     the piece that owns it: one mbarrier per (stage, piece). TMA zero-
//     fills rows and columns past the plane (rows there weigh 0). One
//     thread arms the barriers and issues the boxes. Where the frames
//     cannot be a tensor map, every thread fills its share of the same
//     stage with element loads and arrives on the piece's barrier; with
//     NV12_SLABS_CPASYNC it fills it with 16-byte cp.async copies, one
//     cp.async.mbarrier arrive a piece.
//   - Split-K H product: per stage, wait for every piece's barrier, build
//     the A fragments of the stage's NK k-steps once from the raw bytes
//     (rows 2 tq (+1, +8, +9) of the thread's two byte columns:
//     wgmma_common.cuh ring_step at TMA's offsets, the same for every
//     k-step, as aligned builds them), then one straight-line chain of NK
//     m64n32k16 products per piece in slab order, each into a fresh fp32
//     accumulator. The first piece's B_p lies in shared memory at its
//     window k-steps with zero blocks around it, so its chain is aligned's
//     H product (aligned_passes.cuh h_product); a later piece's chain (a
//     run-time loop) takes k-step i against its B_p block where i is one
//     of its k-steps, else against a zero block (a descriptor select: no
//     wgmma or its registers under a branch, which would make ptxas
//     serialize them). The partials are added in slab order (p0 + p1 +
//     ..., as slabs_resize_plain adds them), then the sum is rounded to
//     bf16 into aligned's H rows. (A built per piece from its own k-steps
//     at run-time offsets made the H pass 2.5x aligned's: PERF.md §6.)
//   - W pass: aligned_passes.cuh's product and store per tile of the
//     range, the two warpgroups taking alternate tiles.
//   - Hazards: a stage's slot is refilled only after the __syncthreads that
//     follows every thread's reads of the stage before (behind a proxy
//     fence); every (stage, piece) barrier completes once per fill, its
//     parity the stage's use count; B (generic stores, read by wgmma) and
//     the H rows are fenced to the async proxy and barriered before their
//     reads; a k-step that no piece issues is not staged, and its stale
//     bytes (finite, as every byte is) meet only the zero block. Every
//     wait traps after ~2 s.
//
// Bits: a row whose band lies in one slab takes aligned's products at
// 8x32 (the same A, the same B columns, the same k-step order) with exact
// zeros added, so it equals aligned8x32's; a row that straddles adds two
// fp32 partials, within the uint8 envelope of slabs_resize_plain and
// nv12_resize. The lab counts the differing samples.
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

// Build knobs of the A/B lab (vali_tpu_torch/lab/slabs_ab.py), 0 here:
// NV12_SLABS_KNOCKOUT bit 1 skips the W pass, bit 2 the H pass's
// conversion and products (3: the staging alone, every piece still waited
// for); NV12_SLABS_CPASYNC 1 stages the views TMA could take by cp.async.
#ifndef NV12_SLABS_KNOCKOUT
#define NV12_SLABS_KNOCKOUT 0
#endif
#ifndef NV12_SLABS_CPASYNC
#define NV12_SLABS_CPASYNC 0
#endif

namespace {

using banded::allow_smem;
using banded::kSmemLimit;
using passes::kGroupBytes;
using passes::kRows;
using wgmma::kStageCols;

constexpr int kKnockout = NV12_SLABS_KNOCKOUT;
constexpr bool kCpAsync = NV12_SLABS_CPASYNC != 0;
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStages = 3;       // ring depth: two stages in flight
constexpr int kMaxKSteps = 16;   // k_pad <= 256 window rows
constexpr int kMaxPieces = 8;    // issued pieces of a window: its barriers
constexpr int kBoxBytes = 16 * kStageCols;  // a k-step of a stage: a box
constexpr int kBlockBytes = 16 * kRows * 2;  // a k-step of B

// One plane's launch: its frames, output and tables (lab/resize_diag.py
// SlabsPlane).
struct Plane {
  const uint8_t* src;  // plane row 0 of frame 0
  long long bs, rs;    // batch and row strides of the frames (bytes)
  int rows, bytes;     // plane rows; bytes of a row
  int tma;             // the frames can be a tensor map (else element loads)
  uint8_t* out;        // output plane row 0 of frame 0
  long long out_bs;    // output batch stride
  int dst_rows, dst_w;  // output rows; bytes of an output row
  const uint4* b;       // [k-steps][kBlockBytes / 16]: B_p, core matrices
  const int* starts;    // [strips] first plane row of each window
  int k_pad;
  const int4* ranges;   // [ranges]: first tile, tiles, first H pixel, H pixels
  int hcols;            // H columns (pixels) of the widest range
  const int* heads;     // [tiles][3]: first k-step, first pixel, k-steps
  const uint4* frags;   // [k-steps][128] bf16 A fragments
  const int* pfirst;    // [strips + 1]: each strip's first issued piece
  const int4* pieces;   // first k-step, k-steps, first block of b, boxes
  int blocks;           // B's blocks in shared memory, the most a strip has
};

// 16 bytes by cp.async, the first `n` from `src` and the rest zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wgmma::smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued has landed (the
// barrier's count holds the arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(tma::smem_u32(bar))
               : "memory");
}

// The A fragments of a stage's NK k-steps: a[ks] = window rows 16 ks +
// 2 tq (+1, +8, +9) of the thread's two byte columns at TMA's offsets
// `off` (the same for every k-step: 16 rows are 2048 bytes).
template <int NK>
__device__ __forceinline__ void stage_fragments(unsigned (&a)[NK][4],
                                                const unsigned char* stage,
                                                const int (&off)[4]) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const uint4 f = wgmma::ring_step(stage + ks * kBoxBytes, off);
    a[ks][0] = f.x;
    a[ks][1] = f.y;
    a[ks][2] = f.z;
    a[ks][3] = f.w;
  }
}

// d = one piece's partial: a chain of NK products over the stage's
// k-steps, k-step i against the piece's B_p block i - ks0 (block 0 at
// descriptor `bdesc`) where it is one of the piece's n k-steps, else
// against the zero block at `zdesc` (the descriptors are selected, not
// branched on). Waits for the products.
template <int NK>
__device__ __forceinline__ void piece_product(float (&d)[kRows / 2],
                                              const unsigned (&a)[NK][4],
                                              uint64_t bdesc, uint64_t zdesc,
                                              int ks0, int n) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) d[i] = 0.0f;
  wgmma::fence();
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const bool live = i >= ks0 && i < ks0 + n;
    wgmma::mma<kRows>(d, make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]),
                      live ? bdesc + (((i - ks0) * kBlockBytes) >> 4)
                           : zdesc);
  }
  wgmma::commit();
  wgmma::wait_all();
}

template <int NK, int CH>
__global__ void __launch_bounds__(kThreads, 2)
    slabs_kernel(__grid_constant__ const CUtensorMap map, Plane p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr int kp = 16 * NK;
  constexpr int kStage = kp * kStageCols;  // bytes of a stage
  unsigned char* ring = smem;                           // kStages stages
  unsigned char* hrows = ring + kStages * kStage;       // tiled H rows
  unsigned char* bw = hrows + p.hcols / 8 * kGroup;     // B's blocks
  uint64_t* full =  // after B's blocks and one zero block
      reinterpret_cast<uint64_t*>(bw + (p.blocks + 1) * kBlockBytes);
  int4* pieces = reinterpret_cast<int4*>(full + kStages * kMaxPieces);
  const int tid = threadIdx.x;
  const int strip = blockIdx.y;
  const int4 rg = __ldg(p.ranges + blockIdx.x);
  const int xb0 = rg.z * CH;      // the range's first byte of a row
  const int hbytes = rg.w * CH;   // bytes of its H columns
  const int nstages = (hbytes + kStageCols - 1) / kStageCols;
  const int o0 = strip * kRows;
  const int rows = min(kRows, p.dst_rows - o0);
  const uint8_t* base = p.src + blockIdx.z * p.bs + xb0;
  const int end = p.bytes - xb0;  // bytes of a row from the range's start
  const int w0 = __ldg(p.starts + strip);
  const int pf = __ldg(p.pfirst + strip);
  const int np = __ldg(p.pfirst + strip + 1) - pf;
  const bool by_tma = p.tma && !kCpAsync;

  // the strip's pieces into shared memory, read at every stage
  if (tid < np && tid < kMaxPieces) pieces[tid] = __ldg(p.pieces + pf + tid);
  if (tid == 0) {
    if (tma::smem_u32(smem) & 1023) __trap();  // the swizzle's atoms
    if (np < 1 || np > kMaxPieces) __trap();   // the host's refusal
    for (int s = 0; s < kStages; ++s)
      for (int q = 0; q < np; ++q)
        tma::mbar_init(full + s * kMaxPieces + q, by_tma ? 1 : kThreads);
    tma::fence_mbar_init();
  }
  __syncthreads();
  const int4 first = pieces[0];  // its B_p the strip's first block
  const int q0 = first.z;

  // Stage s into its slot, piece by piece: each piece's boxes (its last
  // `boxes` k-steps) against its own barrier of the slot.
  const auto fill = [&](int s) {
    unsigned char* stage = ring + s % kStages * kStage;
    uint64_t* bars = full + s % kStages * kMaxPieces;
    const int x0 = s * kStageCols;  // the stage's first byte of the range
    if (by_tma) {
      if (tid != 0) return;
      wgmma::fence_proxy_async();  // the slot's reads, then TMA's writes
      for (int q = 0; q < np; ++q) {
        const int4 pc = pieces[q];
        tma::mbar_expect(bars + q, pc.w * kBoxBytes);
        for (int k = pc.x + pc.y - pc.w; k < pc.x + pc.y; ++k)
          tma::load_box(stage + k * kBoxBytes, &map, xb0 + x0, w0 + 16 * k,
                        blockIdx.z, bars + q);
      }
      return;
    }
    for (int q = 0; q < np; ++q) {
      const int4 pc = pieces[q];
      const int r0 = 16 * (pc.x + pc.y - pc.w);  // the boxes' first row
      if (p.tma) {  // cp.async: 16-byte rows and strides
        for (int i = tid; i < 16 * pc.w * (kStageCols / 16); i += kThreads) {
          const int k = r0 + (i >> 3), c = x0 + 16 * (i & 7);
          const int n = w0 + k < p.rows ? max(0, min(16, end - c)) : 0;
          cp_async16(stage + tma::swizzle128(k * kStageCols + c - x0),
                     n > 0 ? base + (w0 + k) * p.rs + c : base, n);
        }
        cp_async_arrive(bars + q);
      } else {
        for (int i = tid; i < 16 * pc.w * kStageCols; i += kThreads) {
          const int k = r0 + i / kStageCols, c = i % kStageCols;
          stage[tma::swizzle128(k * kStageCols + c)] =
              w0 + k < p.rows && x0 + c < end
                  ? __ldg(base + (w0 + k) * p.rs + x0 + c)
                  : 0;
        }
        tma::mbar_arrive(bars + q);
      }
    }
  };
  for (int s = 0; s < kStages - 1 && s < nstages; ++s) fill(s);
  // B in shared memory: the first piece's B_p at its window k-steps (zero
  // blocks around it, so its chain is aligned's), then the later pieces'
  // blocks, and one zero block at the end
  const int later = pieces[np - 1].z + pieces[np - 1].y - q0 - first.y;
  constexpr int kWords = kBlockBytes / 16;
  for (int i = tid; i < (NK + later) * kWords; i += kThreads) {
    const int k = i / kWords;  // the block in shared memory
    const int z = k < NK ? k - first.x : first.y + k - NK;
    reinterpret_cast<uint4*>(bw)[i] =
        k >= NK || (z >= 0 && z < first.y)
            ? __ldg(p.b + static_cast<long long>(q0 + z) * kWords + i % kWords)
            : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < kWords; i += kThreads)  // the zero block
    reinterpret_cast<uint4*>(bw + p.blocks * kBlockBytes)[i] =
        make_uint4(0u, 0u, 0u, 0u);
  wgmma::fence_proxy_async();  // B, read by wgmma

  const int wg = tid >> 7;                  // warpgroup: 64 stage columns
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * wg + 16 * warp + 2 * gq;  // the thread's 2 columns
  // rows 2 tq (+1, +8, +9) of a k-step at the thread's columns, swizzled
  // as TMA lays them out (the same for every k-step: 16 rows are 2048
  // bytes)
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = tma::swizzle128((2 * tq + (j & 1) + 8 * (j >> 1)) * kStageCols +
                             ccol);
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);
  const uint64_t zdesc = wgmma::desc(bw + p.blocks * kBlockBytes, 128, 256);

  for (int s = 0; s < nstages; ++s) {
    __syncthreads();  // stage s - 1 read by every thread: its slot is free
    if (s + kStages - 1 < nstages) fill(s + kStages - 1);
    const unsigned char* stage = ring + s % kStages * kStage;
    uint64_t* bars = full + s % kStages * kMaxPieces;
    const unsigned parity = (s / kStages) & 1;
    for (int q = 0; q < np; ++q) tma::mbar_wait(bars + q, parity);
    if (kKnockout & 2) continue;
    unsigned a[NK][4];
    stage_fragments<NK>(a, stage, off);
    // the pieces' partials in slab order: the first into h, each later one
    // into its own accumulator, then added
    float h[kRows / 2];
    passes::h_product<NK>(h, a, bdesc);
    for (int q = 1; q < np; ++q) {
      const int4 pc = pieces[q];
      float d[kRows / 2];
      piece_product<NK>(
          d, a, bdesc + (((NK + pc.z - q0 - first.y) * kBlockBytes) >> 4),
          zdesc, pc.x, pc.y);
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) h[i] += d[i];
    }
    passes::store_h<CH>(hrows, h, s * kStageCols + ccol, hbytes, end, tq);
  }
  wgmma::fence_proxy_async();  // the H rows, read by wgmma in the W pass
  __syncthreads();
  if (kKnockout & 1) return;

  uint8_t* ob = p.out + blockIdx.z * p.out_bs;
  for (int t = rg.x + wg; t < rg.x + rg.y; t += 2)
    passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads, p.frags, t,
                       rg.z, tid & 127, warp, gq, tq);
}

// Shared memory of one block of a plane (lab/resize_diag.py
// slabs_smem_bytes): the ring, the tiled H rows of its widest range, B's
// blocks of the strip that has the most and a zero block, the barriers
// and the strip's pieces.
long long smem_bytes(const Plane& p, int ch) {
  return static_cast<long long>(kStages) * p.k_pad * kStageCols +
         static_cast<long long>(p.hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) +
         static_cast<long long>(p.blocks + 1) * kBlockBytes +
         (8LL * kStages + 16) * kMaxPieces;
}

template <int NK, int CH>
cudaError_t launch_nk(const CUtensorMap& map, const Plane& p, int nranges,
                      int batch, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(p, CH));
  const cudaError_t e = allow_smem(slabs_kernel<NK, CH>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nranges, (p.dst_rows + kRows - 1) / kRows, batch);
  slabs_kernel<NK, CH><<<grid, kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_plane(const CUtensorMap& map, const Plane& p, int nranges,
                         int batch, cudaStream_t stream) {
  switch (p.k_pad / 16) {
#define NV12_SLABS_NK(n) \
  case n:                \
    return launch_nk<n, CH>(map, p, nranges, batch, stream);
    NV12_SLABS_NK(1) NV12_SLABS_NK(2) NV12_SLABS_NK(3) NV12_SLABS_NK(4)
    NV12_SLABS_NK(5) NV12_SLABS_NK(6) NV12_SLABS_NK(7) NV12_SLABS_NK(8)
    NV12_SLABS_NK(9) NV12_SLABS_NK(10) NV12_SLABS_NK(11) NV12_SLABS_NK(12)
    NV12_SLABS_NK(13) NV12_SLABS_NK(14) NV12_SLABS_NK(15) NV12_SLABS_NK(16)
#undef NV12_SLABS_NK
  }
  return cudaErrorInvalidValue;
}

// A plane's tables as the launcher takes them, checked (the pieces a
// window issues are checked on the host: lab/resize_diag.py
// slabs_refusal).
bool plane_ok(const Plane& p, int ch, int nranges) {
  return p.k_pad >= 16 && p.k_pad % 16 == 0 &&
         p.k_pad <= 16 * kMaxKSteps && nranges >= 1 && p.hcols >= 16 &&
         p.hcols % 16 == 0 && p.blocks >= 1 && banded::aligned16(p.b) &&
         banded::aligned16(p.ranges) && banded::aligned16(p.frags) &&
         banded::aligned16(p.pieces) && p.starts != nullptr &&
         p.heads != nullptr && p.pfirst != nullptr &&
         smem_bytes(p, ch) <= kSmemLimit;
}

}  // namespace

extern "C" {

// `slabs` over frame 0 of a [batch, >= src_h * 3 / 2, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes) into a contiguous
// [batch, dst_h * 3 / 2, dst_w] uint8 output. Per plane (luma, then the
// interleaved chroma rows; lab/resize_diag.py SlabsPlane, on the device):
// b [k-steps, 512] bf16 (the pieces' B_p, a k-step a block, core
// matrices), starts [strips] int32, k_pad (a multiple of 16, at most 256),
// ranges [nranges, 4] int32, hcols (a multiple of 16), heads [tiles, 3]
// int32, frags [k-steps, 128] 16-byte words, pfirst [strips + 1] int32,
// pieces [pieces, 4] int32 (at most 8 a strip) and the most blocks of B a
// strip has in shared memory (k_pad / 16 for its first piece, then its
// later pieces' k-steps). `tma` 1 stages by TMA (the frames' start and
// strides must be multiples of 16 bytes), 0 by element loads. Two
// launches.
int nv12_resize_slabs_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_ranges, int y_nranges,
    int y_hcols, const int* y_heads, const void* y_frags,
    const int* y_pfirst, const int* y_pieces, int y_blocks, const void* c_b,
    const int* c_starts, int c_k_pad, const int* c_ranges, int c_nranges,
    int c_hcols, const int* c_heads, const void* c_frags,
    const int* c_pfirst, const int* c_pieces, int c_blocks, int tma,
    void* out, void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  if (batch > 65535 || src_w <= 0 || src_h <= 0 || (src_w & 1) ||
      (src_h & 1) || (dst_w & 1) || (dst_h & 1) ||
      (tma && !tma::rows_mappable(src, row_stride, batch_stride)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plane y{static_cast<const uint8_t*>(src), batch_stride, row_stride, src_h,
          src_w, tma, static_cast<uint8_t*>(out),
          static_cast<long long>(dst_h) * 3 / 2 * dst_w, dst_h, dst_w,
          static_cast<const uint4*>(y_b), y_starts, y_k_pad,
          reinterpret_cast<const int4*>(y_ranges), y_hcols, y_heads,
          static_cast<const uint4*>(y_frags), y_pfirst,
          reinterpret_cast<const int4*>(y_pieces), y_blocks};
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
  c.pfirst = c_pfirst;
  c.pieces = reinterpret_cast<const int4*>(c_pieces);
  c.blocks = c_blocks;
  if (!plane_ok(y, 1, y_nranges) || !plane_ok(c, 2, c_nranges))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ymap{}, cmap{};
  if (tma && !kCpAsync) {
    int e = tma::encode_rows(&ymap, y.src, src_w, src_h, batch, row_stride,
                             batch_stride, 16);
    if (e == 0)
      e = tma::encode_rows(&cmap, c.src, src_w, src_h / 2, batch,
                           row_stride, batch_stride, 16);
    if (e != 0) return e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_plane<1>(ymap, y, y_nranges, batch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_plane<2>(cmap, c, c_nranges, batch, s));
}

}  // extern "C"
