// Lab kernel `striped` of the 4K NV12 resize lab for Hopper (sm_90a): the
// NV12 resize with each strip's H pass cut into column stripes, the
// stripes of a strip one thread-block cluster that trades the W tiles'
// halo through distributed shared memory; both passes on the tensor cores.
//
// Replaces striped of resize_diag.py: on the TPU a frame's H pass runs in
// `nw` vertical stripes (grid (B, nw)), each writing its H rows into one
// frame-wide VMEM scratch (`store`: at a dynamic lane offset, through a
// relaid [nw, rows, SW] scratch, or under static offsets, one branch a
// stripe), and the last stripe runs the W pass. Stripes never overlap and
// never recompute a column. Its question here: does trading the halo
// between the stripes beat aligned's recomputing it?
//
// What bounds it on this card: the bytes. 16 x 4K NV12 -> 1080p reads
// 199 MB and writes 50 MB (0.074 ms at 3.35 TB/s); the products issue
// ~34 GFLOP with the zeros (0.034 ms at 989 TFLOP/s bf16).
//
// Tables: aligned's at h_align 8, w_align 32 (lab/resize_diag.py
// aligned_plane_tables: the strips' windows and B, the W tiles' heads and
// A fragments); no new weight table, so against aligned8x32 only the
// stripes differ. The host adds the cut (lab/resize_diag.py
// striped_plane_tables): stripes of `sw` bytes of a row (src_w / nw
// rounded down to 16 bytes, the last taking the rest up to the row's
// pixels rounded up to 16), the same bytes in both planes (chroma: sw / 2
// pixel pairs), so every stripe edge is a column group of 8 pixels. A W
// tile belongs to the stripe that holds its band's first column; its
// band's columns past that stripe are its halo, held by the stripes to its
// right. Per stripe: its tiles (a run of `order`), its own pixels, and the
// pixels it holds (own, then the halo its tiles read).
//
// Design: aligned's block (csrc/nv12_aligned.cu, passes in
// aligned_passes.cuh): 256 threads, 32-row strips, each 128-byte chunk of
// the window through the 3-stage cp.async ring, A built in registers from
// the raw bytes, the transposed H product, the W product per 64-pixel
// tile; one launch a plane, compiled per NK and plane so that no wgmma
// sits under a branch. Stores:
//   - dyn: grid (nw, strips, frames), cluster (nw, 1, 1) (at most 8, the
//     portable size), launched by cudaLaunchKernelEx; the stripe is
//     %cluster_ctarank. Each block runs the H pass over its own stripe's
//     chunks into its tiled H rows; cluster barrier (arrive.release, wait
//     .acquire: every stripe's H rows written); then it copies its halo's
//     column groups from the peers that hold them (mapa +
//     ld.shared::cluster) into its own shared memory right after its own
//     groups, so that the W product's B descriptor walks own + halo as one
//     band (wgmma reads only the block's own shared memory); it arrives on
//     a second cluster barrier (release: its reads of the peers are done),
//     runs the W product and uint8 store of its tiles (the two warpgroups
//     take alternate tiles) and waits on that barrier before it exits, so
//     no block leaves while a peer still reads its rows.
//   - unroll: as dyn, with the H pass compiled once a stripe (its index a
//     template parameter under a switch on the cluster rank, up to
//     kMaxStripes): the notebook's static offsets.
//   - relay: no cluster. Launch 1, grid (nw, strips, frames): the H pass
//     of each stripe into its tiled H rows, copied out to a bf16 scratch in
//     device memory laid out as the W product reads it ([frames][strips]
//     [column groups][rows][8], the wrapper allocates it); launch 2, grid
//     (tiles, strips, frames), one warpgroup: a tile's band of H rows
//     staged into shared memory, then the W product. The round trip the
//     TPU's VMEM spared.
// Waits that guard reuse and reads: a ring slot is refilled only after the
// __syncthreads that follows cp.async.wait_group of the stage before it
// (every warpgroup has built its A from that slot); the H rows are read by
// wgmma only after fence.proxy.async and a __syncthreads; a peer's rows
// are read only after the first cluster barrier (their writer's release,
// this block's acquire); a block's rows outlive its peers' reads by the
// second barrier, waited on before exit.
//
// Bits: each H column's sum takes the same window bytes, B and k-step
// order as aligned8x32's, each tile's W sum the same A fragments and H
// rows: equal to aligned8x32 bit for bit, so within the uint8 envelope of
// nv12_resize.
//
// The launcher returns cudaGetLastError() after its launches (or an error
// before any launch), runs on the caller's stream, and neither
// synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "aligned_passes.cuh"
#include "banded_common.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/striped_ab.py), 0 here:
// bit 1 skips the W pass, bit 2 the H pass's conversion and products (3:
// the staging ring alone), bit 4 the halo exchange and both cluster
// barriers (wrong bits: it times what the exchange costs).
#ifndef NV12_STRIPED_KNOCKOUT
#define NV12_STRIPED_KNOCKOUT 0
#endif

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::kSmemLimit;
using passes::kGroupBytes;
using passes::kRows;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::fence_proxy_async;
using wgmma::kStageCols;

constexpr int kKnockout = NV12_STRIPED_KNOCKOUT;
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStages = 3;       // ring depth: two stages in flight
constexpr int kMaxKSteps = 16;   // k_pad <= 256 window rows
constexpr int kMaxStripes = 8;   // a portable cluster; the unroll switch
constexpr int kWThreads = 128;   // relay's W launch: one warpgroup

enum Store { kDyn = 0, kRelay = 1, kUnroll = 2 };

// 16-byte words of one column group's H rows (kRows rows, chroma's U then
// V rows, of 8 bf16); in shared memory a group has one word more.
template <int CH>
constexpr int kWords = kRows * CH;

// One plane's launch: its frames, output, aligned's tables and the cut.
struct Plane {
  const uint8_t* src;  // plane row 0 of frame 0
  long long bs, rs;    // batch and row strides of the frames (bytes)
  int rows, bytes;     // plane rows; bytes of a row
  int vec;             // 16-byte cp.async copies
  uint8_t* out;        // output plane row 0 of frame 0
  long long out_bs;    // output batch stride
  int dst_rows, dst_w;  // output rows; bytes of an output row
  const uint4* b;       // [strips][k_pad * kRows / 8] bf16, core matrices
  const int* starts;    // [strips] first plane row of each window
  int k_pad;
  const int4* stripes;  // [nw]: first entry of order, entries, own, held px
  int hcols;            // the most pixels a stripe holds
  int wcols;            // the widest tile band (pixels): relay's W launch
  const int* order;     // [tiles] the tiles, stripe by stripe
  const int* heads;     // [tiles][3]: first k-step, first pixel, k-steps
  const uint4* frags;   // [k-steps][128] bf16 A fragments
  int nw, spx;          // stripes; pixels of each but the last
  int strips;           // output strips of kRows rows
  int groups;           // column groups of a row (its pixels rounded to 16)
  uint4* scratch;       // relay: [frames][strips][groups][kWords] or null
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at `local`'s offset in the shared memory of cluster block `rank`.
__device__ __forceinline__ uint4 ld_peer(const void* local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(wgmma::smem_u32(local)), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// aligned's H pass of stripe s over strip blockIdx.y of frame blockIdx.z:
// the strip's B into `bw` (after the ring's first stages are issued), then
// its own pixels' chunks through the ring into the tiled H rows at
// `hrows`. Every thread's cp.async groups have landed when it returns.
template <int NK, int CH>
__device__ __forceinline__ void h_pass(const Plane& p, int s, int own,
                                       unsigned char* hrows,
                                       unsigned char* bw,
                                       unsigned char* ring) {
  constexpr int kp = 16 * NK;
  const int tid = threadIdx.x;
  const int strip = blockIdx.y;
  const int xb0 = s * p.spx * CH;  // the stripe's first byte of a row
  const int hbytes = own * CH;     // bytes of its own columns
  const int nstages = (hbytes + kStageCols - 1) / kStageCols;
  const uint8_t* base = p.src + blockIdx.z * p.bs + xb0;
  const int end = p.bytes - xb0;       // bytes of a row from the stripe
  const int lim = min(end, hbytes);    // the bytes the ring copies
  const int w0 = __ldg(p.starts + strip), last = p.rows - 1;
  const auto row_of = [=](int k) { return min(w0 + k, last); };

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nstages)
      wgmma::issue_stage<kThreads>(ring + i * kp * kStageCols, base, p.rs,
                                   i * kStageCols, kp, lim, p.vec, row_of);
    else
      cp_async_commit();
  }
  const uint4* bsrc = p.b + static_cast<long long>(strip) * kp * kRows / 8;
  for (int i = tid; i < kp * kRows / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  fence_proxy_async();  // B, read by wgmma

  const int wg = tid >> 7;                  // warpgroup: 64 stage columns
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int ccol = 64 * wg + 16 * ((tid >> 5) & 3) + 2 * gq;
  const uint64_t bdesc = wgmma::desc(bw, 128, 256);

  for (int i = 0; i < nstages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; slot (i - 1) % kStages is free
    if (i + kStages - 1 < nstages)
      wgmma::issue_stage<kThreads>(
          ring + (i + kStages - 1) % kStages * kp * kStageCols, base, p.rs,
          (i + kStages - 1) * kStageCols, kp, lim, p.vec, row_of);
    else
      cp_async_commit();
    if (kKnockout & 2) continue;
    unsigned a[NK][4];
    wgmma::ring_fragments<NK>(a, ring + i % kStages * kp * kStageCols, ccol,
                              tq);
    float d[kRows / 2];
    passes::h_product<NK>(d, a, bdesc);
    passes::store_h<CH>(hrows, d, i * kStageCols + ccol, hbytes, end, tq);
  }
  cp_async_wait<0>();
}

// One block of a stripe: (stripe, strip blockIdx.y, frame blockIdx.z).
template <int NK, int CH, int STORE>
__global__ void __launch_bounds__(kThreads, 2) striped_kernel(Plane p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kGroup = kGroupBytes<CH>;
  constexpr int kp = 16 * NK;
  unsigned char* hrows = smem;                       // tiled H rows
  unsigned char* bw = hrows + p.hcols / 8 * kGroup;  // B: [kp, kRows]
  unsigned char* ring = bw + kp * kRows * 2;  // kStages x [kp, 128] bytes
  const int tid = threadIdx.x;
  const int strip = blockIdx.y;
  const int s = STORE == kRelay ? static_cast<int>(blockIdx.x)
                                : static_cast<int>(cluster_rank());
  const int4 st = __ldg(p.stripes + s);  // first, tiles, own, held
  const int x0 = s * p.spx;              // the stripe's first pixel

  if constexpr (STORE == kUnroll) {
    // the H pass compiled once a stripe, its offsets compile-time
    // multiples of the stripe width (the notebook's static offsets)
    switch (s) {
#define NV12_STRIPED_CASE(n)                         \
  case n:                                            \
    h_pass<NK, CH>(p, n, st.z, hrows, bw, ring); \
    break;
      NV12_STRIPED_CASE(0) NV12_STRIPED_CASE(1) NV12_STRIPED_CASE(2)
      NV12_STRIPED_CASE(3) NV12_STRIPED_CASE(4) NV12_STRIPED_CASE(5)
      NV12_STRIPED_CASE(6)
#undef NV12_STRIPED_CASE
      default:
        h_pass<NK, CH>(p, kMaxStripes - 1, st.z, hrows, bw, ring);
    }
  } else {
    h_pass<NK, CH>(p, s, st.z, hrows, bw, ring);
  }

  if constexpr (STORE == kRelay) {
    __syncthreads();  // every thread's H rows written
    // own groups -> the scratch, laid out as the W product reads them
    uint4* dst = p.scratch +
                 ((static_cast<long long>(blockIdx.z) * p.strips + strip) *
                      p.groups + x0 / 8) * kWords<CH>;
    const uint4* h4 = reinterpret_cast<const uint4*>(hrows);
    for (int i = tid; i < st.z / 8 * kWords<CH>; i += kThreads) {
      const int g = i / kWords<CH>, w = i - g * kWords<CH>;
      dst[i] = h4[g * (kWords<CH> + 1) + w];
    }
    return;
  } else {
    constexpr bool kExchange = !(kKnockout & 4);
    if (kExchange) {
      cluster_arrive();  // release: this stripe's H rows
      cluster_wait();    // acquire: every peer's
      // the halo's column groups from the stripes that hold them
      uint4* h4 = reinterpret_cast<uint4*>(hrows);
      const int g0 = st.z / 8;
      for (int i = tid; i < (st.w / 8 - g0) * kWords<CH>; i += kThreads) {
        const int g = g0 + i / kWords<CH>;
        const int w = i - (g - g0) * kWords<CH>;
        const int c = x0 + 8 * g;                 // the group's first pixel
        const int peer = min(c / p.spx, p.nw - 1);
        const int pg = (c - peer * p.spx) / 8;    // its group in the peer
        h4[g * (kWords<CH> + 1) + w] =
            ld_peer(h4 + pg * (kWords<CH> + 1) + w, peer);
      }
      cluster_arrive();  // release: done reading the peers
    }
    fence_proxy_async();  // the H rows, read by wgmma in the W pass
    __syncthreads();
    if (!(kKnockout & 1)) {
      const int wg = tid >> 7, lane = tid & 31;
      const int o0 = strip * kRows;
      const int rows = min(kRows, p.dst_rows - o0);
      uint8_t* ob = p.out + blockIdx.z * p.out_bs;
      for (int i = st.x + wg; i < st.x + st.y; i += 2)
        passes::w_tile<CH>(ob, o0, rows, p.dst_w, hrows, p.heads, p.frags,
                           __ldg(p.order + i), x0, tid & 127,
                           (tid >> 5) & 3, lane >> 2, lane & 3);
    }
    if (kExchange) cluster_wait();  // no peer reads these rows any more
  }
}

// relay's W launch: one block a (tile, strip, frame), one warpgroup: the
// tile's band of H rows from the scratch into shared memory, then
// aligned's W product and store.
template <int CH>
__global__ void __launch_bounds__(kWThreads) relay_w_kernel(Plane p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int t = blockIdx.x, strip = blockIdx.y;
  const int c0 = __ldg(p.heads + 3 * t + 1);
  const int nk = __ldg(p.heads + 3 * t + 2);
  const uint4* src = p.scratch +
                     ((static_cast<long long>(blockIdx.z) * p.strips + strip) *
                          p.groups + c0 / 8) * kWords<CH>;
  uint4* h4 = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < 2 * nk * kWords<CH>; i += kWThreads) {
    const int g = i / kWords<CH>, w = i - g * kWords<CH>;
    h4[g * (kWords<CH> + 1) + w] = src[i];
  }
  fence_proxy_async();  // the H rows, read by wgmma
  __syncthreads();
  const int lane = tid & 31;
  const int o0 = strip * kRows;
  passes::w_tile<CH>(p.out + blockIdx.z * p.out_bs, o0,
                     min(kRows, p.dst_rows - o0), p.dst_w, smem, p.heads,
                     p.frags, t, c0, tid, tid >> 5, lane >> 2, lane & 3);
}

// Shared memory of one block of a plane (lab/resize_diag.py
// striped_smem_bytes): the tiled H rows of the most pixels a stripe holds,
// B and the ring.
long long smem_bytes(int ch, int hcols, int k_pad) {
  return static_cast<long long>(hcols) / 8 *
             (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) +
         2LL * k_pad * kRows +
         static_cast<long long>(kStages) * k_pad * kStageCols;
}

// Resident clusters of a kernel at a shared-memory size and cluster size,
// queried once each (cudaOccupancyMaxActiveClusters).
struct Residency {
  const void* fn;
  size_t smem;
  int nw, clusters;
};
std::mutex g_residency_lock;
Residency g_residency[256];
int g_residencies = 0;

template <typename K>
cudaError_t resident_clusters(K kern, const cudaLaunchConfig_t& cfg,
                              int* clusters) {
  const void* fn = reinterpret_cast<const void*>(kern);
  const int nw = static_cast<int>(cfg.gridDim.x);
  std::lock_guard<std::mutex> guard(g_residency_lock);
  for (int i = 0; i < g_residencies; ++i) {
    const Residency& r = g_residency[i];
    if (r.fn == fn && r.smem == cfg.dynamicSmemBytes && r.nw == nw) {
      *clusters = r.clusters;
      return cudaSuccess;
    }
  }
  const cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (g_residencies < 256)
    g_residency[g_residencies++] = Residency{fn, cfg.dynamicSmemBytes, nw,
                                             *clusters};
  return cudaSuccess;
}

// One plane's launches; `resident` gets the clusters that can be resident
// at once (relay: 0). batch 0 queries and launches nothing.
template <int NK, int CH, int STORE>
cudaError_t launch_nk(const Plane& p, int batch, cudaStream_t stream,
                      int* resident) {
  const size_t smem =
      static_cast<size_t>(smem_bytes(CH, p.hcols, p.k_pad));
  cudaError_t e = allow_smem(striped_kernel<NK, CH, STORE>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nw, p.strips, batch > 0 ? batch : 1);
  if constexpr (STORE == kRelay) {
    *resident = 0;
    if (batch <= 0) return cudaSuccess;
    striped_kernel<NK, CH, STORE><<<grid, kThreads, smem, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess || (kKnockout & 1)) return e;
    const int tiles = (p.dst_w / CH + passes::kWTile - 1) / passes::kWTile;
    const size_t wsmem = static_cast<size_t>(p.wcols / 8) * kGroupBytes<CH>;
    e = allow_smem(relay_w_kernel<CH>, wsmem);
    if (e != cudaSuccess) return e;
    relay_w_kernel<CH><<<dim3(tiles, p.strips, batch), kWThreads, wsmem,
                         stream>>>(p);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.nw;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = resident_clusters(striped_kernel<NK, CH, STORE>, cfg, resident);
    if (e != cudaSuccess) return e;
    if (*resident < 1) return cudaErrorLaunchOutOfResources;
    if (batch <= 0) return cudaSuccess;
    e = cudaLaunchKernelEx(&cfg, striped_kernel<NK, CH, STORE>, p);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
}

template <int CH, int STORE>
cudaError_t launch_plane(const Plane& p, int batch, cudaStream_t stream,
                         int* resident) {
  switch (p.k_pad / 16) {
#define NV12_STRIPED_NK(n) \
  case n:                  \
    return launch_nk<n, CH, STORE>(p, batch, stream, resident);
    NV12_STRIPED_NK(1) NV12_STRIPED_NK(2) NV12_STRIPED_NK(3)
    NV12_STRIPED_NK(4) NV12_STRIPED_NK(5) NV12_STRIPED_NK(6)
    NV12_STRIPED_NK(7) NV12_STRIPED_NK(8) NV12_STRIPED_NK(9)
    NV12_STRIPED_NK(10) NV12_STRIPED_NK(11) NV12_STRIPED_NK(12)
    NV12_STRIPED_NK(13) NV12_STRIPED_NK(14) NV12_STRIPED_NK(15)
    NV12_STRIPED_NK(16)
#undef NV12_STRIPED_NK
  }
  return cudaErrorInvalidValue;
}

template <int CH>
cudaError_t launch_store(const Plane& p, int store, int batch,
                         cudaStream_t stream, int* resident) {
  switch (store) {
    case kDyn:
      return launch_plane<CH, kDyn>(p, batch, stream, resident);
    case kRelay:
      return launch_plane<CH, kRelay>(p, batch, stream, resident);
    default:
      return launch_plane<CH, kUnroll>(p, batch, stream, resident);
  }
}

// A plane's tables as the launcher takes them, checked.
bool plane_ok(const Plane& p, int ch, int store) {
  return p.k_pad >= 16 && p.k_pad % 16 == 0 &&
         p.k_pad <= 16 * kMaxKSteps && p.nw >= 1 &&
         (store == kRelay || p.nw <= kMaxStripes) && p.spx >= 8 &&
         p.spx % 8 == 0 && p.hcols >= 8 && p.hcols % 8 == 0 &&
         p.wcols >= 16 && p.wcols % 16 == 0 &&
         (store != kRelay ||
          static_cast<long long>(p.wcols) / 8 *
                  (ch == 1 ? kGroupBytes<1> : kGroupBytes<2>) <=
              kSmemLimit) &&
         (p.nw - 1) * p.spx < p.groups * 8 && aligned16(p.b) &&
         aligned16(p.stripes) && aligned16(p.frags) &&
         p.starts != nullptr && p.heads != nullptr && p.order != nullptr &&
         (store != kRelay || aligned16(p.scratch)) &&
         smem_bytes(ch, p.hcols, p.k_pad) <= kSmemLimit;
}

}  // namespace

extern "C" {

// `striped` over frame 0 of a [batch, >= src_h * 3 / 2, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes) into a contiguous
// [batch, dst_h * 3 / 2, dst_w] uint8 output. Per plane (luma, then the
// interleaved chroma rows; lab/resize_diag.py StripedPlane, on the
// device): b [strips, k_pad * 32] bf16 (strips = ceil(rows / 32)), starts
// [strips] int32, k_pad (a multiple of 16, at most 256), stripes [nw, 4]
// int32, hcols (the most pixels a stripe holds, a multiple of 8), wcols
// (the widest tile band, pixels), order [tiles] int32, heads [tiles, 3]
// int32, frags [k-steps, 128] 16-byte words. Then nw stripes of sw bytes
// of a row (a multiple of 16; the last takes the rest), store (0 dyn, 1
// relay, 2 unroll), the relay store's scratch (per plane [batch][strips]
// [pixels rounded to 16 / 8][32 ch][8] bf16, luma then chroma; else null)
// and `resident` (null, or two ints that get each plane's resident
// clusters: 0 for relay). Two launches (dyn, unroll: one cluster launch a
// plane) or four (relay); batch 0 checks the tables and queries residency
// without a launch. An error, before any launch, where no cluster of nw
// blocks can be resident.
int nv12_resize_striped_launch(
    const void* src, long long batch_stride, long long row_stride, int batch,
    int src_h, int src_w, int dst_h, int dst_w, const void* y_b,
    const int* y_starts, int y_k_pad, const int* y_stripes, int y_hcols,
    int y_wcols, const int* y_order, const int* y_heads, const void* y_frags,
    const void* c_b, const int* c_starts, int c_k_pad, const int* c_stripes,
    int c_hcols, int c_wcols, const int* c_order, const int* c_heads,
    const void* c_frags,
    int nw, int sw, int store, void* scratch, int* resident, void* out,
    void* stream) {
  if (dst_h <= 0 || dst_w <= 0 || batch < 0) return 0;
  if (batch > 65535 || src_w <= 0 || src_h <= 0 || (src_w & 1) ||
      (src_h & 1) || (dst_w & 1) || (dst_h & 1) || sw < 16 || sw % 16 ||
      nw < 1 || static_cast<long long>(nw) * sw > src_w || store < kDyn ||
      store > kUnroll || (store == kRelay && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(src) && src_w % 16 == 0 &&
                   batch_stride % 16 == 0 && row_stride % 16 == 0;
  const int y_groups = (src_w + 15) / 16 * 2;
  const int c_groups = (src_w / 2 + 15) / 16 * 2;
  Plane y{static_cast<const uint8_t*>(src), batch_stride, row_stride, src_h,
          src_w, vec, static_cast<uint8_t*>(out),
          static_cast<long long>(dst_h) * 3 / 2 * dst_w, dst_h, dst_w,
          static_cast<const uint4*>(y_b), y_starts, y_k_pad,
          reinterpret_cast<const int4*>(y_stripes), y_hcols, y_wcols, y_order,
          y_heads, static_cast<const uint4*>(y_frags), nw, sw,
          (dst_h + kRows - 1) / kRows, y_groups,
          static_cast<uint4*>(scratch)};
  Plane c = y;
  c.src = y.src + static_cast<long long>(src_h) * row_stride;
  c.rows = src_h / 2;
  c.out = y.out + static_cast<long long>(dst_h) * dst_w;
  c.dst_rows = dst_h / 2;
  c.b = static_cast<const uint4*>(c_b);
  c.starts = c_starts;
  c.k_pad = c_k_pad;
  c.stripes = reinterpret_cast<const int4*>(c_stripes);
  c.hcols = c_hcols;
  c.wcols = c_wcols;
  c.order = c_order;
  c.heads = c_heads;
  c.frags = static_cast<const uint4*>(c_frags);
  c.spx = sw / 2;
  c.strips = (dst_h / 2 + kRows - 1) / kRows;
  c.groups = c_groups;
  if (scratch != nullptr)
    c.scratch = y.scratch + static_cast<long long>(batch) * y.strips *
                                y_groups * kWords<1>;
  if (!plane_ok(y, 1, store) || !plane_ok(c, 2, store))
    return static_cast<int>(cudaErrorInvalidValue);
  int res[2] = {0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // both planes' residency before either launches
  cudaError_t e = launch_store<1>(y, store, 0, s, res);
  if (e == cudaSuccess) e = launch_store<2>(c, store, 0, s, res + 1);
  if (resident != nullptr) {
    resident[0] = res[0];
    resident[1] = res[1];
  }
  if (e != cudaSuccess || batch == 0) return static_cast<int>(e);
  e = launch_store<1>(y, store, batch, s, res);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_store<2>(c, store, batch, s, res + 1));
}

}  // extern "C"
