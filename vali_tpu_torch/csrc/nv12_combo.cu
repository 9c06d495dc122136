// Lab kernel `combo` of the NV12 preprocess lab for Hopper (sm_90a): G
// frames a block on static strips, both resize passes on the tensor
// cores, each chunk's W weights loaded once for the G frames.
//
// Replaces combo_kernel of bench_kernel_variants.py: on the TPU each grid
// step runs G frames of one strip of `tile` output rows over the
// notebook's static windows (strips of `tile` rows that start on multiples
// of 8 rows and share one length, zero taps included) and stacks the G
// frames' H rows into M of one banded W matmul (M = G * DH), so that one
// weight block is put to work on G frames. Its question on this card:
// is the frame count per block worth anything to a tensor-core block
// whose W weights are A fragments read from L2 (S2 at 16-row strips reads
// ~396 MB of them per 64 x 1080p batch, twice the frame bytes)?
//
// What bounds it on this card: the bytes (199 MB in, 9.6 MB out per
// 64 x 1080p -> 224 batch: 0.062 ms at 3.35 TB/s). The products it issues,
// zeros included, take 0.020 / 0.029 / 0.050 ms at 989 TFLOP/s bf16 at
// strips of 16 / 32 / 64 rows (lab/kernel_variants.py combo_work).
//
// Design. S2's block (nv12_static2.cu) and its host tables at (T, align 8)
// (ops/banded.py static2_tables: per strip its luma window of ky rows and
// chroma window of kc interleaved chroma rows, B_y [ky, T] and B_c [kc, T]
// in K-major core matrices; static2_w_tables: per 64-column output tile
// its first byte column x0 and its chunks of 64 frame bytes, each chunk's
// 4 luma and 2 chroma W k-steps of A fragments). One block per (output
// tile of 64 columns, strip of T rows, G frames), 256 threads: two
// warpgroups. B_y and B_c are loaded into shared memory once a block and
// serve all G frames.
//   - Ring. The stacked window rows (ky + kc) stream through a ring of
//     kStages slots by 16-byte cp.async copies two steps ahead (element
//     loads where the rows are not 16-byte aligned), one __syncthreads a
//     step. A step is one column group of one frame: the block walks the
//     G frames of a column group before the next group, so that a
//     warpgroup loads its chunk's W weights, 6 A fragments, once for the
//     G frames' steps.
//   - The W weights wait in registers between the frames' W products:
//     24 a thread, live over the H chains. At two blocks an SM (2x16, the
//     only instance whose 48 accumulators allow it) that fits 128
//     registers only with the copy loops of a step kept rolled (unrolled,
//     ptxas spilled); kept in shared memory instead, as wgmma's A read by
//     descriptor, they cost more than that (PERF.md §6).
//   - Per step, S2's block: the H chains D [64 columns, N] = A [64, ky] x
//     B_y and A [64, kc] x B_c with A built in registers from the raw ring
//     (wgmma_common.cuh ring_step), kHBatch k-steps a batch; the sums
//     rounded to bf16 into the warpgroup's H rows (N luma rows of 64
//     columns, N U and N V rows of 32 pixels); then that frame's W
//     products into that frame's accumulators: 4 luma wgmmas at N and 2
//     chroma wgmmas at 2N (one A of chroma weights serves U and V), then
//     one wait, so that the next step's H rows may overwrite these. So
//     each frame gets S2's wgmmas at S2's N, in S2's order: G wgmmas at
//     N = T rather than one at N = G T, since the tensor-core W pass does
//     not pay per wgmma (S2's sweep, PERF.md §5) and an accumulator's
//     sums then are S2's, bit for bit.
//   - Split of the two warpgroups, so that a thread holds at most 96 fp32
//     W accumulators (1.5 N a frame):
//       kChunks (2x16, 4x16, 2x32): S2's. A slot holds one frame's 128
//         columns; warpgroup w takes its chunk 2 q + w of column group q
//         for every frame, sums G frames (1.5 G T accumulators) and at the
//         end hands the other, through the ring's bytes, its partial sums
//         of the pixels the other finishes (G T 768 bytes). Bit-equal to
//         S2 at the same T.
//       kFrames (4x32: 1.5 G T = 192): a slot holds chunk q of two
//         frames, j and G / 2 + j, 64 columns each; warpgroup w owns
//         frames w G / 2 .. (w + 1) G / 2 - 1, walks every chunk of them
//         and sums them in one accumulator each (no exchange; the chunks
//         add in another order than S2's two partials).
//       kRows (T = 64): S2's layout at T = 64 needs 303,488 B, over a
//         block's, so a slot holds one 64-column chunk of one frame (the
//         ring 3 x (ky + kc) x 64 bytes) and both warpgroups read it:
//         warpgroup w owns strip rows 32 w .. 32 w + 31 (N = 32 in both
//         passes, B read 32 w rows in; 1.5 G 32 accumulators) of every
//         frame. No exchange.
//       kRounds (8x32: the notebook's M8): 8 frames of 32-row strips
//         would need 384 accumulators a thread in kFrames, so the block
//         walks its frames in G / 4 rounds of kFrames' 4x32 walk (frames
//         4 r .. 4 r + 3 in round r): each round loads each chunk's W
//         fragments once, sums its 4 frames (96 accumulators a thread),
//         and stores them while the ring already holds the next round's
//         first steps. So a block reads B once for 8 frames and the W
//         fragments once for 4.
//     The swizzle of a slot's rows (16-byte chunk ch of row k at ch xor
//     (k / 2 mod SC / 16)) keeps a warp's A-fragment reads of rows 2 tq
//     (+1, +8, +9) in distinct banks at either slot width SC.
//   - Tail: the product's CSC, round and clip (banded_preprocess.cuh
//     csc_store), per frame.
// The kernel is compiled per (G, T) instance; the k-step counts and the
// column groups are run-time loops and the frames of a group an unrolled
// loop, so that no wgmma sits under a branch (ptxas serializes wgmmas
// whose A registers are written under one).
//
// Bits: every bf16 x uint8 product is exact in fp32; the tensor cores add
// a k-step's products in their own order. kChunks gives S2's bits at the
// same T; kFrames and kRows sum the same products in another grouping.
// The lab holds it to the kernels' uint8 envelope and counts its
// differing samples against S2, nv12_preprocess and the plain version.
//
// The launcher returns cudaGetLastError() after the launch, runs on the
// caller's stream, and neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "banded_preprocess.cuh"
#include "wgmma_common.cuh"

// Build knob of the A/B lab (vali_tpu_torch/lab/combo_ab.py), 0 here: bit
// 1 skips the W pass, bit 2 the H pass's conversion and products (3: the
// staging ring alone).
#ifndef NV12_COMBO_KNOCKOUT
#define NV12_COMBO_KNOCKOUT 0
#endif

namespace {

using banded::aligned16;
using banded::allow_smem;
using banded::csc_store;
using banded::Geometry;
using banded::kSmemLimit;
using banded::Tail;
using wgmma::cp_async16;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;
using wgmma::desc;
using wgmma::fence_proxy_async;
using wgmma::h_off;
using wgmma::pack_bf16;

constexpr int kKnockout = NV12_COMBO_KNOCKOUT;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 3;     // ring depth: two steps in flight
constexpr int kHBatch = 4;     // H-pass k-steps a batch of products
constexpr int kWSteps = 6;     // W k-steps a chunk: 4 luma, 2 chroma

enum Split : int { kChunks = 0, kFrames = 1, kRows = 2, kRounds = 3 };

// One instance: G frames a block on strips of T rows, split as S.
template <int T_, int G_, int S_>
struct Cfg {
  static constexpr int T = T_, G = G_, S = S_;
  static constexpr int R = S == kRounds ? G / 4 : 1;  // rounds of frames
  static constexpr int GR = G / R;                    // frames a round
  // a slot holds chunk q of two frames, one a warpgroup
  static constexpr bool kHalves = S == kFrames || S == kRounds;
  static constexpr int SC = S == kRows ? 64 : 128;  // slot columns
  static constexpr int N = S == kRows ? T / 2 : T;  // a warpgroup's N
  static constexpr int FW = kHalves ? GR / 2 : GR;  // its frames a round
  // bytes of one 8-column group of a warpgroup's H rows: N luma rows (U
  // then V rows for chroma) of 16 bytes, and 16 of padding
  static constexpr int kGy = 16 * N + 16;
  static constexpr int kGc = 32 * N + 16;
  // a warpgroup's H rows of one chunk: 64 luma columns, 32 chroma pixels
  static constexpr int kChunkBytes = 8 * kGy + 4 * kGc;
  // floats of one frame's partial W sums a thread trades (kChunks)
  static constexpr int kTrade = N / 2 + N;
  static constexpr int kTradeBytes = S == kChunks ? FW * kTrade * 128 * 4 : 0;
  // two blocks an SM where 48 W accumulators leave room (2x16)
  static constexpr int kMinBlocks = T <= 16 && 3 * G * T <= 96 ? 2 : 1;
  static_assert(3 * FW * N <= 192, "at most 96 W accumulators a thread");
  static_assert(S != kFrames || G % 2 == 0, "frames split in halves");
  static_assert(S != kRounds || G % 4 == 0, "rounds of 4 frames");
};

// Bytes of the ring (or the traded sums, the larger) for kst window rows.
template <class C>
__host__ __device__ __forceinline__ int ring_bytes(int kst) {
  const int ring = kStages * kst * C::SC;
  return ring > C::kTradeBytes ? ring : C::kTradeBytes;
}

// Byte offset of 16-byte chunk `ch` of row k in a slot of SC columns.
template <int SC>
__device__ __forceinline__ int ring_off(int k, int ch) {
  return k * SC + ((ch ^ ((k >> 1) & (SC / 16 - 1))) << 4);
}

// Barrier of one warpgroup's 128 threads (ids 1 and 2; __syncthreads is
// 0): constant ids, so that ptxas reserves two barriers, not all 16.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Copy step (q, f) into a slot: its SC / 64 halves of 64 columns, half h
// the bytes from column col(h) of frame fr(h) (from x0; frames from
// `base`, the round's first) of the kw stacked window rows (row k at
// frame + row_of(k) * rs); only bytes below `end` are copied. Every thread
// commits one group.
//   kChunks: frame f, columns 128 q + 64 h;
//   kFrames, kRounds: frame h FW + f, columns 64 q;
//   kRows:   frame f, columns 64 q.
template <class C, typename RowOf>
__device__ __forceinline__ void issue_step(unsigned char* slot,
                                           const uint8_t* base, long long bs,
                                           long long rs, int q, int f,
                                           int kw, int end, bool vec,
                                           RowOf row_of) {
  constexpr int SC = C::SC;
  const auto frame = [&](int h) {
    return base + (C::kHalves ? h * C::FW + f : f) * bs;
  };
  const auto col = [&](int h) {
    return C::S == kChunks ? 128 * q + 64 * h : 64 * q;
  };
  // the loops stay rolled: unrolled, their addresses took the registers
  // that 2x16's W weights and accumulators need at two blocks an SM
  if (vec) {
#pragma unroll 1
    for (int i = threadIdx.x; i < kw * (SC / 16); i += kThreads) {
      const int k = i / (SC / 16), ch = i % (SC / 16);
      const int c = col(ch >> 2) + 16 * (ch & 3);
      if (c < end)
        cp_async16(slot + ring_off<SC>(k, ch),
                   frame(ch >> 2) + row_of(k) * rs + c);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < kw * SC; i += kThreads) {
      const int k = i / SC, x = i % SC;
      const int c = col(x >> 6) + (x & 63);
      if (c < end)
        slot[ring_off<SC>(k, x >> 4) + (x & 15)] =
            __ldg(frame(x >> 6) + row_of(k) * rs + c);
    }
  }
  cp_async_commit();
}

// Byte offsets, from the first of 16 window rows of a slot, of rows 2 tq
// (+1, +8, +9) of the byte columns (col, col + 1): the same for every
// k-step, since the swizzle repeats every 16 rows.
template <int SC>
__device__ __forceinline__ void step_offsets(int (&off)[4], int col,
                                             int tq) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = ring_off<SC>(2 * tq + (j & 1) + 8 * (j >> 1), col >> 4) +
             (col & 15);
}

// B k-steps k0 .. k0 + B - 1 of an H chain: d += the thread's A
// fragments of their window rows x B's k-steps (descriptor bdesc, T * 32
// bytes apart: B holds all T rows of the strip), then one wait.
template <class C, int B>
__device__ __forceinline__ void h_batch(float (&d)[C::N / 2],
                                        const unsigned char* rows, int k0,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
  uint4 a[B];
#pragma unroll
  for (int i = 0; i < B; ++i)
    a[i] = wgmma::ring_step(rows + (k0 + i) * 16 * C::SC, off);
  wgmma::fence();
#pragma unroll
  for (int i = 0; i < B; ++i)
    wgmma::mma<C::N>(d, a[i], bdesc + (((k0 + i) * C::T * 32) >> 4));
  wgmma::commit();
  wgmma::wait_all();
}

// One chain of the H pass: d [64 columns, N] = the thread's A fragments
// of the nk k-steps of window rows from `rows` on x B, in batches of
// kHBatch k-steps, then one batch of the rest (each batch size a loop of
// its own, so that no wgmma sits under a branch).
template <class C>
__device__ __forceinline__ void h_chain(float (&d)[C::N / 2],
                                        const unsigned char* rows, int nk,
                                        const int (&off)[4],
                                        uint64_t bdesc) {
#pragma unroll
  for (int i = 0; i < C::N / 2; ++i) d[i] = 0.0f;
  int k0 = 0;
  for (; k0 + kHBatch <= nk; k0 += kHBatch)
    h_batch<C, kHBatch>(d, rows, k0, off, bdesc);
  for (; k0 < nk; ++k0) h_batch<C, 1>(d, rows, k0, off, bdesc);
}

template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
nv12_combo_kernel(const uint8_t* __restrict__ src, long long bs,
                  long long rs, int vec, Tail tl, Geometry g,
                  const uint4* __restrict__ b_tiles,
                  const int2* __restrict__ starts, int ky, int kc,
                  const int4* __restrict__ heads,
                  const uint4* __restrict__ frags,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = C::T, N = C::N, FW = C::FW, SC = C::SC;
  constexpr int kGy = C::kGy, kGc = C::kGc;
  const int kst = ky + kc;  // stacked window rows: luma, then chroma
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  unsigned char* ring = smem;  // kStages x [kst, SC] bytes
  unsigned char* bw = smem + ring_bytes<C>(kst);  // B_y [ky, T], B_c
  unsigned char* hy = bw + 2 * kst * T + wg * C::kChunkBytes;
  unsigned char* hc = hy + 8 * kGy;  // U rows, then V rows
  const int tile = blockIdx.x, strip = blockIdx.y;
  const int4 hd = __ldg(heads + tile);  // first chunk, x0, chunks
  const int groups = C::S == kChunks ? hd.z / 2 : hd.z;
  const int rsteps = groups * FW;  // steps a round
  const int nsteps = rsteps * C::R;
  const int o0 = strip * T;
  const int rows = min(T, g.dst_h - o0);
  // frame 0 of the block's G, from x0
  const uint8_t* base =
      src + static_cast<long long>(blockIdx.z) * C::G * bs + hd.y;
  const int end = g.src_w - hd.y;  // bytes of a row from x0
  const int2 st = __ldg(starts + strip);
  const int h = g.src_h;
  const auto row_of = [=](int k) {
    return k < ky ? min(st.x + k, h - 1)
                  : h + min(st.y + k - ky, h / 2 - 1);
  };
  const auto issue = [&](int s) {
    int rd = 0;  // the round of step s
    if constexpr (C::R > 1) rd = s / rsteps;
    const int sr = s - rd * rsteps, q = sr / FW;
    issue_step<C>(ring + s % kStages * kst * SC,
                  base + static_cast<long long>(rd) * C::GR * bs, bs, rs, q,
                  sr - q * FW, kst, end, vec, row_of);
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      issue(s);
    else
      cp_async_commit();
  }
  const uint4* bsrc = b_tiles + static_cast<long long>(strip) * kst * T / 8;
  for (int i = tid; i < kst * T / 8; i += kThreads)
    reinterpret_cast<uint4*>(bw)[i] = __ldg(bsrc + i);
  fence_proxy_async();  // B, read by wgmma

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, k pair
  const int lcol = 16 * warp + 2 * gq;      // the thread's 2 chunk bytes
  // kRows: the warpgroup's N rows start 32 wg rows into each k-step of B
  const int b0 = C::S == kRows ? wg * N * 32 : 0;
  const uint64_t bdesc_y = desc(bw + b0, 128, 256);
  const uint64_t bdesc_c = desc(bw + 2 * ky * T + b0, 128, 256);
  int off[4];  // the thread's A rows within a k-step of its slot columns
  step_offsets<SC>(off, (C::S == kRows ? 0 : 64 * wg) + lcol, tq);
  const uint4* wf = frags + static_cast<long long>(hd.x) * kWSteps * 128 +
                    wt;
  // kRounds: a round at a time (R = 1 for the other splits)
  for (int rd = 0; rd < C::R; ++rd) {
    float dy[FW][N / 2], duv[FW][N];
#pragma unroll
    for (int f = 0; f < FW; ++f) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dy[f][i] = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) duv[f][i] = 0.0f;
    }

    for (int q = 0; q < groups; ++q) {
      // the warpgroup's chunk of column group q, its W weights loaded once
      // for the FW frames' steps
      const int chunk = C::S == kChunks ? 2 * q + wg : q;
      uint4 wa[kWSteps];  // kept in registers over the frames
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        const int s = rd * rsteps + q * FW + f;
        cp_async_wait<kStages - 2>();
        __syncthreads();  // step s landed; slot (s - 1) % kStages is free
        if (s + kStages - 1 < nsteps)
          issue(s + kStages - 1);
        else
          cp_async_commit();
        if (!(kKnockout & 1) && f == 0) {  // f: unrolled, no run-time branch
          // every product of group q - 1 completed before the barrier
          const uint4* fq =
              wf + static_cast<long long>(chunk) * kWSteps * 128;
#pragma unroll
          for (int i = 0; i < kWSteps; ++i) wa[i] = __ldg(fq + i * 128);
        }
        if constexpr (!(kKnockout & 2)) {
          const unsigned char* slot = ring + s % kStages * kst * SC;
          float d[N / 2];
          // d[4 j + e], d[4 j + 2 + e]: row 8 j + 2 tq + e of byte columns
          // lcol and lcol + 1 (luma: two pixels; chroma: U and V of one)
          h_chain<C>(d, slot, ky / 16, off, bdesc_y);
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<unsigned*>(
                  hy + h_off(8 * j + 2 * tq + e, lcol, kGy)) =
                  pack_bf16(d[4 * j + e], d[4 * j + 2 + e]);
          h_chain<C>(d, slot + ky * SC, kc / 16, off, bdesc_c);
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * j + 2 * tq + e;
              *reinterpret_cast<__nv_bfloat16*>(
                  hc + h_off(r, lcol / 2, kGc)) =
                  __float2bfloat16_rn(d[4 * j + e]);
              *reinterpret_cast<__nv_bfloat16*>(
                  hc + h_off(N + r, lcol / 2, kGc)) =
                  __float2bfloat16_rn(d[4 * j + 2 + e]);
            }
          fence_proxy_async();  // the H rows, read by wgmma below
          warpgroup_sync(wg);
        }
        if constexpr (!(kKnockout & 1)) {
          wgmma::fence();
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wgmma::mma<N>(dy[f], wa[i], desc(hy + 2 * i * kGy, kGy, 128));
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wgmma::mma<2 * N>(duv[f], wa[4 + i],
                              desc(hc + 2 * i * kGc, kGc, 128));
          wgmma::commit();
          // before the next step's H rows overwrite these (and the next
          // group's weights overwrite wa): a wgmma reads its operands
          // until its group completes
          wgmma::wait_all();
        }
      }
    }
    if (C::R == 1 || rd == C::R - 1) {
      cp_async_wait<0>();
      __syncthreads();  // every step read: the ring's bytes are free
    }
    if constexpr (kKnockout & 1) continue;

    const long long plane_sz = static_cast<long long>(g.dst_h) * g.dst_w;
    float* trade = reinterpret_cast<float*>(ring);
    if constexpr (C::S == kChunks) {
      // warpgroup w finishes the pixels of accumulators e with e / 2 == w
      // (tile columns 16 warp + gq + 8 w); it hands the other its sums of
      // the rest, frame by frame, in the fragment layout both share
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        float* tf = trade + f * C::kTrade * 128;
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          if (((i & 3) >> 1) != wg) tf[i * 128 + wt] = dy[f][i];
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (((i & 3) >> 1) != wg) tf[(N / 2 + i) * 128 + wt] = duv[f][i];
      }
      __syncthreads();
    }
    // pixel of accumulator 4 j + e: tile column 16 warp + gq + 8 (e / 2),
    // row 8 j + 2 tq + e mod 2 of the warpgroup's N rows; U from duv[4 j +
    // e], V from duv[4 (j + N / 8) + e] (the V rows are N rows N on)
    const int r0 = C::S == kRows ? N * wg : 0;
#pragma unroll
    for (int f = 0; f < FW; ++f) {
      const int b = blockIdx.z * C::G + rd * C::GR +
                    (C::kHalves ? wg * FW : 0) + f;
      uint8_t* ob = out + static_cast<long long>(b) * 3 * plane_sz;
      const float* tf = trade + f * C::kTrade * 128;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * j + 2 * tq + (e & 1);
          const int p = 64 * tile + 16 * warp + gq + 8 * (e >> 1);
          const bool mine = C::S != kChunks || (e >> 1) == wg;
          if (mine && r < rows && p < g.dst_w) {
            const int iy = 4 * j + e, iv = 4 * (j + N / 8) + e;
            float ya = dy[f][iy], ua = duv[f][iy], va = duv[f][iv];
            if constexpr (C::S == kChunks) {
              ya += tf[iy * 128 + wt];
              ua += tf[(N / 2 + iy) * 128 + wt];
              va += tf[(N / 2 + iv) * 128 + wt];
            }
            csc_store(ob, plane_sz,
                      static_cast<long long>(o0 + r) * g.dst_w + p, ya, ua,
                      va, tl);
          }
        }
      }
    }
  }
}

// Shared memory of one block (bytes): the ring (or the traded sums, the
// larger), B_y and B_c, and the two warpgroups' H rows of a chunk
// (ops/banded.py combo_smem_bytes).
template <class C>
long long smem_bytes(int kst) {
  return ring_bytes<C>(kst) + 2LL * kst * C::T + 2LL * C::kChunkBytes;
}

template <class C>
cudaError_t launch_c(int tiles, int strips, int batch, cudaStream_t stream,
                     const uint8_t* src, long long bs, long long rs, int vec,
                     const Tail& tl, const Geometry& g, const uint4* b,
                     const int2* starts, int ky, int kc, const int4* heads,
                     const uint4* frags, uint8_t* out) {
  const long long smem = smem_bytes<C>(ky + kc);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem(nv12_combo_kernel<C>, static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  nv12_combo_kernel<C>
      <<<dim3(tiles, strips, batch / C::G), kThreads,
         static_cast<size_t>(smem), stream>>>(src, bs, rs, vec, tl, g, b,
                                              starts, ky, kc, heads, frags,
                                              out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The combo over `src`, frame 0 of a [batch, buf_rows, src_w] uint8 NV12
// buffer with the given batch and row strides (bytes), `gframes` frames a
// block (batch % gframes == 0) on strips of `tile` output rows; (gframes,
// tile) one of (2, 16), (4, 16), (2, 32), (4, 32), (1, 64), (2, 64),
// (8, 32).
// tail: the 18 floats of ops/banded.py tail_params. The tables are S2's
// at (tile, align 8), as nv12_static2_launch takes them: b_tiles [strips,
// (k_luma + k_chroma) * tile] bf16 on the device, per strip B_y then B_c
// in wgmma core-matrix order, strips = ceil(dst_h / tile); starts
// [strips, 2] int32 on the device, the first row of each strip's luma
// window (k_luma rows) and chroma window (k_chroma interleaved chroma
// rows); w_heads [ceil(dst_w / 64), 4] int32 on the device, per tile its
// first chunk, first byte column (a multiple of 32), chunks (even) and 0;
// w_frags [chunks, 6, 128] 16-byte words on the device, the W weights
// (ops/banded.py static2_w_tables). out is a contiguous [batch, 3, dst_h,
// dst_w] uint8 tensor.
int nv12_combo_launch(const void* src, long long batch_stride,
                      long long row_stride, int buf_rows, int batch,
                      int src_h, int src_w, int dst_h, int dst_w,
                      const float* tail, int gframes, int tile,
                      const void* b_tiles, const int* starts, int k_luma,
                      int k_chroma, const int* w_heads, const void* w_frags,
                      void* out, void* stream) {
  if (batch <= 0 || dst_h <= 0 || dst_w <= 0) return 0;
  const int strips = tile > 0 ? (dst_h + tile - 1) / tile : 0;
  if (gframes < 1 || batch % gframes != 0 || batch / gframes > 65535 ||
      strips > 65535 || src_w <= 0 || (src_w & 1) || src_h < 2 ||
      buf_rows < src_h * 3 / 2 || k_luma < 16 || k_luma % 16 != 0 ||
      k_chroma < 16 || k_chroma % 16 != 0 || !aligned16(b_tiles) ||
      !aligned16(w_heads) || !aligned16(w_frags) ||
      (reinterpret_cast<uintptr_t>(starts) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.batch = batch;
  g.src_h = src_h;
  g.src_w = src_w;
  g.dst_h = dst_h;
  g.dst_w = dst_w;
  g.rows = tile;
  const Tail tl = banded::unpack_tail(tail);
  const int vec = aligned16(src) && src_w % 16 == 0 &&
                  batch_stride % 16 == 0 && row_stride % 16 == 0;
  const int tiles = (dst_w + 63) / 64;
  auto go = [&](auto c) {
    return static_cast<int>(launch_c<decltype(c)>(
        tiles, strips, batch, static_cast<cudaStream_t>(stream),
        static_cast<const uint8_t*>(src), batch_stride, row_stride, vec, tl,
        g, static_cast<const uint4*>(b_tiles),
        reinterpret_cast<const int2*>(starts), k_luma, k_chroma,
        reinterpret_cast<const int4*>(w_heads),
        static_cast<const uint4*>(w_frags), static_cast<uint8_t*>(out)));
  };
  switch (gframes * 1000 + tile) {
    case 2016: return go(Cfg<16, 2, kChunks>());
    case 4016: return go(Cfg<16, 4, kChunks>());
    case 2032: return go(Cfg<32, 2, kChunks>());
    case 4032: return go(Cfg<32, 4, kFrames>());
    case 1064: return go(Cfg<64, 1, kRows>());
    case 2064: return go(Cfg<64, 2, kRows>());
    case 8032: return go(Cfg<32, 8, kRounds>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
