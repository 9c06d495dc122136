// Pieces shared by the tensor-core lab kernels of this directory
// (nv12_grouped.cu, nv12_aligned.cu, nv12_static2.cu, nv12_streamed.cu,
// nv12_slabs.cu, nv12_staged.cu, nv12_combo.cu, nv12_chains.cu,
// nv12_convert_staged.cu): wgmma
// descriptors, fences, products with A from registers (B K-major or
// MN-major) and with A from shared memory, the cp.async staging ring of
// raw uint8 window rows with the A fragments built from it by one of three
// cast chains, the tiled bf16 H rows and the W-pass product over them.
// sm_90a only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

constexpr int kStageCols = 128;  // frame bytes of a ring stage: 64 a warpgroup
constexpr int kWBatch = 8;       // W-pass k-steps a batch of weight loads

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a K-major operand without swizzle: 8 x 16-byte
// core matrices, `lbo` bytes apart along K, `sbo` bytes apart along M / N.
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFFu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N fp32, N / 2 a thread) += a (64 x 16 bf16, registers) * b
// (16 x N, shared memory, descriptor), for N = 8 to 48 in steps of 8 and
// 64, 80, 96. TB 0: B is K-major (its core matrices 8 N rows of 8
// contiguous K elements), 1: MN-major (8 K rows of 8 contiguous N
// elements; wgmma's imm-trans-b). Without swizzle the descriptor's leading
// byte offset steps along K and its stride byte offset along N in both
// layouts, as for A (mma_ss).
template <int N, int TB>
struct MmaRS;

template <int TB>
struct MmaRS<8, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %9;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<16, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, "
        "1, 1, %13;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<24, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, "
        "%14, %15}, %16, p, 1, 1, %17;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<32, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<40, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, "
        "1, 1, %25;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<48, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, "
        "%26, %27}, %28, p, 1, 1, %29;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<64, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
        "1, 1, %37;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<80, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, %45;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int TB>
struct MmaRS<96, TB> {
  static __device__ __forceinline__ void run(float* d, uint4 a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, "
        "%50, %51}, %52, p, 1, 1, %53;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(b), "n"(TB)
        : "memory");
  }
};

template <int N, int TB = 0>
__device__ __forceinline__ void mma(float* d, uint4 a, uint64_t b) {
  MmaRS<N, TB>::run(d, a, b);
}

// d (64 x N fp32, N / 2 a thread) += a (64 x 16 bf16, shared memory,
// descriptor) * b (16 x N, shared memory, descriptor), for N = 16, 24, 32
// and 48. TA 1: A is MN-major (its core matrices 8 K rows of 8 contiguous
// M elements), 0: K-major like B. Without swizzle the descriptor's leading
// byte offset steps along K and its stride byte offset along M in both
// layouts (nv12_staged.cu). SD 0 (N = 24 and 48 only) is wgmma's scale-d
// 0: d = a * b, whatever d held (nv12_convert_staged.cu).
template <int N, int TA, int SD = 1>
struct MmaSS;

template <int TA>
struct MmaSS<16, TA> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %10, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "n"(TA)
        : "memory");
  }
};

template <int TA>
struct MmaSS<32, TA> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1, %18, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "n"(TA)
        : "memory");
  }
};

template <int TA, int SD>
struct MmaSS<24, TA, SD> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %15, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, "
        "1, 1, %14, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "n"(TA), "n"(SD)
        : "memory");
  }
};

template <int TA, int SD>
struct MmaSS<48, TA, SD> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %27, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, "
        "1, 1, %26, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "n"(TA), "n"(SD)
        : "memory");
  }
};

template <int N, int TA = 1, int SD = 1>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b) {
  MmaSS<N, TA, SD>::run(d, a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Byte j of `h` as an exact float: 2^23 + x less 2^23.
__device__ __forceinline__ float byte_f(unsigned h, int j) {
  return __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440 + j)) -
         8388608.0f;
}

// Byte offset of chunk `ch` (16 bytes) of ring row k: XOR-swizzled by row
// pair, so the rows k, k + 2, k + 4, k + 6 a warp reads at once fall in
// distinct banks.
__device__ __forceinline__ int ring_off(int k, int ch) {
  return k * kStageCols + ((ch ^ ((k >> 1) & 7)) << 4);
}

// Stage `c0` .. c0 + kStageCols - 1 of the bytes of `kw` window rows into a
// ring slot (row k of the window at frame + row_of(k) * rs): cp.async when
// every row is 16-byte aligned (vec), else element loads; only bytes below
// `end` are copied. Every one of the THREADS threads commits one group.
template <int THREADS, typename RowOf>
__device__ __forceinline__ void issue_stage(unsigned char* slot,
                                            const uint8_t* frame,
                                            long long rs, int c0, int kw,
                                            int end, bool vec,
                                            RowOf row_of) {
  if (vec) {
    for (int i = threadIdx.x; i < kw * (kStageCols / 16); i += THREADS) {
      const int k = i >> 3, ch = i & 7;
      if (c0 + 16 * ch < end)
        cp_async16(slot + ring_off(k, ch),
                   frame + row_of(k) * rs + c0 + 16 * ch);
    }
  } else {
    for (int i = threadIdx.x; i < kw * kStageCols; i += THREADS) {
      const int k = i / kStageCols, c = i - k * kStageCols;
      if (c0 + c < end)
        slot[ring_off(k, c >> 4) + (c & 15)] =
            __ldg(frame + row_of(k) * rs + c0 + c);
    }
  }
  cp_async_commit();
}

// Byte offsets, from the first of 16 window rows of a ring slot, of rows
// 2 tq (+1, +8, +9) of the byte columns (col, col + 1): the same for every
// k-step, since the swizzle repeats every 16 rows. Fragment row m of a
// warp is byte column 2 (m mod 8) + (m / 8 mod 2) of its 16, so one 16-bit
// load brings both of a thread's columns of a row.
__device__ __forceinline__ void step_offsets(int (&off)[4], int col,
                                             int tq) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = ring_off(2 * tq + (j & 1) + 8 * (j >> 1), col >> 4) + (col & 15);
}

// How a ring byte becomes a bf16 element of A (every uint8 is exact in
// bf16, so the three give equal registers):
//   kMagic  2^23 + x less 2^23 in f32 (byte_f), then cvt.rn.bf16x2.f32;
//   kShort  the TPU's short chain u8 -> i32 -> bf16: one cvt.rn.bf16.s32
//           an element (__int2bfloat16_rn), two packed by one prmt;
//   kLong   the TPU's long chain u8 -> i32 -> f32 (cvt.rn.f32.s32) ->
//           bf16 (cvt.rn.bf16x2.f32).
enum Chain : int { kMagic = 0, kShort = 1, kLong = 2 };

// Byte j of `lo` (low half) and of `hi` (high half) as two bf16 by CHAIN,
// branch-free: ptxas serializes wgmmas whose A registers are written
// under a branch.
template <int CHAIN>
__device__ __forceinline__ unsigned pack_bytes(unsigned lo, unsigned hi,
                                               int j) {
  const int x = static_cast<int>((lo >> (8 * j)) & 0xFFu);
  const int y = static_cast<int>((hi >> (8 * j)) & 0xFFu);
  if constexpr (CHAIN == kShort)
    return __byte_perm(__bfloat16_as_ushort(__int2bfloat16_rn(x)),
                       __bfloat16_as_ushort(__int2bfloat16_rn(y)), 0x5410);
  else if constexpr (CHAIN == kLong)
    return pack_bf16(__int2float_rn(x), __int2float_rn(y));
  else
    return pack_bf16(byte_f(lo, j), byte_f(hi, j));
}

// The H product's A fragment of the k-step whose 16 window rows start at
// `p`: rows 2 tq (+1, +8, +9) of the thread's two byte columns, each pair
// of rows packed low-k first, every byte an exact bf16 by CHAIN.
template <int CHAIN = kMagic>
__device__ __forceinline__ uint4 ring_step(const unsigned char* p,
                                          const int (&off)[4]) {
  unsigned h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = *reinterpret_cast<const unsigned short*>(p + off[j]);
  return make_uint4(pack_bytes<CHAIN>(h[0], h[1], 0),
                    pack_bytes<CHAIN>(h[0], h[1], 1),
                    pack_bytes<CHAIN>(h[2], h[3], 0),
                    pack_bytes<CHAIN>(h[2], h[3], 1));
}

// The H product's A fragments from a ring slot: a[ks] = window rows
// 16 ks + 2 tq (+1, +8, +9) of the byte columns (col, col + 1).
template <int NK>
__device__ __forceinline__ void ring_fragments(unsigned (&a)[NK][4],
                                               const unsigned char* slot,
                                               int col, int tq) {
  int off[4];
  step_offsets(off, col, tq);
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const uint4 f = ring_step(slot + 16 * ks * kStageCols, off);
    a[ks][0] = f.x;
    a[ks][1] = f.y;
    a[ks][2] = f.z;
    a[ks][3] = f.w;
  }
}

// Byte offset of H element (row r, column c) in H rows tiled as groups of
// 8 columns, each `group` bytes: its rows 16 bytes apart (8 bf16).
__device__ __forceinline__ int h_off(int r, int c, int group) {
  return (c >> 3) * group + r * 16 + (c & 7) * 2;
}

// One W-pass product of a warpgroup: d = A x H[:, c0 : c0 + 16 nk]^T over
// the N tiled H rows at `h` (groups of 8 columns `group` bytes apart, runs
// of 8 rows `sbo` bytes apart), A's fragments at `frags` ([nk][128] 16-byte
// words), in batches of kWBatch k-steps: the batch's weights loaded, then
// its products issued. A batch always issues kWBatch products, those past
// nk with zero A over the last k-step's H columns: no wgmma sits under a
// branch, which would make ptxas serialize them all.
template <int N>
__device__ __forceinline__ void wpass_product(float* d,
                                              const uint4* __restrict__ frags,
                                              int nk,
                                              const unsigned char* h, int c0,
                                              unsigned group, unsigned sbo,
                                              int wt) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  for (int k0 = 0; k0 < nk; k0 += kWBatch) {
    uint4 a[kWBatch];
#pragma unroll
    for (int i = 0; i < kWBatch; ++i) {
      const int k = min(k0 + i, nk - 1);
      a[i] = __ldg(frags + static_cast<long long>(k) * 128 + wt);
      if (k0 + i >= nk) a[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence();
#pragma unroll
    for (int i = 0; i < kWBatch; ++i) {
      const int k = min(k0 + i, nk - 1);
      mma<N>(d, a[i], desc(h + ((c0 >> 3) + 2 * k) * group, group, sbo));
    }
    commit();
    wait_all();
  }
}

}  // namespace wgmma
