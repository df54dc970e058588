// Hopper's warpgroup matrix multiply (wgmma.mma_async, sm_90a only) for bf16
// operands with f32 accumulation: the shared-memory layout it reads, its
// matrix descriptors, the instructions at the widths the attention tiles
// take (m64nNk16, N 16, 32 or 64; N 128 with A and B from shared memory),
// and the fences around them.
//
// One instruction is issued by the four warps of a warpgroup together and
// computes a 64 x N x 16 product. Warp w holds rows [16 w, 16 w + 16) of A
// (when A comes from registers) and of the accumulator, in the layout of
// mma.sync m16n8k16 (bf16mma.cuh), lane = 4 g + t:
//   A (registers, 16 x 16 per warp): a0 (g, 2t..) a1 (g + 8, 2t..)
//                                    a2 (g, 2t + 8..) a3 (g + 8, 2t + 8..)
//   accumulator d[n][e], per n8 column tile n: e 0, 1 at (g, 8n + 2t + e),
//                                              e 2, 3 at (g + 8, 8n + 2t + e - 2)
// so an accumulator's n-tiles 2j and 2j + 1, packed in pairs, are the A
// registers of k-step j of the next product.
//
// Shared-memory operands are dense [rows, D] bf16 tiles, D 16, 32 or 64: a
// row is 2D bytes and 8 rows are one swizzle atom of wgmma's canonical
// layouts (SW32, SW64, SW128 for rows of 32, 64, 128 bytes): the 16-byte
// granule index XORed with bits [7, 7 + log2(2D / 16)) of the byte offset,
// i.e. with row & 7 at D 64. A tile starts on a 1,024-byte boundary. The
// same tile is read two ways:
//   K-major: the tile is [M or N rows, K = D]: k-step kk starts 32 kk bytes
//     into the rows (the hardware applies the swizzle to the address), 8-row
//     groups are one atom apart (SBO); LBO is unused.
//   MN-major (transposed B, for 16-bit types): the tile is [K rows, N = D]:
//     k-step kk starts 16 rows further down, the two 8-row groups of a k-step
//     are one atom apart. N = D is one atom wide, so the stride between atoms
//     along N is never taken: LBO and SBO are both given the atom's size.
//
// Fences (PTX ISA, wgmma): the tiles are written by cp.async through the
// generic proxy and read by wgmma through the async proxy, so each thread
// issues fence.proxy.async after its copies land and before the barrier that
// precedes the first wgmma on them (`fence_proxy_async`); `fence` orders
// ordinary register writes (A fragments, zeroed accumulators) before the
// wgmma that reads them; `wait<N>` leaves at most N committed groups in
// flight, and `fence_operand` keeps the compiler from touching an
// accumulator across the wait.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

template <int D>
struct Layout {
  static_assert(D == 16 || D == 32 || D == 64, "one swizzle atom per 8 rows of 2D bytes");
  static constexpr int kBits = D == 64 ? 3 : D == 32 ? 2 : 1;  // log2(row bytes / 16)
  static constexpr uint32_t kAtom = 16 * D;                    // bytes of 8 rows
  static constexpr uint64_t kType = D == 64 ? 1 : D == 32 ? 2 : 3;  // SW128, SW64, SW32
};

// byte offset of element (r, c) in a swizzled [rows, D] bf16 tile
template <int D>
__device__ __forceinline__ uint32_t offset(int r, int c) {
  const uint32_t o = static_cast<uint32_t>(r * 2 * D + 2 * c);
  return o ^ (((o >> 7) & ((1u << Layout<D>::kBits) - 1)) << 4);
}

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo,
                                         uint64_t type) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (type << 62);
}

// descriptor of k-step kk of a tile read K-major (its rows are M or N)
template <int D>
__device__ __forceinline__ uint64_t k_desc(const uint8_t* tile, int kk) {
  return desc(tile + 32 * kk, 16, Layout<D>::kAtom, Layout<D>::kType);
}

// descriptor of k-step kk of a tile read MN-major (its rows are K)
template <int D>
__device__ __forceinline__ uint64_t mn_desc(const uint8_t* tile, int kk) {
  return desc(tile + 2 * Layout<D>::kAtom * kk, Layout<D>::kAtom, Layout<D>::kAtom,
              Layout<D>::kType);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int NT>
__device__ __forceinline__ void fence_operand(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}

#define WGMMA_D2(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])

// d (+)= A.B, A and B from shared memory, both K-major; d = A.B when
// !accumulate
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                       bool accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N 16, 32, 64 or 128");
  const int scale = accumulate ? 1 : 0;
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1)
        : "l"(a), "l"(b), "r"(scale));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1), WGMMA_D2(2), WGMMA_D2(3)
        : "l"(a), "l"(b), "r"(scale));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1), WGMMA_D2(2), WGMMA_D2(3), WGMMA_D2(4), WGMMA_D2(5),
          WGMMA_D2(6), WGMMA_D2(7)
        : "l"(a), "l"(b), "r"(scale));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1), WGMMA_D2(2), WGMMA_D2(3), WGMMA_D2(4), WGMMA_D2(5),
          WGMMA_D2(6), WGMMA_D2(7), WGMMA_D2(8), WGMMA_D2(9), WGMMA_D2(10), WGMMA_D2(11),
          WGMMA_D2(12), WGMMA_D2(13), WGMMA_D2(14), WGMMA_D2(15)
        : "l"(a), "l"(b), "r"(scale));
  }
}

// d += A.B, A from registers (this warp's 16 x 16 fragment), B from shared
// memory MN-major (transposed)
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                       uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "N 16, 32 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1), WGMMA_D2(2), WGMMA_D2(3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WGMMA_D2(0), WGMMA_D2(1), WGMMA_D2(2), WGMMA_D2(3), WGMMA_D2(4), WGMMA_D2(5),
          WGMMA_D2(6), WGMMA_D2(7)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef WGMMA_D2

}  // namespace wgmma
