// What the warpgroup-MMA attention tiles share (flash_bwd_wg.cuh's dk/dv and
// dq tiles, flash_fwd_wg.cuh's forward tile): one warpgroup of 128 threads
// per 64-row tile, the head dims wgmma's swizzled layout takes, the staging
// of [rows, D] bf16 tiles into that layout by cp.async, and the two forms of
// product the tiles issue (both operands from shared memory; A from an f32
// accumulator packed to one or three bf16 terms). Layouts, descriptors and
// fences are wgmma.cuh's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace wg_tile {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int R = 64;          // rows of a tile: wgmma's M

// the head dims the tiles take: one swizzle atom per 8 rows (wgmma.cuh)
template <int D>
constexpr bool kTakes = D == 16 || D == 32 || D == 64;

// the block's dynamic shared memory from its first 1,024-byte boundary
__device__ __forceinline__ uint8_t* aligned(void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint8_t*>(smem) + ((1024 - (a & 1023)) & 1023);
}

// Stage rows [r0, r0 + ROWS) of an operand whose rows hold D contiguous bf16
// `stride` elements apart into a swizzled [ROWS, D] tile with 16-byte
// cp.async copies; rows >= n_rows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage(uint8_t* tile, const bf16* src, int r0, int n_rows,
                                      int64_t stride) {
  constexpr int V = D / 8;  // 16-byte granules per row
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * 8;
    const bool live = r0 + r < n_rows;
    tf32x3::cp_async16(tile + wgmma::offset<D>(r, c), src + (live ? r0 + r : 0) * stride + c,
                       live);
  }
}

// The A registers of k-step j of a product whose left factor is the f32
// accumulator w (n-tiles 2j, 2j + 1) as kTerms bf16 terms, largest first.
template <int kTerms, int NT>
__device__ __forceinline__ void a_terms(uint32_t (&a)[NT / 2][kTerms][4], const float (&w)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t p[4][kTerms];
    bf16mma::split(w[2 * j][0], w[2 * j][1], p[0]);
    bf16mma::split(w[2 * j][2], w[2 * j][3], p[1]);
    bf16mma::split(w[2 * j + 1][0], w[2 * j + 1][1], p[2]);
    bf16mma::split(w[2 * j + 1][2], w[2 * j + 1][3], p[3]);
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[j][k][i] = p[i][k];
    }
  }
}

// acc += W.X over the NT / 2 k-steps: W the terms of a_terms, X a swizzled
// [8 NT, D] tile read MN-major; the small terms of each k-step first
template <int D, int kTerms, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 8][4], const uint32_t (&a)[KS][kTerms][4],
                                         const uint8_t* x) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint64_t b = wgmma::mn_desc<D>(x, j);
#pragma unroll
    for (int k = kTerms - 1; k >= 0; --k) wgmma::mma_rs<D>(acc, a[j][k], b);
  }
}

// acc = A.X^T over D: A a resident [64, D] tile, X a [N, D] tile, both
// read K-major
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 8][4], const uint8_t* a,
                                         const uint8_t* x) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma::mma_ss<N>(acc, wgmma::k_desc<D>(a, kk), wgmma::k_desc<D>(x, kk), kk > 0);
  }
}

}  // namespace wg_tile
