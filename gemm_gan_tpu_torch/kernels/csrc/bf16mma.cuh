// Device helpers of the tensor-core attention kernels' bf16 modes (sm_90a):
// mma.sync m16n8k16 (and m16n8k8) with bf16 operands and f32 accumulation,
// the split of an f32 operand into bf16 terms, and tiles of f32 or bf16
// elements in shared memory.
//
// Products. Every operand goes to the tensor cores as bf16, every sum is
// f32. An operand that is bf16 already (q, k, v, dO in the bf16 modes) is
// exact. An f32 operand (P or dS; q, k, v, dO with f32 refs) is taken as
// kTerms bf16 terms (`split`): 1 rounds it to nearest even, as the JAX
// package's `_mxu_in` does under `mxu_bf16`; 3 are exact, since each term
// takes the next 8 significant bits of the residual (of f32's 24) and the
// residual of a bf16 rounding is exact in f32: x = hi + mid + lo. The
// product of two bf16 values is exact in f32, so three terms make a
// product that is as exact as f32's own (the small terms go in first).
//
// m16n8k16 fragments (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * g + t; a
// register holds the pair of elements (2t, 2t + 1) of a row, the lower
// index in the lower half:
//   A (16 x 16, row):  a0 (g, 2t..)   a1 (g + 8, 2t..)   a2 (g, 2t + 8..)   a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):   b0 (2t.., g)   b1 (2t + 8.., g)
//   C (16 x 8, f32):   c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// m16n8k8: A a0, a1 and B b0 as above over 8 columns. The C fragments of
// n-tiles 2j and 2j + 1 are, packed in pairs, the A fragment of k-step j of
// the next product ({c0 c1, c2 c3} of tile 2j, then of tile 2j + 1): P and
// dS feed the next product in the natural column order, no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace bf16mma {

using tf32x3::zero;

// (x0, x1) as a bf16 pair, x0 in the lower half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the pair's two values in f32 (exact)
__device__ __forceinline__ float low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// (x0, x1) as kTerms bf16 pairs, largest first, whose sums are x0 and x1
// (exactly for kTerms 3; rounded to nearest even for kTerms 1)
template <int kTerms>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&terms)[kTerms]) {
  terms[0] = pack(x0, x1);
#pragma unroll
  for (int i = 1; i < kTerms; ++i) {
    x0 -= low(terms[i - 1]);
    x1 -= high(terms[i - 1]);
    terms[i] = pack(x0, x1);
  }
}

// d += a.b on one m16n8k16 tile
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b on one m16n8k8 tile (the last k-step over D at D = 8)
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Shared-memory tiles are dense [rows, D] of T (float or bf16), each row's
// 16-byte granules XOR-swizzled by the row's low bits, so that neither read
// below has a bank conflict for rows of 128 bytes or more: a row pair (8
// rows g, 4 lanes t reading columns 2t, 2t + 1) and a column pair (rows
// 2t and 2t + 1 of 8 neighbouring columns g).
template <class T, int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int E = 16 / sizeof(T);   // elements per granule
  constexpr int G = D / E;            // granules per row: 1 to 32
  constexpr int M = (G < 8 ? G : 8) - 1;
  return r * D + ((((c / E) ^ (r & M)) * E) | (c % E));
}

// the bf16 pair (elements c, c + 1; c even) at p, rounded if T is f32
template <class T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    return pack(x.x, x.y);
  } else {
    return *reinterpret_cast<const uint32_t*>(p);
  }
}

// the bf16 pair of row r, columns c and c + 1 of a swizzled tile
template <class T, int D>
__device__ __forceinline__ uint32_t row_pair(const T* tile, int r, int c) {
  return ld_pair(tile + swz<T, D>(r, c));
}

// the bf16 pair of column c, rows r and r + 1 of a swizzled tile
template <class T, int D>
__device__ __forceinline__ uint32_t col_pair(const T* tile, int r, int c) {
  if constexpr (std::is_same_v<T, float>) {
    return pack(tile[swz<T, D>(r, c)], tile[swz<T, D>(r + 1, c)]);
  } else {
    return static_cast<uint32_t>(__bfloat16_as_ushort(tile[swz<T, D>(r, c)])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(tile[swz<T, D>(r + 1, c)])) << 16);
  }
}

// (x0, x1) stored at p as T (two f32, or a bf16 pair rounded once)
template <class T>
__device__ __forceinline__ void store_pair(T* p, float x0, float x1) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack(x0, x1);
  }
}

// Stage rows [r0, r0 + R) of an operand whose rows hold D contiguous
// elements `stride` elements apart into a swizzled [R, D] tile with 16-byte
// cp.async copies; rows >= n_rows are zero-filled.
template <class T, int D, int R, int kThreads>
__device__ __forceinline__ void stage_rows(T* tile, const T* src, int r0, int n_rows,
                                           int64_t stride) {
  constexpr int E = 16 / sizeof(T);
  constexpr int V = D / E;
  for (int i = threadIdx.x; i < R * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * E;
    const bool live = r0 + r < n_rows;
    tf32x3::cp_async16(tile + swz<T, D>(r, c), src + (live ? r0 + r : 0) * stride + c, live);
  }
}

// k-steps of a product over D: k16 ones, and a k8 one at D = 8
template <int D>
constexpr int kSteps = (D + 15) / 16;

// Whether bf16 tiles hand their fragments to the products by ldmatrix.x4
// (one instruction for four 8 x 8 blocks, .trans for a tile's columns)
// instead of 32- and 16-bit shared-memory loads. Off: the loads as measured
// in PERF.md; scripts/torch_kernel_variants.py times it on (`*_ldmatrix`).
constexpr bool kLdmatrix = false;
template <class T, int D>
constexpr bool kLdsm = kLdmatrix && std::is_same_v<T, __nv_bfloat16> && D % 16 == 0;

// four 8 x 8 bf16 blocks from the 16-byte rows whose addresses lanes 8i to
// 8i + 7 give (block i), in mma fragment order; .trans transposes each block
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  }
}

// A fragments of rows (g, g + 8) over D: ld(i, c) gives the pair at row
// g + 8 i, columns c, c + 1 (the k8 step fills a0, a1 only)
template <int D, class Ld>
__device__ __forceinline__ void a_frags(uint32_t (&a)[kSteps<D>][4], int t, Ld ld) {
#pragma unroll
  for (int kk = 0; kk < kSteps<D>; ++kk) {
    const int c = 16 * kk + 2 * t;
    a[kk][0] = ld(0, c);
    a[kk][1] = ld(1, c);
    if (16 * kk + 16 <= D) {
      a[kk][2] = ld(0, c + 8);
      a[kk][3] = ld(1, c + 8);
    } else {
      a[kk][2] = a[kk][3] = 0u;
    }
  }
}

// acc[nt] = A.X^T over D: A given as fragments, X a swizzled [8 NT, D] tile
// whose rows 8 nt + g are the columns of n-tile nt (natural order)
template <class T, int D, int NT>
__device__ __forceinline__ void frags_dot(float (&acc)[NT][4], const uint32_t (&a)[kSteps<D>][4],
                                          const T* x, int g, int t) {
  zero(acc);
  if constexpr (kLdsm<T, D> && NT % 2 == 0) {
    // lane l: row 8 (nt + l / 16) + l % 8 of n-tiles nt, nt + 1, columns
    // 16 kk + 8 ((l / 8) % 2): b0, b1 of n-tile nt, then of nt + 1
    const int l = 4 * g + t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldsm4<false>(b, x + swz<T, D>(8 * (nt + (l >> 4)) + (l & 7), 16 * kk + 8 * ((l >> 3) & 1)));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma16(acc[nt], a[kk], b0);
        mma16(acc[nt + 1], a[kk], b1);
      }
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t b[2] = {row_pair<T, D>(x, 8 * nt + g, c), row_pair<T, D>(x, 8 * nt + g, c + 8)};
      mma16(acc[nt], a[kk], b);
    }
  }
  if constexpr (D % 16 != 0) {  // D = 8
    constexpr int kk = D / 16;
    const uint32_t a2[2] = {a[kk][0], a[kk][1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma8(acc[nt], a2, row_pair<T, D>(x, 8 * nt + g, 16 * kk + 2 * t));
  }
}

// acc[nt] = A.X^T over D, A the rows [r0, r0 + 16) of a resident tile
template <class T, int D, int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const T* res, int r0, const T* x,
                                         int g, int t) {
  uint32_t a[kSteps<D>][4];
  if constexpr (kLdsm<T, D>) {
    // lane l: row r0 + l % 16, columns 16 kk + 8 (l / 16): a0 .. a3
    const int l = 4 * g + t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldsm4<false>(a[kk], res + swz<T, D>(r0 + (l & 15), 16 * kk + 8 * (l >> 4)));
    }
  } else {
    a_frags<D>(a, t, [&](int i, int c) { return row_pair<T, D>(res, r0 + g + 8 * i, c); });
  }
  frags_dot<T, D, NT>(acc, a, x, g, t);
}

// acc[n] = scale * acc[n] + (W.X)[n]: W [16, 8 NT] is the warp's f32 C
// fragments in the natural column order (scale_lo for rows g, scale_hi for
// rows g + 8), taken as kTerms bf16 terms (`split`); X a swizzled [8 NT, D]
// tile. As tf32x3::weight_rows, W.X is summed over the tile in fresh
// accumulators, 8 n-tiles at a time, and added to acc once.
template <class T, int D, int NT, int kTerms>
__device__ __forceinline__ void weight_rows(float (&acc)[D / 8][4], const float (&w)[NT][4],
                                            const T* x, float scale_lo, float scale_hi, int g,
                                            int t) {
  static_assert(NT % 2 == 0, "k16 steps over the tile's rows");
  constexpr int DT = D / 8;
  constexpr int NC = DT < 8 ? DT : 8;
#pragma unroll
  for (int n0 = 0; n0 < DT; n0 += NC) {
    float part[NC][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t p[4][kTerms];  // the four A registers of k-step j, term by term
      split(w[2 * j][0], w[2 * j][1], p[0]);
      split(w[2 * j][2], w[2 * j][3], p[1]);
      split(w[2 * j + 1][0], w[2 * j + 1][1], p[2]);
      split(w[2 * j + 1][2], w[2 * j + 1][3], p[3]);
      if constexpr (kLdsm<T, D> && NC % 2 == 0) {
        // lane l: row 16 j + l % 8 + 8 ((l / 8) % 2), columns 8 (n0 + n +
        // l / 16), transposed: b0, b1 of n-tile n, then of n + 1
        const int l = 4 * g + t;
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bb[4];
          ldsm4<true>(bb, x + swz<T, D>(16 * j + (l & 7) + 8 * ((l >> 3) & 1),
                                        8 * (n0 + n + (l >> 4))));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t b[2] = {bb[2 * h], bb[2 * h + 1]};
#pragma unroll
            for (int k = kTerms - 1; k >= 0; --k) {
              const uint32_t a[4] = {p[0][k], p[1][k], p[2][k], p[3][k]};
              mma16(part[n + h], a, b);
            }
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = 8 * (n0 + n) + g;
          const uint32_t b[2] = {col_pair<T, D>(x, 16 * j + 2 * t, c),
                                 col_pair<T, D>(x, 16 * j + 2 * t + 8, c)};
#pragma unroll
          for (int k = kTerms - 1; k >= 0; --k) {
            const uint32_t a[4] = {p[0][k], p[1][k], p[2][k], p[3][k]};
            mma16(part[n], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      acc[n0 + n][0] = fmaf(acc[n0 + n][0], scale_lo, part[n][0]);
      acc[n0 + n][1] = fmaf(acc[n0 + n][1], scale_lo, part[n][1]);
      acc[n0 + n][2] = fmaf(acc[n0 + n][2], scale_hi, part[n][2]);
      acc[n0 + n][3] = fmaf(acc[n0 + n][3], scale_hi, part[n][3]);
    }
  }
}

// sum over the 16 bytes x.y of T elements, added to acc in f32
template <class T>
__device__ __forceinline__ float chunk_dot(const uint4& x, const uint4& y, float acc) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 a = *reinterpret_cast<const float4*>(&x), b = *reinterpret_cast<const float4*>(&y);
    return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
  } else {
    const uint32_t a[4] = {x.x, x.y, x.z, x.w}, b[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(low(a[i]), low(b[i]), fmaf(high(a[i]), high(b[i]), acc));
    return acc;
  }
}

}  // namespace bf16mma
