// Device helpers shared by the tensor-core attention kernels (sm_90a):
// 3xTF32 products on mma.sync (whole products over a tile: rows_dot,
// frags_dot, weight_rows; the f32 mode of flash_ops.cuh), cp.async
// staging, quad reductions and the shared-memory swizzle.
//
// 3xTF32. A TF32 operand keeps 10 explicit mantissa bits, so one TF32
// product carries ~5e-4 relative error: too coarse for the port's f32
// checks. Each f32 operand is split as x = hi + lo, hi = rna_tf32(x),
// lo = rna_tf32(x - hi), and a.b is taken as hi_a.hi_b + hi_a.lo_b +
// lo_a.hi_b (the dropped lo_a.lo_b is ~2^-22 of a.b), accumulated in f32 by
// the tensor cores: ~2^-21 relative per product, f32-grade. The small terms
// go in first, so the large one is added to an accumulator that already
// holds them.
//
// m16n8k8 fragments (PTX ISA, mma.m16n8k8 .tf32), lane = 4 * g + t with
// g = lane / 4 (group) and t = lane % 4 (thread in group):
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8, f32):  c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// A product whose C fragment feeds the next product's A operand (P in
// P.V) loads B's columns in the order perm(): C column 2t then holds column
// t and column 2t + 1 holds column t + 4, which is exactly where the next A
// fragment wants them ({c0, c2, c1, c3} = {a0, a1, a2, a3}), so no shuffle
// or shared-memory bounce is needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr float kNegInf = -1e30f;

// column of C fragment -> column of the product it holds (see above)
__device__ __forceinline__ int perm(int n) { return (n >> 1) + ((n & 1) << 2); }

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds: half a TF32 ulp added to the
// magnitude bits, then the low 13 bits cleared (a carry into the exponent
// is the right result). Two integer operations instead of the cvt, whose
// throughput set the pace of the 3xTF32 splits: the same results, and
// 11-15% off flash_fwd_ble, flash_fwd_bhld and flash_bwd_dkv, a third off
// flash_bwd_bhld_fused, on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (scripts/torch_kernel_variants.py, variants *_cvt_rna; PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d += a.b on one m16n8k8 tile, TF32 operands, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: lo.hi + hi.lo first, hi.hi last
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(d, a_lo, b_hi);
  mma(d, a_hi, b_lo);
  mma(d, a_hi, b_hi);
}

// Shared-memory tiles are dense [rows, D] f32 with each row's columns
// XOR-swizzled in 16-byte units, so that both fragment reads are free of
// bank conflicts for D >= 32: the "A-like" read (8 rows r0 + 0..7, 4
// neighbouring columns) and the "B-like" read (4 rows r0 + 0..3, 8
// neighbouring columns). Bits 3-4 of the swizzle are r % 4 (B-like: 4 rows
// on 4 disjoint 8-column bank groups), bit 2 is bit 2 of r (A-like: 8 rows
// on 8 disjoint 4-column groups). For D < 32 it is cut to the row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ ((((r & 3) << 3) | (r & 4)) & (D - 1)));
}

// 16-byte global -> shared copy; zero-fills when !pred (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(s), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4-byte global -> shared copy; zero-fills when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(s), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + R) of an f32 operand whose rows hold D contiguous
// floats `stride` floats apart (D for a dense [*, D] array; H * D for one
// head's columns of a [*, H * D] one) into a swizzled [R, D] tile with
// 16-byte cp.async copies; rows >= n_rows are zero-filled.
template <int D, int R, int kThreads>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int r0, int n_rows,
                                           int64_t stride = D) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < R * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i % V4) * 4;
    const bool live = r0 + r < n_rows;
    cp_async16(tile + swz<D>(r, c), src + (live ? r0 + r : 0) * stride + c, live);
  }
}

// acc[n] = scale * acc[n] + (W.X)[n]: W [16, 8 NT] is the warp's C
// fragments with columns in perm order (scale_lo for rows g, scale_hi for
// rows g + 8), X a swizzled [8 NT, D] tile in shared memory. W.X is summed
// over the tile in fresh accumulators, 8 n-tiles at a time (W's hi/lo split
// is redone per group), and added to acc once. The long sum over tiles
// then takes one f32 rounding per tile instead of one per mma. At the
// whole-slide shape (4,097 rows) this cut flash_bwd_dkv's largest |dK -
// f32 plain version| from 1.8e-5 to 1.5e-6 (5.5e-5 to 5.2e-6 with ragged
// masks) on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (scripts/torch_kernel_variants.py, variants dkv and dkv_direct_acc).
template <int D, int NT>
__device__ __forceinline__ void weight_rows(float (&acc)[D / 8][4], const float (&w)[NT][4],
                                            const float* x, float scale_lo, float scale_hi,
                                            int g, int t) {
  constexpr int DT = D / 8;
  constexpr int NC = DT < 8 ? DT : 8;
#pragma unroll
  for (int n0 = 0; n0 < DT; n0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float a[4] = {w[nt][0], w[nt][2], w[nt][1], w[nt][3]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = 8 * (n0 + n) + g;
        const float b[2] = {x[swz<D>(8 * nt + t, c)], x[swz<D>(8 * nt + t + 4, c)]};
        uint32_t bh[2], bl[2];
        split(b, bh, bl);
        mma3(part[n], ah, al, bh, bl);
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

// A fragment of rows [r0, r0 + 16) of a resident swizzled [*, D] tile, k-step kk
template <int D>
__device__ __forceinline__ void load_a(const float* tile, int r0, int kk, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {tile[swz<D>(r0 + g, 8 * kk + t)], tile[swz<D>(r0 + g + 8, 8 * kk + t)],
                      tile[swz<D>(r0 + g, 8 * kk + t + 4)],
                      tile[swz<D>(r0 + g + 8, 8 * kk + t + 4)]};
  split(x, hi, lo);
}

// acc[nt] += A.X^T over k-step kk for the NT n-tiles of a streamed [8 NT, D]
// tile X read in perm order, A given split
template <int D, int NT>
__device__ __forceinline__ void dot_step(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* x, int kk,
                                         int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = 8 * nt + perm(g);
    const float b[2] = {x[swz<D>(r, 8 * kk + t)], x[swz<D>(r, 8 * kk + t + 4)]};
    uint32_t bh_[2], bl_[2];
    split(b, bh_, bl_);
    mma3(acc[nt], ah, al, bh_, bl_);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// acc[nt] = A.X^T over D (A: the warp's rows of a resident tile)
template <int D, int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const float* res, int r0,
                                         const float* x, int g, int t) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    load_a<D>(res, r0, kk, g, t, ah, al);
    dot_step<D, NT>(acc, ah, al, x, kk, g, t);
  }
}

// acc[nt] = A.X^T over D (A: the warp's rows as split fragments in registers)
template <int D, int NT>
__device__ __forceinline__ void frags_dot(float (&acc)[NT][4], const uint32_t (&ah)[D / 8][4],
                                          const uint32_t (&al)[D / 8][4], const float* x, int g,
                                          int t) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) dot_step<D, NT>(acc, ah[kk], al[kk], x, kk, g, t);
}

// reductions over the 4 lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tf32x3
