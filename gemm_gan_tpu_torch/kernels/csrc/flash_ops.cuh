// The product modes of the tensor-core attention kernels and, for each, the
// primitives that the kernel templates (flash_fwd.cuh, flash_bwd_tc.cuh)
// take their products from: `Ops<kMode, D>`. One kernel template serves
// every mode; only its element type and these primitives change.
//
//   kF32      f32 q, k, v, o, dO: 3xTF32 products (tf32x3.cuh), f32-grade.
//   kBf16     bf16 q, k, v, o, dO (the JAX package's compute_dtype
//             "bfloat16"): f32-exact products on m16n8k16 bf16 (bf16mma.cuh):
//             a bf16 operand in one term, an f32 one (P, dS) in three.
//   kMxuF32   f32 q, k, v, o, dO under mxu_bf16: every operand, P and dS
//             included, rounded to bf16 (to nearest even) and one bf16
//             product each; outputs f32.
//   kMxuBf16  the same on bf16 q, k, v, o, dO.
// Softmax statistics, lse, delta and every accumulator are f32 in all
// modes; outputs are rounded once to the element type at the store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace flash_ops {

enum Mode : int { kF32 = 0, kBf16 = 1, kMxuF32 = 2, kMxuBf16 = 3 };

// f(std::integral_constant<int, D>{}) for the head dims D the kernels are
// built for (the wrappers' HEAD_DIMS); cudaErrorInvalidValue for any other
template <typename F>
int with_head_dim(int head_dim, F f) {
  switch (head_dim) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// element type of q, k, v, o, dO and the gradients
template <int kMode>
using Elem = std::conditional_t<kMode == kBf16 || kMode == kMxuBf16, __nv_bfloat16, float>;

// whether P is rounded to bf16 before P.V (the forward then takes each
// row's max over a key block first, so that it rounds exp(s - the running
// max at the block's end) as the reference's block does, not exp(s - a
// per-tile running max); flash_fwd.cuh)
template <int kMode>
constexpr bool kRoundsP = kMode == kMxuF32 || kMode == kMxuBf16;

template <int kMode, int D>
struct Ops;

// kF32: 3xTF32 on m16n8k8 (tf32x3.cuh). A product's right factor is read in
// tf32x3::perm order, so C column 2t (2t + 1) of n-tile nt holds row
// 8 nt + t (8 nt + t + 4) of the streamed tile.
template <int D>
struct Ops<kF32, D> {
  using T = float;

  __device__ __forceinline__ static int col(int nt, int e, int t) {
    return 8 * nt + t + 4 * (e & 1);
  }

  template <int R, int kThreads>
  __device__ __forceinline__ static void stage(T* tile, const T* src, int r0, int n_rows,
                                               int64_t stride) {
    tf32x3::stage_rows<D, R, kThreads>(tile, src, r0, n_rows, stride);
  }

  template <int NT>
  __device__ __forceinline__ static void rows_dot(float (&acc)[NT][4], const T* res, int r0,
                                                  const T* x, int g, int t) {
    tf32x3::rows_dot<D, NT>(acc, res, r0, x, g, t);
  }

  template <int NT>
  __device__ __forceinline__ static void weight_rows(float (&acc)[D / 8][4],
                                                     const float (&w)[NT][4], const T* x,
                                                     float scale_lo, float scale_hi, int g,
                                                     int t) {
    tf32x3::weight_rows<D, NT>(acc, w, x, scale_lo, scale_hi, g, t);
  }

  // The forward's Q rows, held in registers as A fragments: split into
  // hi/lo once at D <= 64, raw f32 at D = 128 (split per use, to stay clear
  // of spills).
  static constexpr bool kQSplit = D <= 64;
  struct Held {
    float f[D / 8][4];
    uint32_t hi[kQSplit ? D / 8 : 1][4], lo[kQSplit ? D / 8 : 1][4];
  };

  // rows (g, g + 8) of q (rows `stride` apart; rows >= n_rows read as 0)
  __device__ __forceinline__ static void hold(Held& h, const T* q, const int (&rows)[2],
                                              int n_rows, int64_t stride, int t) {
    // A fragments: a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i & 1];
        h.f[kk][i] = r < n_rows ? q[r * stride + 8 * kk + t + 4 * (i >> 1)] : 0.f;
      }
    }
    if constexpr (kQSplit) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) tf32x3::split(h.f[kk], h.hi[kk], h.lo[kk]);
    }
  }

  // s[nt] = Q.X^T over D for a streamed [8 NT, D] tile X (keys)
  template <int NT>
  __device__ __forceinline__ static void held_dot(float (&s)[NT][4], const Held& h, const T* x,
                                                  int g, int t) {
    tf32x3::zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (kQSplit) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = h.hi[kk][i];
          al[i] = h.lo[kk][i];
        }
      } else {
        tf32x3::split(h.f[kk], ah, al);
      }
      tf32x3::dot_step<D, NT>(s, ah, al, x, kk, g, t);
    }
  }
};

// kBf16, kMxuF32, kMxuBf16: bf16 products on m16n8k16 (bf16mma.cuh), the
// right factor's rows in natural order: C column 2t + (e & 1) of n-tile nt
// holds row 8 nt + 2t + (e & 1) of the streamed tile.
template <int kMode, int D>
struct Ops {
  static_assert(kMode == kBf16 || kMode == kMxuF32 || kMode == kMxuBf16, "a bf16 mode");
  using T = Elem<kMode>;
  // bf16 terms of an f32 operand (P, dS): exact, or rounded once (mxu_bf16)
  static constexpr int kTerms = kMode == kBf16 ? 3 : 1;
  static constexpr int KS = bf16mma::kSteps<D>;

  __device__ __forceinline__ static int col(int nt, int e, int t) {
    return 8 * nt + 2 * t + (e & 1);
  }

  template <int R, int kThreads>
  __device__ __forceinline__ static void stage(T* tile, const T* src, int r0, int n_rows,
                                               int64_t stride) {
    bf16mma::stage_rows<T, D, R, kThreads>(tile, src, r0, n_rows, stride);
  }

  template <int NT>
  __device__ __forceinline__ static void rows_dot(float (&acc)[NT][4], const T* res, int r0,
                                                  const T* x, int g, int t) {
    bf16mma::rows_dot<T, D, NT>(acc, res, r0, x, g, t);
  }

  template <int NT>
  __device__ __forceinline__ static void weight_rows(float (&acc)[D / 8][4],
                                                     const float (&w)[NT][4], const T* x,
                                                     float scale_lo, float scale_hi, int g,
                                                     int t) {
    bf16mma::weight_rows<T, D, NT, kTerms>(acc, w, x, scale_lo, scale_hi, g, t);
  }

  // The forward's Q rows as bf16 A fragments (rounded on load if T is f32)
  struct Held {
    uint32_t a[KS][4];
  };

  __device__ __forceinline__ static void hold(Held& h, const T* q, const int (&rows)[2],
                                              int n_rows, int64_t stride, int t) {
    bf16mma::a_frags<D>(h.a, t, [&](int i, int c) {
      return rows[i] < n_rows ? bf16mma::ld_pair(q + rows[i] * stride + c) : 0u;
    });
  }

  template <int NT>
  __device__ __forceinline__ static void held_dot(float (&s)[NT][4], const Held& h, const T* x,
                                                  int g, int t) {
    bf16mma::frags_dot<T, D, NT>(s, h.a, x, g, t);
  }
};

}  // namespace flash_ops
