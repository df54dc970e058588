// The masked flash-attention backward's two kinds of tile on Hopper's
// tensor cores (sm_90a), as device functions shared by the kernels that
// launch them: flash_bwd_dkv.cuh (dk/dv tiles), flash_bwd_dq.cuh (dq tiles)
// and flash_bwd_fused.cuh (both kinds in one grid, either layout). Each
// tile takes its products from a mode of flash_ops.cuh (template kMode):
// f32-grade 3xTF32 (kF32, described below; the element type float), or the
// bf16 modes on m16n8k16 bf16 products (bf16 refs, or mxu_bf16 on f32 or
// bf16 refs), whose C fragments hold the streamed tile's rows in natural
// order instead of tf32x3::perm order (Ops::col). Everything else below
// holds in every mode; tiles hold the mode's element type.
//
// What they compute, per (batch, head): q, dO, o [B*H, Lq, D] and k, v
// [B*H, Lk, D] (the classic layout, bhld), or q, dO, o [B, Lq, H*D] and k, v
// [B, Lk, H*D] with head h the columns [h*D, (h+1)*D) (the projection
// layout, ble: template flag kBle); q already scaled, mask [B, Lk] (nonzero
// = valid), the forward's lse [B, H, Lq], and delta = rowsum(dO * O) [B, H,
// Lq], given in bhld and computed here from o and dO in ble. With
// p_ij = exp(q_i . k_j - lse_i) for valid keys j (0 for masked keys),
// dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i):
//   dq_i = sum_j ds_ij k_j,  dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i.
// Masked keys, and every key of a sample with no valid key, get exactly 0;
// so does every query row of such a sample.
//
// The layouts differ only in where a head's rows start and how far apart
// they are (head_base, row_stride): in bhld both are compile-time multiples
// of D, as before the ble instantiation existed; in ble a head's D floats
// stay contiguous and 16-byte aligned, so the cp.async copies are the same.
//
// dk/dv tile (FlashAttention-2's backward outer loop on mma.sync m16n8k8
// tf32, helpers in tf32x3.cuh):
//  * a block of kWarps warps owns 16 * kWarps key rows of one (batch, head),
//    16 per warp. dK and dV [16 x D per warp] stay in f32 C fragments in
//    registers for the whole loop; no atomics, so the result is
//    deterministic.
//  * the block's K and V stay resident in shared memory for the loop, raw
//    f32, and are split into hi/lo at each A-fragment load (12 ALU
//    operations per 24 mma at D = 64); kept pre-split they would take 128
//    registers or 64 KB more, halving the blocks per SM.
//  * tiles of BQ queries of Q and dO, with their lse and delta, stream
//    through a double-buffered cp.async ring in dynamic shared memory (96 KB
//    per block at D = 64 with 4 warps and BQ 64: two blocks per SM),
//    XOR-swizzled so that both fragment reads (as B of K.Q^T and of Q as
//    the right factor of dS^T.Q) are free of bank conflicts. In ble the
//    tile's delta is computed while its copies are in flight (kThreads / BQ
//    threads per query row, O and dO read from global memory) and stored
//    to shared memory; the barrier before the tile's use orders it. Every
//    dk/dv block of a (batch, head) recomputes the same Lq x D products:
//    1/(4 D) of the tile's own multiply-adds.
//  * per tile, four 3xTF32 products: S^T = K.Q^T and dP^T = V.dO^T, with
//    Q's and dO's rows read in tf32x3::perm order so their C fragments are
//    the A fragments of dV += P^T.dO and dK += dS^T.Q (no shuffles), each
//    tile's part summed in fresh accumulators and added once
//    (tf32x3::weight_rows);
//    P^T = exp(S^T - lse) by select on valid keys and query rows < Lq,
//    dS^T = P^T (dP^T - delta). Select, never a product with the mask: a
//    sample with no valid key has lse = -1e30, so exp(s - lse) is inf
//    there and inf * 0 would be NaN.
//  * a block whose keys are all masked writes zeros and stops; a warp
//    whose 16 keys are all masked or past Lk skips the products (its dK
//    and dV are 0).
//
// dq tile (the same machinery, rows and columns swapped):
//  * a block of kWarps warps owns 16 * kWarps query rows, 16 per warp. The
//    block's Q and dO rows are staged once into shared memory; each thread
//    keeps its two rows' lse and delta in registers (in ble delta is summed
//    over the thread's quad from O and dO in global memory, once). dQ
//    [16 x D per warp] stays in C fragments.
//  * kHeld of Q and dO (0, 1: Q, 2: both) are split once into hi/lo A
//    fragments held in registers (D registers each); the others stay raw
//    f32 in shared memory and are split at each A-fragment load. Inside the
//    fused kernel kHeld is 0: its registers are the dk/dv tile's.
//  * K and V stream in BK-key tiles (32 in the fused kernel, 64 in
//    flash_bwd_dq at D <= 64) through a double-buffered cp.async ring, as in
//    the forward (flash_fwd.cu), with the tile's mask bytes.
//  * per tile: S = Q.K^T and dP = dO.V^T in 3xTF32, K's and V's rows read in
//    perm order so that the C fragments are the next A fragments;
//    P = exp(S - lse) by select on valid keys; dS = P (dP - delta);
//    dQ += dS.K through tf32x3::weight_rows (fresh accumulators per tile).
//  * a key tile whose keys are all masked is skipped (uniform in the
//    block), so a sample with no valid key writes dQ = 0 and its delta is
//    never used; a warp whose rows are all past Lq skips the products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_ops.cuh"
#include "tf32x3.cuh"

// Every backward entry point (flash_bwd_*.cu) takes these arguments, T the
// element type of its mode (flash_ops.cuh; void for the mxu_bf16 ones,
// which also take bf16_refs, see mxu_call): the pointers of
// flash_bwd_tc::Args<T> in its order, then the batch, the two lengths, the
// heads, the head dim and the CUDA stream. Each reads or writes only the
// pointers it names and ignores the rest (pass null).
#define FLASH_BWD_PARAMS(T)                                                          \
  const T *q, const T *k, const T *v, const uint8_t *mask, const T *o, const T *dout, \
      const float *lse, const float *delta, T *dq, T *dk, T *dv, int batch, int lq,   \
      int lk, int heads, int head_dim, void *stream

namespace flash_bwd_tc {

using namespace tf32x3;
using flash_ops::Elem;
using flash_ops::kF32;
using flash_ops::Ops;
using flash_ops::with_head_dim;

template <class T>
struct Args {
  const T* q;           // [B*H, Lq, D] or [B, Lq, H*D]
  const T* k;           // [B*H, Lk, D] or [B, Lk, H*D]
  const T* v;
  const uint8_t* mask;  // [B, Lk]
  const T* o;           // like q; ble only (delta computed from it)
  const T* dout;        // like q
  const float* lse;     // [B, H, Lq]
  const float* delta;   // [B, H, Lq]; bhld only
  T* dq;                // like q (dq tiles only)
  T* dk;                // like k (dk/dv tiles only)
  T* dv;
  int lq, lk, heads;
};

// An mxu_bf16 entry point's call: its untyped pointers cast to the element
// type of mode kMxuBf16 (bf16_refs 1) or kMxuF32 (0), passed with the mode
// to f(std::integral_constant<int, mode>, q, k, ..., stream).
template <class F>
int mxu_call(int bf16_refs, FLASH_BWD_PARAMS(void), F f) {
  auto call = [&](auto mode) {
    using T = Elem<decltype(mode)::value>;
    return f(mode, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
             mask, static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
             static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), batch, lq, lk, heads,
             head_dim, stream);
  };
  return bf16_refs ? call(std::integral_constant<int, flash_ops::kMxuBf16>{})
                   : call(std::integral_constant<int, flash_ops::kMxuF32>{});
}

// elements between consecutive rows of one head
template <int D, bool kBle>
__device__ __forceinline__ int64_t row_stride(int heads) {
  return kBle ? static_cast<int64_t>(heads) * D : D;
}

// where (batch b, head h)'s first row of an operand with n rows starts
template <int D, bool kBle>
__device__ __forceinline__ int64_t head_base(int b, int h, int heads, int n) {
  return kBle ? (static_cast<int64_t>(b) * n * heads + h) * D
              : (static_cast<int64_t>(b) * heads + h) * n * D;
}

// delta = rowsum(dO * O) in f32 of row `row` (rows `stride` elements
// apart), summed over the TL consecutive lanes that share the row, lane
// `part` of them taking the 16-byte chunks part + TL j; 0 for rows >=
// n_rows. Every lane of the warp calls it.
template <int D, int TL, class T>
__device__ __forceinline__ float row_delta(const T* o, const T* dout, int row, int n_rows,
                                           int64_t stride, int part) {
  constexpr int V = D * static_cast<int>(sizeof(T)) / 16;
  float acc = 0.f;
  if (row < n_rows) {
    const uint4* o4 = reinterpret_cast<const uint4*>(o + row * stride);
    const uint4* d4 = reinterpret_cast<const uint4*>(dout + row * stride);
#pragma unroll
    for (int j = 0; j < (V + TL - 1) / TL; ++j) {
      const int c = part + TL * j;
      if (c < V) acc = bf16mma::chunk_dot<T>(o4[c], d4[c], acc);
    }
  }
#pragma unroll
  for (int off = TL / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// dk/dv tile: kWarps warps, 16 * kWarps key rows, BQ queries per streamed
// tile, elements of T
template <int D, int kWarps, int BQ, class T = float>
struct DkvCfg {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;  // key rows per block
  static constexpr int NT = BQ / 8;      // n8 tiles of S^T (per warp)
  static constexpr int DT = D / 8;       // n8 tiles of dK, dV
  static constexpr int TILE = BQ * D;    // elements per Q or dO tile
  // K, V [R, D]; Q, dO x 2 stages; lse, delta x 2 stages (f32)
  static constexpr int SMEM = (2 * R * D + 4 * TILE) * static_cast<int>(sizeof(T)) + 4 * BQ * 4;
};

// dq tile: kWarps warps, 16 * kWarps query rows, kKeys keys per streamed
// tile, elements of T
template <int D, int kWarps, int kKeys, class T = float>
struct DqCfg {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;  // query rows per block
  static constexpr int BK = kKeys;       // keys per tile
  static constexpr int NT = BK / 8;      // n8 tiles of S (per warp)
  static constexpr int DT = D / 8;       // n8 tiles of dQ
  static constexpr int TILE = BK * D;    // elements per K or V tile
  // Q, dO [R, D]; K, V x 2 stages; valid flags x 2 stages
  static constexpr int SMEM = (2 * R * D + 4 * TILE) * static_cast<int>(sizeof(T)) + 2 * BK;
};

// dk, dv for key rows [tile * R, tile * R + R) of (batch b, head h)
template <int D, int kWarps, int BQ, bool kBle, int kMode = kF32>
__device__ __forceinline__ void dkv_tile(const Args<Elem<kMode>>& a, int tile, int h, int b,
                                         float* smem) {
  using T = Elem<kMode>;
  using C = DkvCfg<D, kWarps, BQ, T>;
  using O = Ops<kMode, D>;
  T* ks = reinterpret_cast<T*>(smem);      // [R, D]
  T* vs = ks + C::R * D;                   // [R, D]
  T* qs = vs + C::R * D;                   // [2][BQ, D]
  T* dos = qs + 2 * C::TILE;               // [2][BQ, D]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * C::TILE);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;         // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const int64_t stride = row_stride<D, kBle>(a.heads);
  const int64_t q_base = head_base<D, kBle>(b, h, a.heads, a.lq);
  const int64_t k_base = head_base<D, kBle>(b, h, a.heads, a.lk);
  const int k0 = tile * C::R;
  const int r0 = warp * 16;                            // the warp's rows in the tile
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's key rows
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const bool key_ok[2] = {keys[0] < a.lk && mb[keys[0]], keys[1] < a.lk && mb[keys[1]]};
  T* dkb = a.dk + k_base;
  T* dvb = a.dv + k_base;

  const bool any = __syncthreads_or(tid < C::R && k0 + tid < a.lk && mb[k0 + tid]);
  float dk[C::DT][4], dv[C::DT][4];
  zero(dk);
  zero(dv);

  if (any) {
    const T* qb = a.q + q_base;
    const T* dob = a.dout + q_base;
    const float* lseb = a.lse + bh * a.lq;
    const float* deltab = kBle ? nullptr : a.delta + bh * a.lq;
    auto stage = [&](int it, int buf) {
      const int q0 = it * BQ;
      O::template stage<BQ, C::kThreads>(qs + buf * C::TILE, qb, q0, a.lq, stride);
      O::template stage<BQ, C::kThreads>(dos + buf * C::TILE, dob, q0, a.lq, stride);
      // j < BQ: lse of query j, else delta of j - BQ (given in bhld only)
      constexpr int kStats = kBle ? BQ : 2 * BQ;
      auto stage_stat = [&](int j) {
        const int i = j % BQ;
        const bool live = q0 + i < a.lq;
        const float* src = (j < BQ ? lseb : deltab) + (live ? q0 + i : 0);
        cp_async4((j < BQ ? lse_s : delta_s) + buf * BQ + i, src, live);
      };
      if constexpr (kStats <= C::kThreads) {
        if (tid < kStats) stage_stat(tid);
      } else {
        for (int j = tid; j < kStats; j += C::kThreads) stage_stat(j);
      }
      if constexpr (kBle) {  // delta of the tile's queries, while the copies fly
        constexpr int TL = C::kThreads / BQ;  // threads per query row
        static_assert(C::kThreads % BQ == 0 && TL <= 32, "TL lanes of one warp per row");
        const float d = row_delta<D, TL>(a.o + q_base, dob, q0 + tid / TL, a.lq, stride,
                                         tid % TL);
        if (tid % TL == 0) delta_s[buf * BQ + tid / TL] = d;
      }
    };
    O::template stage<C::R, C::kThreads>(ks, a.k + k_base, k0, a.lk, stride);
    O::template stage<C::R, C::kThreads>(vs, a.v + k_base, k0, a.lk, stride);
    stage(0, 0);
    cp_async_commit();

    const int n_tiles = (a.lq + BQ - 1) / BQ;
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // K, V and tile it have landed (this thread's copies)
      __syncthreads();     // ... and everyone's (and tile it's delta stores)

      if (__any_sync(0xffffffffu, key_ok[0] || key_ok[1])) {  // a valid key in the warp
        const T* qt = qs + buf * C::TILE;
        const T* dot = dos + buf * C::TILE;
        const float* lse_t = lse_s + buf * BQ;
        const float* delta_t = delta_s + buf * BQ;
        const int q0 = it * BQ;

        // P^T = exp(K.Q^T - lse) on valid keys and live queries, else 0;
        // element e of n-tile nt is query O::col(nt, e, t)
        float p[C::NT][4];
        O::template rows_dot<C::NT>(p, ks, r0, qt, g, t);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = O::col(nt, e, t);
            const bool live = key_ok[e >> 1] && q0 + qi < a.lq;
            p[nt][e] = live ? expf(p[nt][e] - lse_t[qi]) : 0.f;
          }
        }
        O::template weight_rows<C::NT>(dv, p, dot, 1.f, 1.f, g, t);  // dV += P^T.dO

        // dS^T = P^T (V.dO^T - delta)
        float ds[C::NT][4];
        O::template rows_dot<C::NT>(ds, vs, r0, dot, g, t);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[nt][e] = p[nt][e] * (ds[nt][e] - delta_t[O::col(nt, e, t)]);
          }
        }
        O::template weight_rows<C::NT>(dk, ds, qt, 1.f, 1.f, g, t);  // dK += dS^T.Q
      }
      __syncthreads();  // every warp is done with buf before it is refilled
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.lk) continue;
    const int64_t off = keys[i] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DT; ++n) {
      bf16mma::store_pair(dkb + off + 8 * n, dk[n][2 * i], dk[n][2 * i + 1]);
      bf16mma::store_pair(dvb + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dq for query rows [tile * R, tile * R + R) of (batch b, head h)
template <int D, int kWarps, int BK, bool kBle, int kHeld = 0, int kMode = kF32>
__device__ __forceinline__ void dq_tile(const Args<Elem<kMode>>& a, int tile, int h, int b,
                                        float* smem) {
  static_assert(kHeld == 0 || kMode == kF32, "held split fragments are 3xTF32's");
  using T = Elem<kMode>;
  using C = DqCfg<D, kWarps, BK, T>;
  using O = Ops<kMode, D>;
  T* qs = reinterpret_cast<T*>(smem);  // [R, D]
  T* dos = qs + C::R * D;              // [R, D]
  T* ks = dos + C::R * D;              // [2][BK, D]
  T* vs = ks + 2 * C::TILE;            // [2][BK, D]
  uint8_t* valid = reinterpret_cast<uint8_t*>(vs + 2 * C::TILE);  // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const int64_t stride = row_stride<D, kBle>(a.heads);
  const int64_t q_base = head_base<D, kBle>(b, h, a.heads, a.lq);
  const int64_t k_base = head_base<D, kBle>(b, h, a.heads, a.lk);
  const int q0 = tile * C::R;
  const int r0 = warp * 16;                            // the warp's rows in the tile
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's query rows
  const bool warp_live = q0 + r0 < a.lq;
  const T* kb = a.k + k_base;
  const T* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;

  const int n_tiles = (a.lk + C::BK - 1) / C::BK;
  O::template stage<C::R, C::kThreads>(qs, a.q + q_base, q0, a.lq, stride);
  O::template stage<C::R, C::kThreads>(dos, a.dout + q_base, q0, a.lq, stride);
  O::template stage<C::BK, C::kThreads>(ks, kb, 0, a.lk, stride);
  O::template stage<C::BK, C::kThreads>(vs, vb, 0, a.lk, stride);
  cp_async_commit();
  uint8_t mv = tid < C::BK && tid < a.lk ? mb[tid] : 0;  // next tile's flag

  float lse[2], delta[2];  // rows past Lq: 0, so that p (dp - delta) stays finite
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = rows[i] < a.lq;
    lse[i] = live ? a.lse[bh * a.lq + rows[i]] : 0.f;
    if constexpr (kBle) {  // summed over the quad that shares the row
      delta[i] = row_delta<D, 4>(a.o + q_base, a.dout + q_base, rows[i], a.lq, stride, t);
    } else {
      delta[i] = live ? a.delta[bh * a.lq + rows[i]] : 0.f;
    }
  }

  // the warp's rows of Q (and of dO) as split A fragments, held in registers
  uint32_t qh[kHeld > 0 ? C::DT : 1][4], ql[kHeld > 0 ? C::DT : 1][4];
  uint32_t dh[kHeld > 1 ? C::DT : 1][4], dl[kHeld > 1 ? C::DT : 1][4];
  if constexpr (kHeld > 0) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::DT; ++kk) {
      load_a<D>(qs, r0, kk, g, t, qh[kk], ql[kk]);
      if constexpr (kHeld > 1) load_a<D>(dos, r0, kk, g, t, dh[kk], dl[kk]);
    }
  }

  float dq[C::DT][4];
  zero(dq);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const uint8_t mine = mv;
    if (tid < C::BK) valid[buf * C::BK + tid] = mine;
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the other buffer
      const int k1 = (it + 1) * C::BK;
      O::template stage<C::BK, C::kThreads>(ks + (buf ^ 1) * C::TILE, kb, k1, a.lk, stride);
      O::template stage<C::BK, C::kThreads>(vs + (buf ^ 1) * C::TILE, vb, k1, a.lk, stride);
      mv = tid < C::BK && k1 + tid < a.lk ? mb[k1 + tid] : 0;
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile it have landed (this thread's copies)
    if (!__syncthreads_or(mine)) continue;  // every key of the tile is masked

    if (warp_live) {
      const T* kt = ks + buf * C::TILE;
      const T* vt = vs + buf * C::TILE;
      const uint8_t* ok = valid + buf * C::BK;

      // S = Q.K^T and dP = dO.V^T; element e of n-tile nt holds key O::col(nt, e, t)
      float s[C::NT][4], dp[C::NT][4];
      if constexpr (kHeld > 0) {
        frags_dot<D, C::NT>(s, qh, ql, kt, g, t);
      } else {
        O::template rows_dot<C::NT>(s, qs, r0, kt, g, t);
      }
      if constexpr (kHeld > 1) {
        frags_dot<D, C::NT>(dp, dh, dl, vt, g, t);
      } else {
        O::template rows_dot<C::NT>(dp, dos, r0, vt, g, t);
      }
      // dS = P (dP - delta), P = exp(S - lse) on valid keys, else 0
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = ok[O::col(nt, e, t)];
          const float p = live ? expf(s[nt][e] - lse[e >> 1]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - delta[e >> 1]);
        }
      }
      // dQ += dS.K: dS's C fragments are the A fragments of the product
      O::template weight_rows<C::NT>(dq, s, kt, 1.f, 1.f, g, t);
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.lq) continue;
    T* row = a.dq + q_base + rows[i] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DT; ++n) {
      bf16mma::store_pair(row + 8 * n, dq[n][2 * i], dq[n][2 * i + 1]);
    }
  }
}

}  // namespace flash_bwd_tc
