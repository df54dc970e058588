// The masked flash-attention backward's two kinds of tile on Hopper's
// tensor cores (sm_90a), f32-grade through 3xTF32 products, as device
// functions shared by the kernels that launch them: flash_bwd_dkv.cu
// (dk/dv tiles), flash_bwd_dq.cu (dq tiles) and flash_bwd_fused.cu (both
// kinds in one grid, either layout).
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

#include "tf32x3.cuh"

// Every backward entry point (flash_bwd_dkv.cu, flash_bwd_dq.cu,
// flash_bwd_fused.cu) takes these arguments: the pointers of
// flash_bwd_tc::Args in its order, then the batch, the two lengths, the
// heads, the head dim and the CUDA stream. Each reads or writes only the
// pointers it names and ignores the rest (pass null).
#define FLASH_BWD_PARAMS                                                              \
  const float *q, const float *k, const float *v, const uint8_t *mask, const float *o, \
      const float *dout, const float *lse, const float *delta, float *dq, float *dk,   \
      float *dv, int batch, int lq, int lk, int heads, int head_dim, void *stream

namespace flash_bwd_tc {

using namespace tf32x3;

struct Args {
  const float* q;       // [B*H, Lq, D] or [B, Lq, H*D]
  const float* k;       // [B*H, Lk, D] or [B, Lk, H*D]
  const float* v;
  const uint8_t* mask;  // [B, Lk]
  const float* o;       // like q; ble only (delta computed from it)
  const float* dout;    // like q
  const float* lse;     // [B, H, Lq]
  const float* delta;   // [B, H, Lq]; bhld only
  float* dq;            // like q (dq tiles only)
  float* dk;            // like k (dk/dv tiles only)
  float* dv;
  int lq, lk, heads;
};

// f(std::integral_constant<int, D>{}) for the head dims D the kernels are
// built for; cudaErrorInvalidValue for any other
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

// floats between consecutive rows of one head
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

// delta = rowsum(dO * O) of row `row` (rows `stride` floats apart), summed
// over the T consecutive lanes that share the row, lane `part` of them
// taking the float4 columns part + T j; 0 for rows >= n_rows. Every lane of
// the warp calls it.
template <int D, int T>
__device__ __forceinline__ float row_delta(const float* o, const float* dout, int row,
                                           int n_rows, int64_t stride, int part) {
  constexpr int V4 = D / 4;
  float acc = 0.f;
  if (row < n_rows) {
    const float4* o4 = reinterpret_cast<const float4*>(o + row * stride);
    const float4* d4 = reinterpret_cast<const float4*>(dout + row * stride);
#pragma unroll
    for (int j = 0; j < (V4 + T - 1) / T; ++j) {
      const int c = part + T * j;
      if (c < V4) {
        const float4 x = o4[c], y = d4[c];
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
      }
    }
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
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

// dk/dv tile: kWarps warps, 16 * kWarps key rows, BQ queries per streamed tile
template <int D, int kWarps, int BQ>
struct DkvCfg {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;  // key rows per block
  static constexpr int NT = BQ / 8;      // n8 tiles of S^T (per warp)
  static constexpr int DT = D / 8;       // n8 tiles of dK, dV
  static constexpr int TILE = BQ * D;    // floats per Q or dO tile
  // K, V [R, D]; Q, dO x 2 stages; lse, delta x 2 stages
  static constexpr int SMEM = (2 * R * D + 4 * TILE + 4 * BQ) * 4;
};

// dq tile: kWarps warps, 16 * kWarps query rows, kKeys keys per streamed tile
template <int D, int kWarps, int kKeys>
struct DqCfg {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;  // query rows per block
  static constexpr int BK = kKeys;       // keys per tile
  static constexpr int NT = BK / 8;      // n8 tiles of S (per warp)
  static constexpr int DT = D / 8;       // n8 tiles of dQ
  static constexpr int TILE = BK * D;    // floats per K or V tile
  // Q, dO [R, D]; K, V x 2 stages; valid flags x 2 stages
  static constexpr int SMEM = (2 * R * D + 4 * TILE) * 4 + 2 * BK;
};

// dk, dv for key rows [tile * R, tile * R + R) of (batch b, head h)
template <int D, int kWarps, int BQ, bool kBle>
__device__ __forceinline__ void dkv_tile(const Args& a, int tile, int h, int b, float* smem) {
  using C = DkvCfg<D, kWarps, BQ>;
  float* ks = smem;                        // [R, D]
  float* vs = ks + C::R * D;               // [R, D]
  float* qs = vs + C::R * D;               // [2][BQ, D]
  float* dos = qs + 2 * C::TILE;           // [2][BQ, D]
  float* lse_s = dos + 2 * C::TILE;        // [2][BQ]
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
  float* dkb = a.dk + k_base;
  float* dvb = a.dv + k_base;

  const bool any = __syncthreads_or(tid < C::R && k0 + tid < a.lk && mb[k0 + tid]);
  float dk[C::DT][4], dv[C::DT][4];
  zero(dk);
  zero(dv);

  if (any) {
    const float* qb = a.q + q_base;
    const float* dob = a.dout + q_base;
    const float* lseb = a.lse + bh * a.lq;
    const float* deltab = kBle ? nullptr : a.delta + bh * a.lq;
    auto stage = [&](int it, int buf) {
      const int q0 = it * BQ;
      stage_rows<D, BQ, C::kThreads>(qs + buf * C::TILE, qb, q0, a.lq, stride);
      stage_rows<D, BQ, C::kThreads>(dos + buf * C::TILE, dob, q0, a.lq, stride);
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
        constexpr int T = C::kThreads / BQ;  // threads per query row
        static_assert(C::kThreads % BQ == 0 && T <= 32, "T lanes of one warp per row");
        const float d = row_delta<D, T>(a.o + q_base, dob, q0 + tid / T, a.lq, stride, tid % T);
        if (tid % T == 0) delta_s[buf * BQ + tid / T] = d;
      }
    };
    stage_rows<D, C::R, C::kThreads>(ks, a.k + k_base, k0, a.lk, stride);
    stage_rows<D, C::R, C::kThreads>(vs, a.v + k_base, k0, a.lk, stride);
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
        const float* qt = qs + buf * C::TILE;
        const float* dot = dos + buf * C::TILE;
        const float* lse_t = lse_s + buf * BQ;
        const float* delta_t = delta_s + buf * BQ;
        const int q0 = it * BQ;

        // P^T = exp(K.Q^T - lse) on valid keys and live queries, else 0;
        // column j of n-tile nt is query 8 nt + perm(j)
        float p[C::NT][4];
        rows_dot<D, C::NT>(p, ks, r0, qt, g, t);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * nt + t + 4 * (e & 1);
            const bool live = key_ok[e >> 1] && q0 + qi < a.lq;
            p[nt][e] = live ? expf(p[nt][e] - lse_t[qi]) : 0.f;
          }
        }
        weight_rows<D, C::NT>(dv, p, dot, 1.f, 1.f, g, t);  // dV += P^T.dO

        // dS^T = P^T (V.dO^T - delta)
        float ds[C::NT][4];
        rows_dot<D, C::NT>(ds, vs, r0, dot, g, t);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[nt][e] = p[nt][e] * (ds[nt][e] - delta_t[8 * nt + t + 4 * (e & 1)]);
          }
        }
        weight_rows<D, C::NT>(dk, ds, qt, 1.f, 1.f, g, t);  // dK += dS^T.Q
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
      *reinterpret_cast<float2*>(dkb + off + 8 * n) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dvb + off + 8 * n) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dq for query rows [tile * R, tile * R + R) of (batch b, head h)
template <int D, int kWarps, int BK, bool kBle, int kHeld = 0>
__device__ __forceinline__ void dq_tile(const Args& a, int tile, int h, int b, float* smem) {
  using C = DqCfg<D, kWarps, BK>;
  float* qs = smem;                  // [R, D]
  float* dos = qs + C::R * D;        // [R, D]
  float* ks = dos + C::R * D;        // [2][BK, D]
  float* vs = ks + 2 * C::TILE;      // [2][BK, D]
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
  const float* kb = a.k + k_base;
  const float* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;

  const int n_tiles = (a.lk + C::BK - 1) / C::BK;
  stage_rows<D, C::R, C::kThreads>(qs, a.q + q_base, q0, a.lq, stride);
  stage_rows<D, C::R, C::kThreads>(dos, a.dout + q_base, q0, a.lq, stride);
  stage_rows<D, C::BK, C::kThreads>(ks, kb, 0, a.lk, stride);
  stage_rows<D, C::BK, C::kThreads>(vs, vb, 0, a.lk, stride);
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
      stage_rows<D, C::BK, C::kThreads>(ks + (buf ^ 1) * C::TILE, kb, k1, a.lk, stride);
      stage_rows<D, C::BK, C::kThreads>(vs + (buf ^ 1) * C::TILE, vb, k1, a.lk, stride);
      mv = tid < C::BK && k1 + tid < a.lk ? mb[k1 + tid] : 0;
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile it have landed (this thread's copies)
    if (!__syncthreads_or(mine)) continue;  // every key of the tile is masked

    if (warp_live) {
      const float* kt = ks + buf * C::TILE;
      const float* vt = vs + buf * C::TILE;
      const uint8_t* ok = valid + buf * C::BK;

      // S = Q.K^T and dP = dO.V^T; column j of n-tile nt holds key 8 nt + perm(j)
      float s[C::NT][4], dp[C::NT][4];
      if constexpr (kHeld > 0) {
        frags_dot<D, C::NT>(s, qh, ql, kt, g, t);
      } else {
        rows_dot<D, C::NT>(s, qs, r0, kt, g, t);
      }
      if constexpr (kHeld > 1) {
        frags_dot<D, C::NT>(dp, dh, dl, vt, g, t);
      } else {
        rows_dot<D, C::NT>(dp, dos, r0, vt, g, t);
      }
      // dS = P (dP - delta), P = exp(S - lse) on valid keys, else 0
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = ok[8 * nt + t + 4 * (e & 1)];
          const float p = live ? expf(s[nt][e] - lse[e >> 1]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - delta[e >> 1]);
        }
      }
      // dQ += dS.K: n-tile nt of dS is the A fragment of k-step nt
      weight_rows<D, C::NT>(dq, s, kt, 1.f, 1.f, g, t);
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.lq) continue;
    float* row = a.dq + q_base + rows[i] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DT; ++n) {
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(dq[n][2 * i], dq[n][2 * i + 1]);
    }
  }
}

}  // namespace flash_bwd_tc
