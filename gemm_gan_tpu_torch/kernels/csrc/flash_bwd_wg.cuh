// The attention backward's two kinds of tile on Hopper's warpgroup MMA
// (wgmma.mma_async, wgmma.cuh), for the bf16-ref modes (kBf16: P and dS in
// three bf16 terms, f32-exact; kMxuBf16, mxu_bf16 on bf16 refs: P and dS
// rounded once) at head dims 16, 32 and 64: both in the single-block grids
// of flash_bwd_fused.cuh (flash_bwd_ble_*, flash_bwd_bhld_fused_*), the dk/dv
// tile alone in flash_bwd_dkv.cuh's grid and the dq tile alone in
// flash_bwd_dq.cuh's. They replace the Pallas TPU kernels `_bwd_kernel_ble`
// (gemm_gan_tpu/kernels/flash_attention.py:317), `_bwd_fused_kernel`
// (:179), `_bwd_dq_kernel` (:142) and `_bwd_dkv_kernel` (:220) in those
// modes; what they compute, the layouts
// and the masking rules are flash_bwd_tc.cuh's, whose mma.sync tiles still
// serve the f32 modes, mxu_bf16 on f32 refs (cp.async cannot round f32 to
// bf16 as it stages) and head dims 8 (no k16 step) and 128 (a 256-byte row
// is two swizzle atoms, and dK, dV alone would take 128 registers).
//
// What bounds them on an H100: at the canonical shape (B 8, H 4, L 257,
// D 64) the kBf16 mode is 11 bf16 passes of the five 0.27 GFLOP products
// (S and dP once, dV, dK and dQ in three terms): 0.0030 ms at 989 TFLOP/s,
// against 0.0025 ms for its 8.4 MB (ble) at 3.35 TB/s: operations. Under
// mxu_bf16 one pass each, 0.0014 ms: bytes. Both are far below what one
// 64-row tile's chain of loads, barriers and dependent products costs, so
// the design aims at latency: one wave, no fragment loads by the threads,
// no branch in the softmax, few barriers.
//
// Design (one warpgroup of 4 warps per block, a 64-row tile of either kind;
// the fused kernel's grid, dk/dv tiles first):
//  * Products on wgmma m64nNk16, bf16 in, f32 accumulate. dk/dv tile:
//    S^T = K.Q^T and dP^T = V.dO^T with both operands in shared memory
//    (K-major), issued back to back; P^T is computed from the first while
//    the second runs (wait_group 1). dV += P^T.dO and dK += dS^T.Q take A
//    from registers (the accumulators packed to bf16: no shuffle, no
//    shared-memory bounce) and B = dO, Q in shared memory read MN-major
//    (the transpose bit of 16-bit types). dq tile: S = Q.K^T and dP = dO.V^T,
//    then dQ += dS.K the same way. No fragment is loaded by the threads: the
//    mma.sync tiles issued about one shared-memory load per tensor-core
//    instruction (bf16mma::col_pair's two 16-bit loads per register); with
//    ldmatrix.x4 they ran 13-15% faster, the wgmma tile 1.9-2.2x (PERF.md).
//  * Tiles are staged by cp.async in wgmma's canonical swizzled layout
//    (wgmma::offset: at D 64 the same 128-byte swizzle as bf16mma::swz),
//    each on a 1,024-byte boundary; after a tile lands each thread fences
//    the async proxy, then the block's barrier, then the wgmmas.
//  * dk/dv tiles stream 64 queries per step (five steps at L 257), with K
//    and V resident; dq tiles stream 64 keys (the ring's depth and the
//    sub-step are template arguments). 32-query steps cost Q6 bf16 5% in
//    barriers. Each step's products run in sub-steps of 32 queries (keys),
//    so that a sub-step's P^T and dS^T and their three bf16 terms fit in
//    registers beside dK and dV (64 f32 registers per thread at D 64); a
//    sub-step past the length is skipped (the tail of L 257 costs one
//    sub-step, not two). The dq tile alone (Q4, 65 steps at L 4,097) holds
//    only dQ (32 registers) and takes one 64-key sub-step a step through a
//    ring of 3 (flash_bwd_dq.cuh): 5-7% faster there; the 64-key sub-step
//    ran 7-10% slower in the fused grids, which keep 32 and a ring of 2.
//    dK, dV and dQ accumulate in the wgmma accumulators across the steps.
//  * A sub-step's products are waited for as soon as they are issued. Left
//    in flight past the next sub-step's score products, the three-term A
//    registers made ptxas serialize every wgmma of the kernel (C7512,
//    "insufficient register resources"): Q6 bf16 0.0241 against 0.0212 ms.
//  * P = exp(s - lse) takes the select on its argument (exp(-inf) = 0):
//    `live ? expf(..) : 0` compiled to one divergent branch per element and
//    ran the 16 exps of a sub-step one after another; the branch-free form
//    took Q6 bf16 from 0.0254 to 0.0212 ms.
//  * Registers: __launch_bounds__ asks for 3 blocks per SM (at most 168
//    registers), so that the canonical grid of 320 blocks runs in one wave
//    on 132 SMs. Uncapped, the ble kernel takes 179 registers, 2 blocks per
//    SM and 0.0277 against 0.0244 ms; the classic layout's fits in 168
//    either way.
//  * Every warp of the block takes part in every product (wgmma is
//    warpgroup-wide): a warp whose keys are all masked is no longer skipped;
//    a block whose keys are all masked still writes zeros and stops, and a
//    dq tile skips a key step whose keys are all masked.
//  * ble: the dk/dv tile stages each step's O rows beside dO and computes
//    the step's delta from the two tiles (2 threads per query row) while
//    the step's first score products run, then a barrier; the dq tile takes
//    its rows' delta from its staged O and dO once: read from global memory
//    at every step instead, as the mma.sync tiles do, O holds each step for
//    a round trip.
// Times: device ms at B 8, H 4, L 257, D 64 on an NVIDIA H100 80GB HBM3 at
// a 700 W limit (scripts/torch_kernel_variants.py; PERF.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

#include "flash_bwd_tc.cuh"
#include "wg_tile.cuh"
#include "wgmma.cuh"

namespace flash_bwd_wg {

using bf16 = __nv_bfloat16;
using flash_bwd_tc::Args;
// the warpgroup tiles' shared pieces (wg_tile.cuh)
using wg_tile::a_terms;
using wg_tile::aligned;
using wg_tile::issue_rs;
using wg_tile::issue_ss;
using wg_tile::kTakes;
using wg_tile::kThreads;
using wg_tile::R;
using wg_tile::stage;

constexpr int kQueries = 64;   // queries per streamed step of a dk/dv tile
constexpr int kSubQueries = 32;  // queries per product sub-step of a dk/dv step
constexpr int kKeys = 64;      // keys per streamed step of a dq tile
constexpr int kSubKeys = 32;   // keys per product sub-step of a dq step (the fused grids')
constexpr int kDqStages = 2;   // buffers of a dq tile's K, V ring (the fused grids')
constexpr int kMinBlocks = 3;  // blocks per SM that __launch_bounds__ asks for
constexpr int kDkvStages = 2;  // buffers of a dk/dv tile's Q, dO, lse, delta ring
constexpr float kMinusInf = -std::numeric_limits<float>::infinity();  // expf: exactly 0

// bytes of a dq tile's tiles: Q, dO (and O in ble) resident; a step's K, V
// and their valid flags x NS buffers
template <int D, bool kBle, int NS = kDqStages>
constexpr int dq_bytes() {
  return (kBle ? 3 : 2) * R * D * 2 + NS * (2 * kKeys * D * 2 + kKeys);
}

template <int D, bool kBle>
struct Cfg {
  static constexpr int kRes = R * D * 2;         // bytes of a resident [64, D] tile
  static constexpr int kQTile = kQueries * D * 2;
  // K, V; Q, dO (and O in ble) x kDkvStages; lse, delta x kDkvStages (f32)
  static constexpr int kDkv =
      2 * kRes + kDkvStages * ((kBle ? 3 : 2) * kQTile + 2 * kQueries * 4);
  // the fused grids' dq tile
  static constexpr int kDq = dq_bytes<D, kBle>();
  // the larger of the two, and room to put the tiles on a 1,024-byte boundary
  static constexpr int SMEM = (kDkv > kDq ? kDkv : kDq) + 1024;
};

// Every thread's copies but its last N committed groups have landed, and are
// visible to the async proxy (wgmma) of every thread of the block.
template <int N>
__device__ __forceinline__ void landed_for_wgmma() {
  tf32x3::cp_async_wait<N>();
  wgmma::fence_proxy_async();
  __syncthreads();
}

// delta = rowsum(dO * O) in f32 of row r of two staged [rows, D] tiles,
// summed over the TL consecutive lanes that share the row, lane `part` of
// them taking the 16-byte granules part + TL j (as flash_bwd_tc::row_delta
// from global memory). Every lane of the warp calls it.
template <int D, int TL>
__device__ __forceinline__ float tile_row_delta(const uint8_t* o, const uint8_t* dout, int r,
                                                int part) {
  constexpr int V = D / 8;  // granules per row
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < (V + TL - 1) / TL; ++j) {
    const int c = part + TL * j;
    if (c < V) {
      const uint32_t at = wgmma::offset<D>(r, 8 * c);
      d = bf16mma::chunk_dot<bf16>(*reinterpret_cast<const uint4*>(o + at),
                                   *reinterpret_cast<const uint4*>(dout + at), d);
    }
  }
#pragma unroll
  for (int off = TL / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  return d;
}

// dk, dv for key rows [tile * 64, tile * 64 + 64) of (batch b, head h)
template <int D, bool kBle, int kTerms>
__device__ __forceinline__ void dkv_tile(const Args<bf16>& a, int tile, int h, int b,
                                         uint8_t* smem) {
  using C = Cfg<D, kBle>;
  constexpr int BQ = kQueries;
  constexpr int kSub = BQ < kSubQueries ? BQ : kSubQueries;
  constexpr int NT = kSub / 8;  // n8 tiles of a sub-step's S^T
  constexpr int DT = D / 8;   // n8 tiles of dK, dV
  uint8_t* ks = smem;                  // [64, D]
  uint8_t* vs = ks + C::kRes;          // [64, D]
  constexpr int NS = kDkvStages;
  uint8_t* qs = vs + C::kRes;           // [NS][BQ, D]
  uint8_t* dos = qs + NS * C::kQTile;   // [NS][BQ, D]
  uint8_t* os = dos + NS * C::kQTile;   // [NS][BQ, D], ble only
  float* lse_s = reinterpret_cast<float*>(os + (kBle ? NS * C::kQTile : 0));  // [NS][BQ]
  float* delta_s = lse_s + NS * BQ;                                          // [NS][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const int64_t stride = flash_bwd_tc::row_stride<D, kBle>(a.heads);
  const int64_t q_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lq);
  const int64_t k_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lk);
  const int k0 = tile * R;
  const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};  // this thread's key rows
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const bool key_ok[2] = {keys[0] < a.lk && mb[keys[0]], keys[1] < a.lk && mb[keys[1]]};

  const bool any = __syncthreads_or(tid < R && k0 + tid < a.lk && mb[k0 + tid]);
  float dk[DT][4], dv[DT][4];
  tf32x3::zero(dk);
  tf32x3::zero(dv);

  if (any) {
    const bf16* qb = a.q + q_base;
    const bf16* dob = a.dout + q_base;
    const float* lseb = a.lse + bh * a.lq;
    const float* deltab = kBle ? nullptr : a.delta + bh * a.lq;
    auto stage_step = [&](int it, int buf) {
      const int q0 = it * BQ;
      stage<D, BQ>(qs + buf * C::kQTile, qb, q0, a.lq, stride);
      stage<D, BQ>(dos + buf * C::kQTile, dob, q0, a.lq, stride);
      if constexpr (kBle) stage<D, BQ>(os + buf * C::kQTile, a.o + q_base, q0, a.lq, stride);
      // j < BQ: lse of query j, else delta of j - BQ (given in bhld only)
      constexpr int kStats = kBle ? BQ : 2 * BQ;
      static_assert(kStats <= kThreads, "one statistic per thread");
      if (tid < kStats) {
        const int i = tid % BQ;
        const bool live = q0 + i < a.lq;
        const float* src = (tid < BQ ? lseb : deltab) + (live ? q0 + i : 0);
        tf32x3::cp_async4((tid < BQ ? lse_s : delta_s) + buf * BQ + i, src, live);
      }
    };
    // ble: delta = rowsum(dO * O) in f32 of the queries staged in buf, from
    // the tiles, TL threads per row (every thread's copies must have landed;
    // a barrier must follow before delta_s is read; a split-phase mbarrier,
    // arrived at after the store and waited on before dS, ran no faster)
    auto step_delta = [&](int buf) {
      constexpr int TL = kThreads / BQ;
      static_assert(kThreads % BQ == 0 && TL <= 32, "TL lanes of one warp per row");
      const float d = tile_row_delta<D, TL>(os + buf * C::kQTile, dos + buf * C::kQTile, tid / TL,
                                            tid % TL);
      if (tid % TL == 0) delta_s[buf * BQ + tid / TL] = d;
    };
    const int n_steps = (a.lq + BQ - 1) / BQ;
    stage<D, R>(ks, a.k + k_base, k0, a.lk, stride);
    stage<D, R>(vs, a.v + k_base, k0, a.lk, stride);
#pragma unroll
    for (int it = 0; it < NS - 1; ++it) {
      if (it < n_steps) stage_step(it, it);
      tf32x3::cp_async_commit();
    }

    for (int it = 0; it < n_steps; ++it) {
      const int buf = it % NS;
      if (it + NS - 1 < n_steps) stage_step(it + NS - 1, (it + NS - 1) % NS);
      tf32x3::cp_async_commit();
      landed_for_wgmma<NS - 1>();  // K, V and step it
      const uint8_t* qt = qs + buf * C::kQTile;
      const uint8_t* dot = dos + buf * C::kQTile;
      const float* lse_t = lse_s + buf * BQ;
      const float* delta_t = delta_s + buf * BQ;
      const int q0 = it * BQ;

      // The step's products in sub-steps of kSub queries, so that P^T and
      // dS^T of one sub-step (and their bf16 terms) fit in the registers
      // beside dK and dV; a sub-step past Lq is skipped. A sub-step's
      // products are waited for as soon as they are issued: with the A
      // registers of one sub-step in flight past that point, ptxas
      // serializes every wgmma of the kernel in the three-term mode (C7512,
      // "insufficient register resources").
#pragma unroll
      for (int sub = 0; sub < BQ / kSub; ++sub) {
        const int qs0 = sub * kSub;
        if (q0 + qs0 >= a.lq) break;  // the tail of L 257
        const uint32_t rows = qs0 * 2 * D;  // bytes to the sub-step's first query
        // S^T = K.Q^T and dP^T = V.dO^T, back to back; element e of n-tile
        // nt is query qs0 + 8 nt + 2t + (e & 1)
        float p[NT][4], ds[NT][4];
        wgmma::fence();
        issue_ss<D, kSub>(p, ks, qt + rows);
        wgmma::commit();
        issue_ss<D, kSub>(ds, vs, dot + rows);
        wgmma::commit();
        if (kBle && sub == 0) {  // the step's delta, while S^T and dP^T run
          step_delta(buf);
          __syncthreads();
        }
        wgmma::wait<1>();  // S^T done
        wgmma::fence_operand(p);
        // P^T = exp(S^T - lse) on valid keys and live queries, else exactly
        // 0 = exp(-inf): the select is on the argument, so that the 16 exps
        // run without a branch each (`live ? expf(..) : 0` compiled to one
        // divergent branch per element, and the exps ran one after another)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qs0 + 8 * nt + 2 * t + (e & 1);
            const bool live = key_ok[e >> 1] && q0 + qi < a.lq;
            p[nt][e] = expf(live ? p[nt][e] - lse_t[qi] : kMinusInf);
          }
        }
        wgmma::wait<0>();
        wgmma::fence_operand(ds);
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[nt][e] = p[nt][e] * (ds[nt][e] - delta_t[qs0 + 8 * nt + 2 * t + (e & 1)]);
          }
        }
        // dV += P^T.dO, then dK += dS^T.Q, A from registers
        uint32_t pa[NT / 2][kTerms][4], da[NT / 2][kTerms][4];
        a_terms<kTerms>(pa, p);
        wgmma::fence();
        issue_rs<D, kTerms>(dv, pa, dot + rows);
        a_terms<kTerms>(da, ds);
        wgmma::fence();
        issue_rs<D, kTerms>(dk, da, qt + rows);
        wgmma::commit();
        wgmma::wait<0>();
      }
      wgmma::fence_operand(dv);
      wgmma::fence_operand(dk);
      __syncthreads();  // every warp is done with buf before it is refilled
    }
    tf32x3::cp_async_wait<0>();
  }

  bf16* dkb = a.dk + k_base;
  bf16* dvb = a.dv + k_base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.lk) continue;
    const int64_t off = keys[i] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      bf16mma::store_pair(dkb + off + 8 * n, dk[n][2 * i], dk[n][2 * i + 1]);
      bf16mma::store_pair(dvb + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dq for query rows [tile * 64, tile * 64 + 64) of (batch b, head h): K and
// V stream in steps of kKeys keys through a ring of NS buffers, each step's
// products in sub-steps of kSub keys
template <int D, bool kBle, int kTerms, int NS = kDqStages, int kSub = kSubKeys>
__device__ __forceinline__ void dq_tile(const Args<bf16>& a, int tile, int h, int b,
                                        uint8_t* smem) {
  constexpr int BK = kKeys;
  static_assert(BK % kSub == 0 && kSub % 16 == 0, "a step is whole sub-steps of k16 steps");
  static_assert(BK <= kThreads && NS >= 2, "one key's flag per thread; a ring of 2 or more");
  constexpr int NT = kSub / 8;  // n8 tiles of a sub-step's S
  constexpr int DT = D / 8;   // n8 tiles of dQ
  constexpr int kRes = R * D * 2;     // bytes of a resident [64, D] tile
  constexpr int kKTile = BK * D * 2;  // bytes of a step's K or V tile
  uint8_t* qs = smem;                  // [64, D]
  uint8_t* dos = qs + kRes;            // [64, D]
  uint8_t* os = dos + kRes;            // [64, D], ble only
  uint8_t* ks = os + (kBle ? kRes : 0);  // [NS][BK, D]
  uint8_t* vs = ks + NS * kKTile;      // [NS][BK, D]
  uint8_t* valid = vs + NS * kKTile;   // [NS][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const int64_t stride = flash_bwd_tc::row_stride<D, kBle>(a.heads);
  const int64_t q_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lq);
  const int64_t k_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lk);
  const int q0 = tile * R;
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};  // this thread's rows
  const bf16* kb = a.k + k_base;
  const bf16* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;

  const int n_steps = (a.lk + BK - 1) / BK;
  // this thread's key's valid flag in step s (0 past Lk and past the steps)
  auto flag = [&](int s) -> uint8_t {
    const int k = s * BK + tid;
    return tid < BK && s < n_steps && k < a.lk ? mb[k] : 0;
  };
  auto stage_step = [&](int s, int buf) {
    stage<D, BK>(ks + buf * kKTile, kb, s * BK, a.lk, stride);
    stage<D, BK>(vs + buf * kKTile, vb, s * BK, a.lk, stride);
  };
  stage<D, R>(qs, a.q + q_base, q0, a.lq, stride);
  stage<D, R>(dos, a.dout + q_base, q0, a.lq, stride);
  if constexpr (kBle) stage<D, R>(os, a.o + q_base, q0, a.lq, stride);
  // steps 0 .. NS - 2 in flight (Q, dO and step 0 in the first group), their flags stored
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_steps) stage_step(s, s);
    tf32x3::cp_async_commit();
    if (tid < BK) valid[s * BK + tid] = flag(s);
  }
  uint8_t next = flag(NS - 1);  // the flag of the step staged next, stored one step later

  // rows past Lq: 0, so that p (dp - delta) stays finite; in ble, delta
  // comes from the staged tiles once they have landed (the first step)
  float lse[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = rows[i] < a.lq;
    lse[i] = live ? a.lse[bh * a.lq + rows[i]] : 0.f;
    if constexpr (!kBle) delta[i] = live ? a.delta[bh * a.lq + rows[i]] : 0.f;
  }

  float dq[DT][4];
  tf32x3::zero(dq);
  for (int it = 0; it < n_steps; ++it) {
    const int buf = it % NS;
    // step it + NS - 1 into the buffer of step it - 1, which every warp is done with
    const int nbuf = (it + NS - 1) % NS;
    if (it + NS - 1 < n_steps) stage_step(it + NS - 1, nbuf);
    tf32x3::cp_async_commit();
    if (tid < BK) valid[nbuf * BK + tid] = next;
    next = flag(it + NS);
    const uint8_t mine = tid < BK ? valid[buf * BK + tid] : 0;
    tf32x3::cp_async_wait<NS - 1>();  // Q, dO and step it have landed (this thread's copies)
    wgmma::fence_proxy_async();
    const bool step_live = __syncthreads_or(mine);  // ... and everyone's
    if (kBle && it == 0) {  // the rows' delta, summed over the quad that shares each row
#pragma unroll
      for (int i = 0; i < 2; ++i) delta[i] = tile_row_delta<D, 4>(os, dos, 16 * warp + g + 8 * i, t);
    }
    if (!step_live) continue;  // every key of the step is masked

    const uint8_t* kt = ks + buf * kKTile;
    const uint8_t* vt = vs + buf * kKTile;
    const uint8_t* ok = valid + buf * BK;

    // The step's products in sub-steps of kSub keys, each done before the
    // next is issued (as in dkv_tile); a sub-step past Lk (the tail of
    // L 257) is skipped.
#pragma unroll
    for (int sub = 0; sub < BK / kSub; ++sub) {
      const int ks0 = sub * kSub;
      if (it * BK + ks0 >= a.lk) break;
      const uint32_t at = ks0 * 2 * D;  // bytes to the sub-step's first key
      // S = Q.K^T and dP = dO.V^T; element e of n-tile nt holds key
      // ks0 + 8 nt + 2t + (e & 1)
      float s[NT][4], dp[NT][4];
      wgmma::fence();
      issue_ss<D, kSub>(s, qs, kt + at);
      wgmma::commit();
      issue_ss<D, kSub>(dp, dos, vt + at);
      wgmma::commit();
      wgmma::wait<1>();  // S done
      wgmma::fence_operand(s);
      // P = exp(S - lse) on valid keys, else exp(-inf) = 0 (as in dkv_tile)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(ok[ks0 + 8 * nt + 2 * t + (e & 1)] ? s[nt][e] - lse[e >> 1] : kMinusInf);
        }
      }
      wgmma::wait<0>();
      wgmma::fence_operand(dp);
      // dS = P (dP - delta), then dQ += dS.K with A from registers
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - delta[e >> 1];
      }
      uint32_t da[NT / 2][kTerms][4];
      a_terms<kTerms>(da, s);
      wgmma::fence();
      issue_rs<D, kTerms>(dq, da, kt + at);
      wgmma::commit();
      wgmma::wait<0>();
    }
    wgmma::fence_operand(dq);
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.lq) continue;
    bf16* row = a.dq + q_base + rows[i] * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n) bf16mma::store_pair(row + 8 * n, dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

}  // namespace flash_bwd_wg
