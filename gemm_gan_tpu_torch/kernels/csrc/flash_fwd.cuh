// Masked flash-attention forward on Hopper's tensor cores (sm_90a): one
// kernel template for both layouts and every product mode of flash_ops.cuh.
// flash_fwd.cu instantiates the f32 modes (3xTF32, f32-grade),
// flash_fwd_bf16.cu the bf16 modes of the ble layout, flash_fwd_bhld_bf16.cu
// those of the classic (bhld) layout.
//
// Replaces two Pallas TPU kernels of gemm_gan_tpu/kernels/flash_attention.py:
//   flash_fwd_bhld <- `_fwd_kernel` (:84), reached via flash_mha: q, k, v
//                     [B*H, L, D] (the classic layout);
//   flash_fwd_ble  <- `_fwd_kernel_ble` (:290), reached via flash_mha_ble:
//                     q, k, v [B, L, E = H*D], head h the column slice
//                     [h*D, (h+1)*D); o in the same layout.
// Both take q already scaled and mask [B, Lk] (nonzero = valid), and write
// lse as [B, H, Lq] f32 (the TPU's ble kernel broadcasts it across 128 lanes
// for its (8, 128) tiling, which nothing here needs). Per (batch, head,
// query row):
//   s_j = q . k_j for valid keys j (masked keys and keys >= Lk take no part);
//   m = max_j s_j, l = sum_j exp(s_j - m);
//   o = sum_j exp(s_j - m) v_j / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   a row with no valid key gets o = 0 and lse = -1e30.
//
// What bounds it on an H100: the whole-slide patch self-attention (B 8,
// H 4, L 4,097, D 64; bhld) is 137.5 GFLOP over ~34 MB, and the canonical
// one (B 8, H 4, L 257, D 64; ble) 0.54 GFLOP over ~8.4 MB: both far above
// the ridge point, so operations bound them. On the CUDA cores (67 TFLOP/s
// f32) that is 2.05 / 0.0081 ms; in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product) 0.83 / 0.0033 ms.
//
// Design (FlashAttention-2 on mma.sync m16n8k8 tf32, helpers in tf32x3.cuh):
//  * a block of 4 warps owns 64 query rows of one (batch, head), 16 rows
//    per warp; grid (ceil(Lq / 64), H, B). At the ble layout's L 257 that is
//    160 blocks on 132 SMs with one live row in the last tile of each
//    (batch, head); blocks of 16 to 80 rows were no faster on the card:
//    smaller blocks stage every K/V tile for fewer rows (PERF.md,
//    scripts/torch_kernel_variants.py, variants ble_*rows).
//  * the layouts differ only in where a head's rows start and how far apart
//    they are: (b*H + h) * Lq * D and D (bhld, both compile-time multiples of
//    D), or (b * Lq * H + h) * D and H * D (ble; a head's D floats stay
//    contiguous and 16-byte aligned, so the cp.async copies are the same).
//  * Each warp holds its Q rows in registers as A fragments
//    (flash_ops::Ops::Held: in 3xTF32 split into hi/lo once, raw f32 at
//    D = 128, split per use, to stay clear of spills; in the bf16 modes one
//    bf16 fragment).
//  * K and V tiles of 32 keys (8 KB each at D = 64) are staged with
//    cp.async into a double-buffered ring in dynamic shared memory (32 KB
//    per block at D = 64), XOR-swizzled so that fragment reads have no bank
//    conflict. The next tile's copy and mask bytes are in flight while the
//    current tile is computed. 32-key tiles ran 4% faster than 64-key ones
//    on the card (fewer registers for S; registers, not shared memory, hold
//    it at 2 blocks per SM either way).
//  * K and V are split into hi/lo at each fragment load, not at staging:
//    pre-split tiles would double the ring and cost a pass over shared
//    memory and a barrier per tile; the split is 3 ALU operations per
//    element beside 3 mma per fragment, computed by each warp.
//  * S = Q.K^T by 3xTF32 mma; masked keys and keys >= Lk set to -1e30 by
//    select; online softmax (m, l) in f32 registers, row max over a quad by
//    __shfl_xor_sync, l kept per thread and summed over the quad at the end.
//  * K's columns are read in tf32x3::perm order, so S's C fragments are
//    P's A fragments for O = alpha O + P.V (3xTF32, P split hi/lo): no
//    shuffles. Each tile's P.V is summed in fresh accumulators and added to
//    O once (tf32x3::weight_rows).
//  * a tile whose keys are all masked is skipped (the mask is per batch, so
//    the branch is uniform in the block).
//
// The bf16 modes (flash_ops.cuh, bf16mma.cuh; the JAX package's
// compute_dtype="bfloat16" and mxu_bf16) keep this design on m16n8k16 bf16
// products: K and V tiles staged as they are stored (bf16, half the shared
// memory; or f32 under mxu_bf16 with f32 refs, rounded at each fragment
// load), S = Q.K^T in one bf16 product per k-step, P.V with P in three bf16
// terms (kBf16: f32-exact) or rounded once (mxu_bf16), o rounded once at
// the store. Under mxu_bf16 the rounded P depends on the key blocks, and
// follows the JAX kernels': the ble kernel and a classic shape whose
// 128-padded Lk fits 512 take all keys in one block; a longer classic one
// takes blocks of kBlockK = 256 keys (8 tiles) from key 0. For each block a
// first pass over its key tiles takes each row's max over the block (S
// only), o and l are rescaled by exp(m_prev - m) to the new running max m,
// and the second pass rounds P = exp(s - m), the value the reference's
// block rounds (rounding exp(s - a per-tile running max) and rescaling
// later gives other bf16 values), and never rescales within the block
// (alpha = exp(0) = 1). At the canonical shape (B 8, H 4,
// L 257, D 64) a product (S or P.V) is 0.27 GFLOP: the bf16 mode takes 4
// bf16 passes (S once, P.V three times; 1.08 GFLOP, 0.0011 ms at 989
// TFLOP/s dense bf16), mxu_bf16 3 (S twice, P.V once; 0.0008 ms), and q, k,
// v, o in bf16 are 4.2 MB (0.0013 ms at 3.35 TB/s): bytes bound both.
//
// The bf16-ref modes (flash_fwd_bhld_bf16, flash_fwd_bhld_mxu and
// flash_fwd_ble_mxu on bf16 refs) at D 16, 32 and 64 run the warpgroup-MMA
// tile of flash_fwd_wg.cuh instead (kernel flash_fwd_wg_kernel, same grid
// and contract: kWg below), in the layout's strides: wgmma products with no
// fragment loads by the threads, 128-key steps (256 keys per first-pass
// step under mxu_bf16), a branch-free softmax; the ring's depth per layout
// is kWgStages below.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_wg.cuh"
#include "flash_ops.cuh"

namespace {

using namespace tf32x3;  // kNegInf, cp.async, quad reductions
using flash_ops::Elem;
using flash_ops::Ops;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 256;         // keys per block of JAX's classic forward (long Lk)

template <class T>
struct Args {
  const T* q;           // [B*H, Lq, D] or [B, Lq, H*D]
  const T* k;           // [B*H, Lk, D] or [B, Lk, H*D]
  const T* v;
  const uint8_t* mask;  // [B, Lk]
  T* o;                 // like q
  float* lse;           // [B, H, Lq]
  int lq, lk, heads;
};

template <int D, int kMode>
struct Cfg {
  static constexpr int BK = 32;                 // keys per tile
  static constexpr int NT = BK / 8;             // n8 tiles of S (per warp)
  static constexpr int OT = D / 8;              // n8 tiles of O
  static constexpr int TILE = BK * D;           // elements per K or V tile
  // K, V x 2 stages + valid flags
  static constexpr int SMEM = 4 * TILE * static_cast<int>(sizeof(Elem<kMode>)) + 2 * BK;
};

template <int D, bool kBle, int kMode>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args<Elem<kMode>> a) {
  using C = Cfg<D, kMode>;
  using O = Ops<kMode, D>;
  using T = Elem<kMode>;
  extern __shared__ __align__(16) float smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][BK, D]
  T* vs = ks + 2 * C::TILE;            // [2][BK, D]
  uint8_t* valid = reinterpret_cast<uint8_t*>(vs + 2 * C::TILE);  // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  // where (b, h)'s rows start, and the distance between rows, in elements
  const int64_t stride = kBle ? static_cast<int64_t>(a.heads) * D : D;
  const int64_t q_base = kBle ? (static_cast<int64_t>(b) * a.lq * a.heads + h) * D
                              : bh * a.lq * D;
  const int64_t k_base = kBle ? (static_cast<int64_t>(b) * a.lk * a.heads + h) * D
                              : bh * a.lk * D;
  const T* qb = a.q + q_base;
  const T* kb = a.k + k_base;
  const T* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const int row0 = blockIdx.x * kRowsQ + warp * 16;  // this warp's rows
  const int rows[2] = {row0 + g, row0 + g + 8};      // this thread's rows

  typename O::Held qf;  // the warp's Q rows as A fragments
  O::hold(qf, qb, rows, a.lq, stride, t);

  float o[C::OT][4];
#pragma unroll
  for (int n = 0; n < C::OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  // S = Q.K^T of the tile at kt, masked keys and keys >= Lk set to -1e30 by
  // select; element e of n-tile nt holds key O::col(nt, e, t)
  auto scores = [&](float (&s)[C::NT][4], const T* kt, const uint8_t* ok) {
    O::template held_dot<C::NT>(s, qf, kt, g, t);
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const bool ok0 = ok[O::col(nt, 0, t)], ok1 = ok[O::col(nt, 1, t)];
      s[nt][0] = ok0 ? s[nt][0] : kNegInf;
      s[nt][1] = ok1 ? s[nt][1] : kNegInf;
      s[nt][2] = ok0 ? s[nt][2] : kNegInf;
      s[nt][3] = ok1 ? s[nt][3] : kNegInf;
    }
  };

  const int n_tiles = (a.lk + C::BK - 1) / C::BK;
  // the key blocks that P is rounded in (kRoundsP): JAX's classic forward
  // takes blocks of kBlockK keys from key 0 once its 128-padded Lk exceeds
  // 512, else (and in the ble kernel) one block of all the keys
  const int block_tiles = !kBle && flash_ops::kRoundsP<kMode> && (a.lk + 127) / 128 * 128 > 512
                              ? kBlockK / C::BK
                              : n_tiles;
  for (int t0 = 0; t0 < n_tiles; t0 += block_tiles) {
    const int t1 = min(t0 + block_tiles, n_tiles);
    if constexpr (flash_ops::kRoundsP<kMode>) {
      // first pass over the block, K only: each row's max over the block's
      // valid keys, then o and l rescaled to the new running max
      O::template stage<C::BK, kThreads>(ks, kb, t0 * C::BK, a.lk, stride);
      cp_async_commit();
      uint8_t mv = tid < C::BK && t0 * C::BK + tid < a.lk ? mb[t0 * C::BK + tid] : 0;
      float bm[2] = {kNegInf, kNegInf};
      for (int it = t0; it < t1; ++it) {
        const int buf = (it - t0) & 1;
        const uint8_t mine = mv;
        if (tid < C::BK) valid[buf * C::BK + tid] = mine;
        if (it + 1 < t1) {
          const int k1 = (it + 1) * C::BK;
          O::template stage<C::BK, kThreads>(ks + (buf ^ 1) * C::TILE, kb, k1, a.lk, stride);
          mv = tid < C::BK && k1 + tid < a.lk ? mb[k1 + tid] : 0;
        }
        cp_async_commit();
        cp_async_wait<1>();
        if (!__syncthreads_or(mine)) continue;
        float s[C::NT][4];
        scores(s, ks + buf * C::TILE, valid + buf * C::BK);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          bm[0] = fmaxf(bm[0], fmaxf(s[nt][0], s[nt][1]));
          bm[1] = fmaxf(bm[1], fmaxf(s[nt][2], s[nt][3]));
        }
        __syncthreads();
      }
      cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mx = fmaxf(m[i], quad_max(bm[i]));
        const float alpha = expf(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < C::OT; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }
      __syncthreads();  // the ring is refilled below
    }

    O::template stage<C::BK, kThreads>(ks, kb, t0 * C::BK, a.lk, stride);
    O::template stage<C::BK, kThreads>(vs, vb, t0 * C::BK, a.lk, stride);
    cp_async_commit();
    uint8_t mv = tid < C::BK && t0 * C::BK + tid < a.lk ? mb[t0 * C::BK + tid] : 0;

    for (int it = t0; it < t1; ++it) {
      const int buf = (it - t0) & 1;
      const uint8_t mine = mv;
      if (tid < C::BK) valid[buf * C::BK + tid] = mine;
      if (it + 1 < t1) {  // prefetch tile it + 1 into the other buffer
        const int k1 = (it + 1) * C::BK;
        O::template stage<C::BK, kThreads>(ks + (buf ^ 1) * C::TILE, kb, k1, a.lk, stride);
        O::template stage<C::BK, kThreads>(vs + (buf ^ 1) * C::TILE, vb, k1, a.lk, stride);
        mv = tid < C::BK && k1 + tid < a.lk ? mb[k1 + tid] : 0;
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile it has landed (for this thread's copies)
      if (!__syncthreads_or(mine)) continue;  // every key of the tile is masked

      const T* vt = vs + buf * C::TILE;
      float s[C::NT][4];
      scores(s, ks + buf * C::TILE, valid + buf * C::BK);

      // the online softmax (after a first pass m holds the block's max:
      // alpha is 1)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // masked: exp(-1e30 - m) == 0
          l[e >> 1] += s[nt][e];
        }
      }
      // O = alpha O + P.V: S's C fragments are P's A fragments
      O::template weight_rows<C::NT>(o, s, vt, alpha[0], alpha[1], g, t);
      __syncthreads();  // every warp is done with buf before it is refilled
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    const bool empty = m[i] <= 0.5f * kNegInf;  // no valid key in this row
    const int r = rows[i];
    if (r >= a.lq) continue;
    T* orow = a.o + q_base + r * stride;
#pragma unroll
    for (int n = 0; n < C::OT; ++n) {
      bf16mma::store_pair(orow + 8 * n + 2 * t, empty ? 0.f : o[n][2 * i] / lc,
                    empty ? 0.f : o[n][2 * i + 1] / lc);
    }
    if (t == 0) a.lse[bh * a.lq + r] = m[i] + logf(lc);
  }
}

// whether an instantiation runs the wgmma tile of flash_fwd_wg.cuh: the
// bf16-ref modes (kBf16, kMxuBf16) of either layout at the head dims it
// takes
template <int D, bool kBle, int kMode>
constexpr bool kWg = (kMode == flash_ops::kBf16 || kMode == flash_ops::kMxuBf16) &&
                     flash_fwd_wg::kTakes<D>;

// the wgmma tile's buffers: the classic layout's (whole-slide) 2, the ble
// layout's (L 257, mxu_bf16) 3, as measured (PERF.md)
template <bool kBle>
constexpr int kWgStages = kBle ? 3 : flash_fwd_wg::kStages;

// the same grid on one warpgroup's wgmma tile (flash_fwd_wg.cuh)
template <int D, bool kBle, int kMode>
__global__ void __launch_bounds__(flash_fwd_wg::kThreads, flash_fwd_wg::kMinBlocks)
    flash_fwd_wg_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  flash_fwd_wg::tile<D, Ops<kMode, D>::kTerms, flash_ops::kRoundsP<kMode>, kBle,
                     kWgStages<kBle>>(
      a, blockIdx.x, blockIdx.y, blockIdx.z, wg_tile::aligned(smem));
}

// the kernel an instantiation launches, its threads and its dynamic shared memory
template <int D, bool kBle, int kMode>
constexpr auto kernel() {
  if constexpr (kWg<D, kBle, kMode>) {
    return flash_fwd_wg_kernel<D, kBle, kMode>;
  } else {
    return flash_fwd_kernel<D, kBle, kMode>;
  }
}

template <int D, bool kBle, int kMode>
constexpr int threads() {
  return kWg<D, kBle, kMode> ? flash_fwd_wg::kThreads : kThreads;
}

template <int D, bool kBle, int kMode>
constexpr int smem_size() {
  if constexpr (kWg<D, kBle, kMode>) {
    return flash_fwd_wg::Cfg<D, kWgStages<kBle>>::SMEM;
  } else {
    return Cfg<D, kMode>::SMEM;
  }
}

template <int D, bool kBle, int kMode>
cudaError_t prepare() {
  return cudaFuncSetAttribute(kernel<D, kBle, kMode>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_size<D, kBle, kMode>());
}

// the entry points' arguments: q, k, v [B*H, L, D] or [B, L, H*D] of the
// mode's element type; mask [B, Lk]; o like q; lse [B, H, Lq]
template <bool kBle, int kMode>
int dispatch(const void* q, const void* k, const void* v, const uint8_t* mask, void* o,
             float* lse, int batch, int lq, int lk, int heads, int head_dim, void* stream) {
  using T = Elem<kMode>;
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), mask, static_cast<T*>(o), lse, lq, lk, heads};
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const cudaError_t err = prepare<D, kBle, kMode>();
    if (err != cudaSuccess) return static_cast<int>(err);
    static_assert(flash_fwd_wg::R == kRowsQ, "both tiles take 64 query rows");
    const dim3 grid((a.lq + kRowsQ - 1) / kRowsQ, a.heads, batch);
    const auto fn = kernel<D, kBle, kMode>();
    fn<<<grid, threads<D, kBle, kMode>(), smem_size<D, kBle, kMode>(),
         static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// dynamic shared memory per block and resident blocks per SM at head_dim
template <bool kBle, int kMode>
int occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const cudaError_t err = prepare<D, kBle, kMode>();
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_bytes = smem_size<D, kBle, kMode>();
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel<D, kBle, kMode>(), threads<D, kBle, kMode>(), *smem_bytes));
  });
}

}  // namespace
