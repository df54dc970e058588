// Masked flash-attention backward, dq, dk and dv in one launch, on Hopper's
// tensor cores (sm_90a): one grid for both layouts and every product mode
// of flash_ops.cuh (the bf16-ref modes on the warpgroup-MMA tiles of
// flash_bwd_wg.cuh, the others on flash_bwd_tc.cuh's mma.sync tiles: see
// below). flash_bwd_fused.cu instantiates the f32
// modes (3xTF32, f32-grade), flash_bwd_bf16.cu and flash_bwd_mxu.cu the
// bf16 modes of the ble layout, flash_bwd_bhld_bf16.cu and
// flash_bwd_bhld_mxu.cu those of the classic layout.
//
// Replaces two Pallas TPU kernels of gemm_gan_tpu/kernels/flash_attention.py:
//   flash_bwd_ble        <- `_bwd_kernel_ble` (:317), reached via
//                           flash_mha_ble's backward: q, k, v, o, dO, dq, dk,
//                           dv [B, L, E = H*D], head h the columns
//                           [h*D, (h+1)*D); delta = rowsum(dO * O) is
//                           computed in the kernel, as the TPU kernel does.
//   flash_bwd_bhld_fused <- `_bwd_fused_kernel` (:179), which the JAX package
//                           takes for single-block shapes (`_flash_core_bwd`,
//                           n_q == n_k == 1; in practice the canonical L 257
//                           with flash_layout="bhld"): q, dO [B*H, Lq, D], k, v
//                           [B*H, Lk, D], delta given as [B, H, Lq].
// Both take q already scaled, mask [B, Lk] and lse [B, H, Lq] (the
// arithmetic is in flash_bwd_tc.cuh). Masked keys, and a sample with no
// valid key, get exactly 0.
//
// What bounds them on an H100: at the canonical shape (B 8, H 4, L 257,
// D 64) each is 1.35 GFLOP (s, dp, dv, dq, dk: 10 per query, key and
// head-dim element) over ~15 MB (17 MB with o in ble), so operations bound
// them: 0.020 ms on the CUDA cores (67 TFLOP/s f32), 0.0082 ms in 3xTF32 on
// the tensor cores.
//
// Design: one grid holds both kinds of tile of flash_bwd_tc.cuh, so that
// nothing passes between blocks and no atomics are needed: blockIdx.y <
// n_dkv runs a dk/dv tile (4 warps x 16 key rows, Q and dO streamed in
// tiles of kQueries queries), the rest dq tiles (4 warps x 16 query rows,
// K and V streamed in 32-key tiles, Q and dO split at each use: kHeld 0).
// blockIdx.x is the (batch, head), so the blocks start in order of y: the
// longer dk/dv tiles (4 products per query-key pair against the dq tile's
// 3) first, and the dq tiles fill the SMs as they drain. Registers and
// shared memory are those of the larger body, the dk/dv tile's (≈255
// registers at D = 64: two blocks per SM). The layouts differ only in where
// a head's rows start and their stride (kBle); in ble each tile also
// computes the delta of its query rows from O and dO.
//  * bhld streams 64 queries per dk/dv tile at D <= 64 (Q5's
//    configuration, 97 KB of shared memory). 32-row tiles (2 warps, 32-query
//    dk/dv tiles, 4 blocks per SM), which pad L 257 less, ran 1% faster to
//    7% slower from one card to the next (PERF.md; variants fused and
//    fused_32rows of scripts/torch_kernel_variants.py).
//  * ble streams 32: with 64 its runtime stride and o pointer pushed the
//    dk/dv body into an 8-byte spill, and it ran 7% slower (0.0964 against
//    0.0894 ms device at the canonical shape on an NVIDIA H100 80GB HBM3
//    at a 700 W limit; variants ble_bwd_bq64 and ble_bwd).
//
// The bf16 modes of flash_bwd_ble and flash_bwd_bhld_fused (Q2 and Q6 with
// bf16 refs, or mxu_bf16 on bf16 or f32 refs): P^T.dO, dS^T.Q and dS.K take
// P or dS in three bf16 terms (kBf16, f32-exact) or rounded once
// (mxu_bf16); delta from the stored o and dO in f32; dq, dk, dv rounded
// once at the store. At the canonical shape the bf16 mode takes 11 bf16
// passes of the 5 products' 0.27 GFLOP each (S, dP once; dV, dK, dQ three
// times: 0.0030 ms at 989 TFLOP/s, against 0.0025 ms for 8.4 MB of q, k,
// v, o, dO, dq, dk, dv at 3.35 TB/s: operations bound it), mxu_bf16 5
// (0.0014 ms: bytes bound it).
//  * On bf16 refs at D 16, 32 and 64 (the bf16 mode, and mxu_bf16 as the
//    bench configuration runs it) the grid runs the warpgroup-MMA tiles of
//    flash_bwd_wg.cuh instead (kernel flash_bwd_wg_kernel, same grid and
//    contract): wgmma products with no fragment loads by the threads, 64-
//    query and 64-key steps, a branch-free softmax, 3 blocks per SM so the
//    canonical grid is one wave. That answers what held the mma.sync tiles
//    back: a shared-memory load per tensor-core instruction (col_pair's
//    16-bit loads), 245-247 registers (2 blocks per SM, 1.21 waves),
//    mma.sync instead of wgmma, and in ble a round trip to global memory for
//    delta at every 32-query step. Q6 bf16 went from 0.0469 to 0.0213 ms,
//    Q2 bf16 from 0.0473 to 0.0244 (device time at the canonical shape on
//    an NVIDIA H100 80GB HBM3 at a 700 W limit; PERF.md). The 11 passes stay: they are the JAX
//    kernel's f32 products, and at 12-14% of the bound they do not set the
//    pace.
//  * mxu_bf16 on f32 refs (whose tiles would have to be rounded while they
//    are staged, which cp.async cannot do) and D 8 and 128 keep the two
//    mma.sync tiles of flash_bwd_tc.cuh on m16n8k16 bf16 products
//    (flash_ops.cuh), tiles staged in the element type.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "flash_bwd_wg.cuh"

namespace {

using flash_bwd_tc::Args;
using flash_ops::Elem;

constexpr int kWarps = 4;  // 64 rows per tile of either kind
constexpr int kKeys = 32;  // keys per streamed dq tile
template <int D, bool kBle>
constexpr int kQueries = !kBle && D <= 64 ? 64 : 32;  // queries per streamed dk/dv tile

// whether an instantiation runs the wgmma tiles of flash_bwd_wg.cuh: the
// bf16-ref modes (kBf16, kMxuBf16) at the head dims they take
template <int D, int kMode>
constexpr bool kWg =
    (kMode == flash_ops::kBf16 || kMode == flash_ops::kMxuBf16) && flash_bwd_wg::kTakes<D>;

template <int D, bool kBle, int kMode, bool = kWg<D, kMode>>
struct Cfg {
  using T = Elem<kMode>;
  using Dkv = flash_bwd_tc::DkvCfg<D, kWarps, kQueries<D, kBle>, T>;
  using Dq = flash_bwd_tc::DqCfg<D, kWarps, kKeys, T>;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;
  static constexpr int SMEM = Dkv::SMEM > Dq::SMEM ? Dkv::SMEM : Dq::SMEM;
};

template <int D, bool kBle, int kMode>
__global__ void __launch_bounds__(Cfg<D, kBle, kMode>::kThreads)
    flash_bwd_fused_kernel(const Args<Elem<kMode>> a, int n_dkv) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x % a.heads, b = blockIdx.x / a.heads;
  if (static_cast<int>(blockIdx.y) < n_dkv) {
    flash_bwd_tc::dkv_tile<D, kWarps, kQueries<D, kBle>, kBle, kMode>(a, blockIdx.y, h, b, smem);
  } else {
    flash_bwd_tc::dq_tile<D, kWarps, kKeys, kBle, 0, kMode>(a, blockIdx.y - n_dkv, h, b, smem);
  }
}

template <int D, bool kBle, int kMode>
struct Cfg<D, kBle, kMode, true> {
  static constexpr int kThreads = flash_bwd_wg::kThreads;
  static constexpr int R = flash_bwd_wg::R;
  static constexpr int SMEM = flash_bwd_wg::Cfg<D, kBle>::SMEM;
};

// the same grid on one warpgroup's wgmma tiles (flash_bwd_wg.cuh)
template <int D, bool kBle, int kMode>
__global__ void __launch_bounds__(flash_bwd_wg::kThreads, flash_bwd_wg::kMinBlocks)
    flash_bwd_wg_kernel(const Args<Elem<kMode>> a, int n_dkv) {
  extern __shared__ __align__(16) float smem[];
  uint8_t* tiles = flash_bwd_wg::aligned(smem);
  constexpr int kTerms = flash_ops::Ops<kMode, D>::kTerms;
  const int h = blockIdx.x % a.heads, b = blockIdx.x / a.heads;
  if (static_cast<int>(blockIdx.y) < n_dkv) {
    flash_bwd_wg::dkv_tile<D, kBle, kTerms>(a, blockIdx.y, h, b, tiles);
  } else {
    flash_bwd_wg::dq_tile<D, kBle, kTerms>(a, blockIdx.y - n_dkv, h, b, tiles);
  }
}

// the kernel an instantiation launches
template <int D, bool kBle, int kMode>
constexpr auto kernel() {
  if constexpr (kWg<D, kMode>) {
    return flash_bwd_wg_kernel<D, kBle, kMode>;
  } else {
    return flash_bwd_fused_kernel<D, kBle, kMode>;
  }
}

template <int D, bool kBle, int kMode>
cudaError_t prepare() {
  return cudaFuncSetAttribute(kernel<D, kBle, kMode>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<D, kBle, kMode>::SMEM);
}

template <int D, bool kBle, int kMode>
int launch(const Args<Elem<kMode>>& a, int batch, cudaStream_t stream) {
  using C = Cfg<D, kBle, kMode>;
  const cudaError_t err = prepare<D, kBle, kMode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_dkv = (a.lk + C::R - 1) / C::R;
  const int n_dq = (a.lq + C::R - 1) / C::R;
  const dim3 grid(batch * a.heads, n_dkv + n_dq);
  const auto fn = kernel<D, kBle, kMode>();
  fn<<<grid, C::kThreads, C::SMEM, stream>>>(a, n_dkv);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBle, int kMode>
int dispatch(const Args<Elem<kMode>>& a, int head_dim, int batch, void* stream) {
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    return launch<decltype(d)::value, kBle, kMode>(a, batch, static_cast<cudaStream_t>(stream));
  });
}

template <bool kBle, int kMode>
int occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    using C = Cfg<D, kBle, kMode>;
    const cudaError_t err = prepare<D, kBle, kMode>();
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_bytes = C::SMEM;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel<D, kBle, kMode>(), C::kThreads, C::SMEM));
  });
}

// the ble entry points of one mode: reads q, k, v, mask, o, dout, lse
// (delta computed in the kernel), writes dq, dk, dv
template <int kMode>
int ble(FLASH_BWD_PARAMS(Elem<kMode>)) {
  const Args<Elem<kMode>> a{q, k, v, mask, o, dout, lse, nullptr, dq, dk, dv, lq, lk, heads};
  return dispatch<true, kMode>(a, head_dim, batch, stream);
}

// the classic layout's entry points of one mode: reads q, k, v, mask, dout,
// lse, delta, writes dq, dk, dv
template <int kMode>
int bhld(FLASH_BWD_PARAMS(Elem<kMode>)) {
  const Args<Elem<kMode>> a{q, k, v, mask, nullptr, dout, lse, delta, dq, dk, dv, lq, lk, heads};
  return dispatch<false, kMode>(a, head_dim, batch, stream);
}

}  // namespace
