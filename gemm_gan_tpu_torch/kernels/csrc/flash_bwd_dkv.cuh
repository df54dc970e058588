// Masked flash-attention backward, dk and dv, classic layout, on Hopper's
// tensor cores (sm_90a): one kernel template for every product mode of
// flash_ops.cuh. flash_bwd_dkv.cu instantiates the f32 mode (3xTF32,
// f32-grade), flash_bwd_dkv_bf16.cu the bf16 modes.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel`
// (gemm_gan_tpu/kernels/flash_attention.py:220): q, dO [B*H, Lq, D], k, v
// [B*H, Lk, D], q already scaled, mask [B, Lk] (nonzero = valid), the
// forward's lse and delta = rowsum(dO * O), both [B, H, Lq] f32. Per
// (batch, head), with p_ij = exp(q_i . k_j - lse_i) for valid keys j (0 for
// masked keys), dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i):
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i.
// Masked keys, and every key of a sample with no valid key, get exactly 0.
// dq is flash_bwd_dq's job (flash_bwd_dq.cuh).
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) it is 275 GFLOP (s, dp, dv, dk: 8 per query, key and head-dim
// element) over ~200 MB, so operations bound it: 4.1 ms on the CUDA cores
// (67 TFLOP/s f32), 1.67 ms in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product). The bf16 mode takes 8 bf16
// passes of the 4 products' 68.8 GFLOP each (S, dP once; dV, dK with P and
// dS in three terms: 0.556 ms at 989 TFLOP/s dense bf16), mxu_bf16 4
// (0.278 ms).
//
// Design: tf32x3.cuh's 3xTF32 products on mma.sync m16n8k8 (bf16mma.cuh's
// m16n8k16 in the bf16 modes), in the dk/dv tile of flash_bwd_tc.cuh (which
// the fused single-block backward, flash_bwd_fused.cuh, shares; here in its
// classic-layout instantiation, delta given): a block of 4 warps owns 64
// key rows of one (batch, head), grid (ceil(Lk / 64), H, B); K and V stay
// resident in shared memory in the mode's element type (f32 under mxu_bf16
// with f32 refs, rounded at each fragment load), tiles of 64 queries (32 at
// D = 128) of Q, dO, lse and delta stream through a double-buffered
// cp.async ring (96 KB per block at D = 64 in f32, 49 KB in bf16), dK and
// dV stay in registers; no atomics.
//
// The bf16-ref modes (flash_bwd_dkv_bf16, and flash_bwd_dkv_mxu on bf16
// refs) at D 16, 32 and 64 run the warpgroup-MMA dk/dv tile of
// flash_bwd_wg.cuh instead (kernel flash_bwd_dkv_wg_kernel, same grid and
// contract: kWg below), the one Q2's and Q6's fused grids run with delta
// given: wgmma products with no fragment loads by the threads, 64-query
// steps in 32-query product sub-steps, a branch-free exp, 3 blocks per SM.
// Here it streams ceil(Lq / 64) steps, 65 at the whole-slide shape, where
// the fused grids stream five. A third ring buffer ran within 1% of two,
// and a persistent grid 6% slower: its 5.25 work items per resident slot
// end in the same quarter-full last wave (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "flash_bwd_wg.cuh"

namespace {

using flash_bwd_tc::Args;
using flash_ops::Elem;

constexpr int kWarps = 4;  // 64 key rows per block
constexpr int kThreads = 32 * kWarps;
template <int D>
constexpr int kQueries = D <= 64 ? 64 : 32;  // queries per streamed tile

template <int D, int kMode>
using Cfg = flash_bwd_tc::DkvCfg<D, kWarps, kQueries<D>, Elem<kMode>>;

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  flash_bwd_tc::dkv_tile<D, kWarps, kQueries<D>, false, kMode>(a, blockIdx.x, blockIdx.y,
                                                               blockIdx.z, smem);
}

// whether an instantiation runs the wgmma dk/dv tile of flash_bwd_wg.cuh:
// the bf16-ref modes (kBf16, kMxuBf16) at the head dims it takes
template <int D, int kMode>
constexpr bool kWg =
    (kMode == flash_ops::kBf16 || kMode == flash_ops::kMxuBf16) && flash_bwd_wg::kTakes<D>;

// the same grid on one warpgroup's wgmma dk/dv tile (flash_bwd_wg.cuh)
template <int D, int kMode>
__global__ void __launch_bounds__(flash_bwd_wg::kThreads, flash_bwd_wg::kMinBlocks)
    flash_bwd_dkv_wg_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  flash_bwd_wg::dkv_tile<D, false, flash_ops::Ops<kMode, D>::kTerms>(
      a, blockIdx.x, blockIdx.y, blockIdx.z, flash_bwd_wg::aligned(smem));
}

// the kernel an instantiation launches, its threads and its dynamic shared
// memory
template <int D, int kMode>
constexpr auto kernel() {
  if constexpr (kWg<D, kMode>) {
    return flash_bwd_dkv_wg_kernel<D, kMode>;
  } else {
    return flash_bwd_dkv_kernel<D, kMode>;
  }
}

template <int D, int kMode>
constexpr int threads() {
  return kWg<D, kMode> ? flash_bwd_wg::kThreads : kThreads;
}

template <int D, int kMode>
constexpr int smem_size() {
  if constexpr (kWg<D, kMode>) {
    return flash_bwd_wg::Cfg<D, false>::kDkv + 1024;  // the dk/dv tile's, from a 1,024-byte boundary
  } else {
    return Cfg<D, kMode>::SMEM;
  }
}

template <int D, int kMode>
cudaError_t prepare() {
  return cudaFuncSetAttribute(kernel<D, kMode>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_size<D, kMode>());
}

template <int D, int kMode>
int launch(const Args<Elem<kMode>>& a, int batch, cudaStream_t stream) {
  const cudaError_t err = prepare<D, kMode>();
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(flash_bwd_wg::R == Cfg<D, kMode>::R, "both tiles take 64 key rows");
  const dim3 grid((a.lk + Cfg<D, kMode>::R - 1) / Cfg<D, kMode>::R, a.heads, batch);
  const auto fn = kernel<D, kMode>();
  fn<<<grid, threads<D, kMode>(), smem_size<D, kMode>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the entry points of one mode: [B*H, L, D]; reads q, k, v, mask, dout,
// lse, delta, writes dk, dv
template <int kMode>
int dkv_entry(FLASH_BWD_PARAMS(Elem<kMode>)) {
  const Args<Elem<kMode>> a{q, k, v, mask, nullptr, dout, lse, delta, nullptr, dk, dv,
                            lq, lk, heads};
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    return launch<decltype(d)::value, kMode>(a, batch, static_cast<cudaStream_t>(stream));
  });
}

// dynamic shared memory per block and resident blocks per SM at head_dim
template <int kMode>
int occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return flash_ops::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const cudaError_t err = prepare<D, kMode>();
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_bytes = smem_size<D, kMode>();
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel<D, kMode>(), threads<D, kMode>(), *smem_bytes));
  });
}

}  // namespace
