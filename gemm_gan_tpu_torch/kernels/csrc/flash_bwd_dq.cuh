// Masked flash-attention backward, dq, classic layout, on Hopper's tensor
// cores (sm_90a): one kernel template for every product mode of
// flash_ops.cuh. flash_bwd_dq.cu instantiates the f32 mode (3xTF32,
// f32-grade), flash_bwd_dq_bf16.cu the bf16 modes.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel`
// (gemm_gan_tpu/kernels/flash_attention.py:142): q, dO [B*H, Lq, D], k, v
// [B*H, Lk, D], q already scaled, mask [B, Lk] (nonzero = valid), the
// forward's lse and delta = rowsum(dO * O), both [B, H, Lq] f32. Per
// (batch, head), with p_ij = exp(q_i . k_j - lse_i) for valid keys j (0 for
// masked keys), dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i):
//   dq_i = sum_j ds_ij k_j.
// A sample with no valid key gets dq = 0. dk and dv are flash_bwd_dkv's job
// (flash_bwd_dkv.cuh).
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) it is 206 GFLOP (s, dp, dq: 6 per query, key and head-dim element)
// over ~170 MB, so operations bound it: 3.1 ms on the CUDA cores
// (67 TFLOP/s f32), 1.25 ms in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product). The bf16 mode takes 5 bf16
// passes of the 3 products' 68.8 GFLOP each (S, dP once, dQ with dS in
// three terms: 0.348 ms at 989 TFLOP/s dense bf16), mxu_bf16 3 (0.209 ms).
//
// Design: the dq tile of flash_bwd_tc.cuh (which the fused single-block
// backward, flash_bwd_fused.cuh, shares; here in its classic-layout
// instantiation, delta given): a block of 4 warps owns 64 query rows of one
// (batch, head), grid (ceil(Lq / 64), H, B); Q and dO are staged once into
// shared memory, K and V stream in 64-key tiles through a double-buffered
// cp.async ring (96 KB per block at D = 64 in f32, half in bf16), dQ stays
// in registers; no atomics. Unlike inside the fused kernel, the tile is not
// held to the dk/dv tile's registers, so in 3xTF32 at D <= 64 Q's rows are
// split once into hi/lo A fragments kept in registers (kHeld 1) instead of
// at each of the 65 key tiles of L 4,097: 252 registers, no spill, two
// blocks per SM. At D = 128 the fragments would take 128 registers, and
// 32-key tiles keep the shared memory at 128 KB. At the whole-slide shape
// this ran 3% faster than 32-key tiles or than Q split at each use (4.41
// against 4.55 and 4.56 ms device, means of three, on an NVIDIA H100 80GB
// HBM3 at a 700 W limit; variants dq, dq_bk32, dq_held0_bk32 of
// scripts/torch_kernel_variants.py, PERF.md). The bf16 modes hold nothing
// split (kHeld 0: a bf16 A fragment is read from the staged tile with no
// split to save).
//
// The bf16-ref modes (flash_bwd_dq_bf16, and flash_bwd_dq_mxu on bf16 refs)
// at D 16, 32 and 64 run the warpgroup-MMA dq tile of flash_bwd_wg.cuh
// instead (kernel flash_bwd_dq_wg_kernel, same grid and contract: kWg
// below), the one Q2's and Q6's fused grids run: wgmma products with no
// fragment loads by the threads (the mma.sync tile issued about one
// shared-memory load per tensor-core instruction), a branch-free exp, Q and
// dO resident, 65 key steps at the whole-slide shape. Here the tile holds
// only dQ, so a step of 64 keys takes its products in one sub-step and K,
// V stream through a ring of 3 buffers (66.8 KB, 144 registers, 3 blocks
// per SM at D 64): 5% (bf16) and 7% (mxu_bf16) faster at the whole-slide
// shape than 32-key sub-steps and a ring of 2 (112 registers, 4 blocks per
// SM); 128-key steps (83 KB, 2 blocks per SM) ran no faster (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "flash_bwd_wg.cuh"

namespace {

using flash_bwd_tc::Args;
using flash_ops::Elem;

constexpr int kWarps = 4;  // 64 query rows per block
constexpr int kThreads = 32 * kWarps;
template <int D>
constexpr int kKeys = D <= 64 ? 64 : 32;  // keys per streamed tile
// Q's rows (1), or Q's and dO's (2), held in registers as split fragments
// (3xTF32 only)
template <int D>
constexpr int kHeld = D <= 64 ? 1 : 0;

template <int D, int kMode>
using Cfg = flash_bwd_tc::DqCfg<D, kWarps, kKeys<D>, Elem<kMode>>;

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int held = kMode == flash_ops::kF32 ? kHeld<D> : 0;
  flash_bwd_tc::dq_tile<D, kWarps, kKeys<D>, false, held, kMode>(a, blockIdx.x, blockIdx.y,
                                                                  blockIdx.z, smem);
}

// whether an instantiation runs the wgmma dq tile of flash_bwd_wg.cuh: the
// bf16-ref modes (kBf16, kMxuBf16) at the head dims it takes
template <int D, int kMode>
constexpr bool kWg =
    (kMode == flash_ops::kBf16 || kMode == flash_ops::kMxuBf16) && flash_bwd_wg::kTakes<D>;
// the wgmma dq tile's buffers of its K, V ring and keys per product
// sub-step here (the fused grids keep flash_bwd_wg's 2 and 32)
constexpr int kWgStages = 3;
constexpr int kWgSubKeys = 64;

// the same grid on one warpgroup's wgmma dq tile (flash_bwd_wg.cuh)
template <int D, int kMode>
__global__ void __launch_bounds__(flash_bwd_wg::kThreads, flash_bwd_wg::kMinBlocks)
    flash_bwd_dq_wg_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  flash_bwd_wg::dq_tile<D, false, flash_ops::Ops<kMode, D>::kTerms, kWgStages, kWgSubKeys>(
      a, blockIdx.x, blockIdx.y, blockIdx.z, flash_bwd_wg::aligned(smem));
}

// the kernel an instantiation launches, its threads and its dynamic shared
// memory
template <int D, int kMode>
constexpr auto kernel() {
  if constexpr (kWg<D, kMode>) {
    return flash_bwd_dq_wg_kernel<D, kMode>;
  } else {
    return flash_bwd_dq_kernel<D, kMode>;
  }
}

template <int D, int kMode>
constexpr int threads() {
  return kWg<D, kMode> ? flash_bwd_wg::kThreads : kThreads;
}

template <int D, int kMode>
constexpr int smem_size() {
  if constexpr (kWg<D, kMode>) {  // the dq tile's own, from a 1,024-byte boundary
    return flash_bwd_wg::dq_bytes<D, false, kWgStages>() + 1024;
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
  static_assert(flash_bwd_wg::R == Cfg<D, kMode>::R, "both tiles take 64 query rows");
  const dim3 grid((a.lq + Cfg<D, kMode>::R - 1) / Cfg<D, kMode>::R, a.heads, batch);
  const auto fn = kernel<D, kMode>();
  fn<<<grid, threads<D, kMode>(), smem_size<D, kMode>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the entry points of one mode: [B*H, L, D]; reads q, k, v, mask, dout,
// lse, delta, writes dq
template <int kMode>
int dq_entry(FLASH_BWD_PARAMS(Elem<kMode>)) {
  const Args<Elem<kMode>> a{q, k, v, mask, nullptr, dout, lse, delta, dq, nullptr, nullptr,
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
