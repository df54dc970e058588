// Masked flash-attention backward, dk and dv, classic layout, on Hopper's
// tensor cores (sm_90a), f32-grade through 3xTF32 products.
//
// flash_bwd_dkv replaces the Pallas TPU kernel `_bwd_dkv_kernel`
// (gemm_gan_tpu/kernels/flash_attention.py:220): q, dO [B*H, Lq, D], k, v
// [B*H, Lk, D], q already scaled, mask [B, Lk] (nonzero = valid), the
// forward's lse and delta = rowsum(dO * O), both [B, H, Lq]. Per (batch,
// head), with p_ij = exp(q_i . k_j - lse_i) for valid keys j (0 for masked
// keys), dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i):
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i.
// Masked keys, and every key of a sample with no valid key, get exactly 0.
// dq is flash_bwd_dq's job (flash_bwd_dq.cu).
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) it is 275 GFLOP (s, dp, dv, dk: 8 per query, key and head-dim
// element) over ~200 MB, so operations bound it: 4.1 ms on the CUDA cores
// (67 TFLOP/s f32), 1.67 ms in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product).
//
// Design: tf32x3.cuh's 3xTF32 products on mma.sync m16n8k8, in the dk/dv
// tile of flash_bwd_tc.cuh (which the fused single-block backward,
// flash_bwd_fused.cuh, shares; here in its classic-layout instantiation,
// delta given): a block of 4 warps owns 64 key rows of one (batch, head),
// grid (ceil(Lk / 64), H, B); K and V stay resident in shared memory, tiles
// of 64 queries (32 at D = 128) of Q, dO, lse and delta stream through a
// double-buffered cp.async ring (96 KB per block at D = 64: two blocks per
// SM), dK and dV stay in registers; no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"

namespace {

using Args = flash_bwd_tc::Args<float>;

constexpr int kWarps = 4;  // 64 key rows per block
template <int D>
constexpr int kQueries = D <= 64 ? 64 : 32;  // queries per streamed tile

template <int D>
using Cfg = flash_bwd_tc::DkvCfg<D, kWarps, kQueries<D>>;

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads) flash_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  flash_bwd_tc::dkv_tile<D, kWarps, kQueries<D>, false>(a, blockIdx.x, blockIdx.y, blockIdx.z,
                                                        smem);
}

template <int D>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lk + Cfg<D>::R - 1) / Cfg<D>::R, a.heads, batch);
  flash_bwd_dkv_kernel<D><<<grid, Cfg<D>::kThreads, Cfg<D>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// [B*H, L, D]; reads q, k, v, mask, dout, lse, delta, writes dk, dv.
extern "C" int flash_bwd_dkv(FLASH_BWD_PARAMS(float)) {
  const Args a{q, k, v, mask, nullptr, dout, lse, delta, nullptr, dk, dv, lq, lk, heads};
  return flash_bwd_tc::with_head_dim(head_dim, [&](auto d) {
    return launch<decltype(d)::value>(a, batch, static_cast<cudaStream_t>(stream));
  });
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_dkv_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return flash_bwd_tc::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const cudaError_t err = prepare<D>();
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_bytes = Cfg<D>::SMEM;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_bwd_dkv_kernel<D>, Cfg<D>::kThreads, Cfg<D>::SMEM));
  });
}
