// Masked flash-attention backward, dq, dk and dv in one launch, classic
// layout, on Hopper's tensor cores (sm_90a), f32-grade through 3xTF32
// products.
//
// flash_bwd_bhld_fused replaces the Pallas TPU kernel `_bwd_fused_kernel`
// (gemm_gan_tpu/kernels/flash_attention.py:179), which the JAX package
// takes for single-block shapes (`_flash_core_bwd`, n_q == n_k == 1; in
// practice the canonical L 257 with flash_layout="bhld"): q, dO
// [B*H, Lq, D], k, v [B*H, Lk, D], q already scaled, mask [B, Lk], lse and
// delta = rowsum(dO * O) given as [B, H, Lq] -> dq, dk, dv (the arithmetic
// is in flash_bwd_tc.cuh). Masked keys, and a sample with no valid key, get
// exactly 0.
//
// What bounds it on an H100: at the canonical shape (B 8, H 4, L 257,
// D 64) it is 1.35 GFLOP (s, dp, dv, dq, dk: 10 per query, key and
// head-dim element) over ~14 MB, so operations bound it: 0.020 ms on the
// CUDA cores (67 TFLOP/s f32), 0.0082 ms in 3xTF32 on the tensor cores.
//
// Design: one grid holds both kinds of tile of flash_bwd_tc.cuh, so that
// nothing passes between blocks and no atomics are needed: blockIdx.y <
// n_dkv runs a dk/dv tile (4 warps x 16 key rows, Q and dO streamed in
// tiles of 64 queries, 32 at D = 128: Q5's configuration), the rest dq
// tiles (4 warps x 16 query rows, K and V streamed in 32-key tiles).
// blockIdx.x is the (batch, head), so the blocks start in order of y: the
// longer dk/dv tiles (4 products per query-key pair against the dq tile's
// 3) first, and the dq tiles fill the SMs as they drain. Registers and
// shared memory are those of the larger body, the dk/dv tile's (≈255
// registers and 97 KB at D = 64: two blocks per SM). 32-row tiles (2 warps,
// 32-query dk/dv tiles, 4 blocks per SM), which pad L 257 less, ran 1%
// faster to 7% slower from one card to the next (PERF.md; variants fused
// and fused_32rows of scripts/torch_kernel_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"

namespace {

using flash_bwd_tc::Args;

constexpr int kWarps = 4;  // 64 rows per tile of either kind
template <int D>
constexpr int kQueries = D <= 64 ? 64 : 32;  // queries per streamed dk/dv tile

template <int D>
struct Cfg {
  using Dkv = flash_bwd_tc::DkvCfg<D, kWarps, kQueries<D>>;
  using Dq = flash_bwd_tc::DqCfg<D, kWarps>;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int R = 16 * kWarps;
  static constexpr int SMEM = Dkv::SMEM > Dq::SMEM ? Dkv::SMEM : Dq::SMEM;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads) flash_bwd_fused_kernel(const Args a,
                                                                           int n_dkv) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x % a.heads, b = blockIdx.x / a.heads;
  if (static_cast<int>(blockIdx.y) < n_dkv) {
    flash_bwd_tc::dkv_tile<D, kWarps, kQueries<D>>(a, blockIdx.y, h, b, smem);
  } else {
    flash_bwd_tc::dq_tile<D, kWarps>(a, blockIdx.y - n_dkv, h, b, smem);
  }
}

template <int D>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_bwd_fused_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_dkv = (a.lk + Cfg<D>::R - 1) / Cfg<D>::R;
  const int n_dq = (a.lq + Cfg<D>::R - 1) / Cfg<D>::R;
  const dim3 grid(batch * a.heads, n_dkv + n_dq);
  flash_bwd_fused_kernel<D><<<grid, Cfg<D>::kThreads, Cfg<D>::SMEM, stream>>>(a, n_dkv);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = Cfg<D>::SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_fused_kernel<D>, Cfg<D>::kThreads, Cfg<D>::SMEM));
}

}  // namespace

// The backward entry points' common arguments (flash_bwd.cu); this one
// reads q, k, v, mask, dout, lse, delta and writes dq, dk, dv ([B*H, L, D]).
extern "C" int flash_bwd_bhld_fused(const float* q, const float* k, const float* v,
                                    const uint8_t* mask, const float* /*o*/, const float* dout,
                                    const float* lse, const float* delta, float* dq, float* dk,
                                    float* dv, int batch, int lq, int lk, int heads,
                                    int head_dim, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dq, dk, dv, lq, lk, heads};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 8: return launch<8>(a, batch, s);
    case 16: return launch<16>(a, batch, s);
    case 32: return launch<32>(a, batch, s);
    case 64: return launch<64>(a, batch, s);
    case 128: return launch<128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_bhld_fused_occupancy(int head_dim, int* smem_bytes,
                                              int* blocks_per_sm) {
  switch (head_dim) {
    case 8: return occupancy<8>(smem_bytes, blocks_per_sm);
    case 16: return occupancy<16>(smem_bytes, blocks_per_sm);
    case 32: return occupancy<32>(smem_bytes, blocks_per_sm);
    case 64: return occupancy<64>(smem_bytes, blocks_per_sm);
    case 128: return occupancy<128>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
