// Entry point of the single-launch masked flash-attention backward in the
// classic layout under mxu_bf16 (Q6, the Pallas `_bwd_fused_kernel` with
// mxu_bf16=True; gemm_gan_tpu/kernels/flash_attention.py:179): every
// product's operands, P and dS included, rounded to bf16; the kernel
// template of flash_bwd_fused.cuh in modes kMxuF32 and kMxuBf16
// (flash_ops.cuh), one entry point that also takes the element type
// (bf16_refs). Arguments as flash_bwd_bhld_fused's (flash_bwd_fused.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_fused.cuh"

// q, k, v, dO -> dq, dk, dv all f32 (bf16_refs 0) or all bf16 (1)
extern "C" int flash_bwd_bhld_fused_mxu(FLASH_BWD_PARAMS(void), int bf16_refs) {
  return flash_bwd_tc::mxu_call(bf16_refs, q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch,
                                lq, lk, heads, head_dim, stream, [](auto mode, auto... args) {
                                  return bhld<decltype(mode)::value>(args...);
                                });
}

// Dynamic shared memory per block and resident blocks per SM at head_dim
// (of the bf16 refs' instantiation, the bench configuration's).
extern "C" int flash_bwd_bhld_fused_mxu_occupancy(int head_dim, int* smem_bytes,
                                                  int* blocks_per_sm) {
  return occupancy<false, flash_ops::kMxuBf16>(head_dim, smem_bytes, blocks_per_sm);
}
