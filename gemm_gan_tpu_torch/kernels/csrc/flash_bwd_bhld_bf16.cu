// Entry point of the single-launch masked flash-attention backward in the
// classic layout with bf16 refs and f32-exact products (Q6, the Pallas
// `_bwd_fused_kernel` under compute_dtype="bfloat16";
// gemm_gan_tpu/kernels/flash_attention.py:179): the kernel template of
// flash_bwd_fused.cuh in mode kBf16 (flash_ops.cuh). Arguments as
// flash_bwd_bhld_fused's (flash_bwd_fused.cu), the element type bf16, lse
// and delta f32. A file of its own, so that nvcc builds it beside the
// other modes.
//
// What bounds it on an H100: at the bhld canonical shape (B 8, H 4, L 257,
// D 64) a product is 0.27 GFLOP; the bf16 mode takes 11 bf16 passes of the
// 5 products (S, dP once; dV, dK, dQ with P or dS in three terms: 0.0030 ms
// at 989 TFLOP/s dense bf16) against 7.4 MB of q, k, v, dO, dq, dk, dv in
// bf16 (0.0022 ms at 3.35 TB/s): operations bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_fused.cuh"

extern "C" int flash_bwd_bhld_fused_bf16(FLASH_BWD_PARAMS(__nv_bfloat16)) {
  return bhld<flash_ops::kBf16>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq, lk,
                                heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_bhld_fused_bf16_occupancy(int head_dim, int* smem_bytes,
                                                   int* blocks_per_sm) {
  return occupancy<false, flash_ops::kBf16>(head_dim, smem_bytes, blocks_per_sm);
}
