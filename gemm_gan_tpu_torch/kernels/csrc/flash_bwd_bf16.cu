// Entry point of the single-launch masked flash-attention backward in the
// ble layout with bf16 refs and f32-exact products (Q2, the Pallas
// `_bwd_kernel_ble` under compute_dtype="bfloat16";
// gemm_gan_tpu/kernels/flash_attention.py:317): the kernel template of
// flash_bwd_fused.cuh in mode kBf16 (flash_ops.cuh). Arguments as
// flash_bwd_ble's (flash_bwd_fused.cu), the element type bf16. A file of its
// own, so that nvcc builds it beside the other modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_fused.cuh"

extern "C" int flash_bwd_ble_bf16(FLASH_BWD_PARAMS(__nv_bfloat16)) {
  return ble<flash_ops::kBf16>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq, lk,
                               heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_ble_bf16_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<true, flash_ops::kBf16>(head_dim, smem_bytes, blocks_per_sm);
}
