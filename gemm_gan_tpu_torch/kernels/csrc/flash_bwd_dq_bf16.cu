// Entry points of the masked flash-attention backward's dq kernel in the
// bf16 modes (Q4, the Pallas `_bwd_dq_kernel` with bf16 refs or mxu_bf16;
// gemm_gan_tpu/kernels/flash_attention.py:142): the kernel template of
// flash_bwd_dq.cuh in the modes of flash_ops.cuh. Arguments as
// flash_bwd_dq's (flash_bwd_dq.cu), lse and delta f32; flash_bwd_dq_mxu
// also takes the element type (bf16_refs). On bf16 refs at D 16, 32 and 64
// both run the wgmma dq tile of flash_bwd_wg.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_dq.cuh"

// bf16 q, k, v, dO -> bf16 dq: f32-exact products (compute_dtype="bfloat16")
extern "C" int flash_bwd_dq_bf16(FLASH_BWD_PARAMS(__nv_bfloat16)) {
  return dq_entry<flash_ops::kBf16>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq,
                                    lk, heads, head_dim, stream);
}

// every product's operands rounded to bf16 (mxu_bf16): q, k, v, dO -> dq
// all f32 (bf16_refs 0) or all bf16 (bf16_refs 1)
extern "C" int flash_bwd_dq_mxu(FLASH_BWD_PARAMS(void), int bf16_refs) {
  return flash_bwd_tc::mxu_call(bf16_refs, q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch,
                                lq, lk, heads, head_dim, stream, [](auto mode, auto... args) {
                                  return dq_entry<decltype(mode)::value>(args...);
                                });
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_dq_bf16_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<flash_ops::kBf16>(head_dim, smem_bytes, blocks_per_sm);
}

// (for mxu_bf16: of the bf16 refs' instantiation, the bench configuration's)
extern "C" int flash_bwd_dq_mxu_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<flash_ops::kMxuBf16>(head_dim, smem_bytes, blocks_per_sm);
}
