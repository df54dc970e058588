// Entry points of the masked flash-attention forward's bf16 modes in the
// classic layout (Q3, the Pallas `_fwd_kernel` with bf16 refs or mxu_bf16;
// gemm_gan_tpu/kernels/flash_attention.py:84): the kernel template of
// flash_fwd.cuh in the modes of flash_ops.cuh. Arguments as
// flash_fwd_bhld's (flash_fwd.cu): q, k, v, o [B*H, L, D] of the mode's
// element type, mask [B, Lk], lse [B, H, Lq] f32; flash_fwd_bhld_mxu also
// takes the element type (bf16_refs), as flash_fwd_ble_mxu does.
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) a product (S or P.V) is 68.8 GFLOP. The bf16 mode takes 4 bf16
// passes (S once, P.V with P in three terms: 0.278 ms at 989 TFLOP/s dense
// bf16), mxu_bf16 3 (S twice, in the per-block first pass and the second,
// P.V once: 0.209 ms), against 17 MB of q, k, v, o in bf16 (0.005 ms at
// 3.35 TB/s): operations bound both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"

// bf16 q, k, v -> bf16 o: f32-exact products (compute_dtype="bfloat16")
extern "C" int flash_fwd_bhld_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const uint8_t* mask,
                                   __nv_bfloat16* o, float* lse, int batch, int lq, int lk,
                                   int heads, int head_dim, void* stream) {
  return dispatch<false, flash_ops::kBf16>(q, k, v, mask, o, lse, batch, lq, lk, heads,
                                           head_dim, stream);
}

// every product's operands rounded to bf16 (mxu_bf16), P per key block:
// q, k, v -> o all f32 (bf16_refs 0) or all bf16 (bf16_refs 1)
extern "C" int flash_fwd_bhld_mxu(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* o, float* lse, int batch, int lq,
                                  int lk, int heads, int head_dim, void* stream, int bf16_refs) {
  return bf16_refs ? dispatch<false, flash_ops::kMxuBf16>(q, k, v, mask, o, lse, batch, lq, lk,
                                                          heads, head_dim, stream)
                   : dispatch<false, flash_ops::kMxuF32>(q, k, v, mask, o, lse, batch, lq, lk,
                                                         heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_fwd_bhld_bf16_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<false, flash_ops::kBf16>(head_dim, smem_bytes, blocks_per_sm);
}

// (for mxu_bf16: of the bf16 refs' instantiation, the bench configuration's)
extern "C" int flash_fwd_bhld_mxu_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<false, flash_ops::kMxuBf16>(head_dim, smem_bytes, blocks_per_sm);
}
