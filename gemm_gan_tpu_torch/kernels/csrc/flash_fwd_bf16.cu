// Entry points of the masked flash-attention forward's bf16 modes in the
// ble layout (Q1, the Pallas `_fwd_kernel_ble` with bf16 refs or mxu_bf16;
// gemm_gan_tpu/kernels/flash_attention.py:290): the kernel template of
// flash_fwd.cuh in the modes of flash_ops.cuh. Arguments as flash_fwd_ble's
// (flash_fwd.cu): q, k, v, o [B, L, H*D] of the mode's element type, mask
// [B, Lk], lse [B, H, Lq] f32; flash_fwd_ble_mxu also takes the element
// type (bf16_refs), so that each (kernel, mode) has one entry point.
// flash_fwd_ble_mxu on bf16 refs runs the wgmma tile of flash_fwd_wg.cuh
// (at D 16, 32, 64), flash_fwd_ble_bf16 the mma.sync one (flash_fwd.cuh's
// kWg says why).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"

// bf16 q, k, v -> bf16 o: f32-exact products (compute_dtype="bfloat16")
extern "C" int flash_fwd_ble_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const uint8_t* mask,
                                  __nv_bfloat16* o, float* lse, int batch, int lq, int lk,
                                  int heads, int head_dim, void* stream) {
  return dispatch<true, flash_ops::kBf16>(q, k, v, mask, o, lse, batch, lq, lk, heads,
                                          head_dim, stream);
}

// every product's operands rounded to bf16 (mxu_bf16): q, k, v -> o all
// f32 (bf16_refs 0) or all bf16 (bf16_refs 1)
extern "C" int flash_fwd_ble_mxu(const void* q, const void* k, const void* v, const uint8_t* mask,
                                 void* o, float* lse, int batch, int lq, int lk, int heads,
                                 int head_dim, void* stream, int bf16_refs) {
  return bf16_refs ? dispatch<true, flash_ops::kMxuBf16>(q, k, v, mask, o, lse, batch, lq, lk,
                                                         heads, head_dim, stream)
                   : dispatch<true, flash_ops::kMxuF32>(q, k, v, mask, o, lse, batch, lq, lk,
                                                        heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_fwd_ble_bf16_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<true, flash_ops::kBf16>(head_dim, smem_bytes, blocks_per_sm);
}

// (for mxu_bf16: of the bf16 refs' instantiation, the bench configuration's)
extern "C" int flash_fwd_ble_mxu_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<true, flash_ops::kMxuBf16>(head_dim, smem_bytes, blocks_per_sm);
}
