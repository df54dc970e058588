// Entry points of the masked flash-attention forward in f32 (3xTF32 on
// the tensor cores): flash_fwd_bhld (Q3) and flash_fwd_ble (Q1). The kernel
// template, its design and what bounds it are in flash_fwd.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"

extern "C" const char* gemm_gan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B*H, Lq, D], k, v [B*H, Lk, D]; mask [B, Lk]; o like q; lse [B, H, Lq].
extern "C" int flash_fwd_bhld(const float* q, const float* k, const float* v,
                              const uint8_t* mask, float* o, float* lse,
                              int batch, int lq, int lk, int heads, int head_dim,
                              void* stream) {
  return dispatch<false, flash_ops::kF32>(q, k, v, mask, o, lse, batch, lq, lk, heads,
                                          head_dim, stream);
}

// q, k, v [B, L, H*D] (k, v with Lk rows); mask [B, Lk]; o like q; lse [B, H, Lq].
extern "C" int flash_fwd_ble(const float* q, const float* k, const float* v,
                             const uint8_t* mask, float* o, float* lse,
                             int batch, int lq, int lk, int heads, int head_dim,
                             void* stream) {
  return dispatch<true, flash_ops::kF32>(q, k, v, mask, o, lse, batch, lq, lk, heads,
                                         head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_fwd_bhld_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<false, flash_ops::kF32>(head_dim, smem_bytes, blocks_per_sm);
}

extern "C" int flash_fwd_ble_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<true, flash_ops::kF32>(head_dim, smem_bytes, blocks_per_sm);
}
