// Entry points of the single-launch masked flash-attention backward in f32
// (3xTF32 on the tensor cores): flash_bwd_ble (Q2) and flash_bwd_bhld_fused
// (Q6). The kernel template, its design and what bounds it are in
// flash_bwd_fused.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_fused.cuh"

// [B, L, H*D]; reads q, k, v, mask, o, dout, lse (delta computed here),
// writes dq, dk, dv.
extern "C" int flash_bwd_ble(FLASH_BWD_PARAMS(float)) {
  return ble<flash_ops::kF32>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq, lk,
                              heads, head_dim, stream);
}

// [B*H, L, D]; reads q, k, v, mask, dout, lse, delta, writes dq, dk, dv.
extern "C" int flash_bwd_bhld_fused(FLASH_BWD_PARAMS(float)) {
  return bhld<flash_ops::kF32>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq, lk,
                               heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_ble_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<true, flash_ops::kF32>(head_dim, smem_bytes, blocks_per_sm);
}

extern "C" int flash_bwd_bhld_fused_occupancy(int head_dim, int* smem_bytes,
                                              int* blocks_per_sm) {
  return occupancy<false, flash_ops::kF32>(head_dim, smem_bytes, blocks_per_sm);
}
