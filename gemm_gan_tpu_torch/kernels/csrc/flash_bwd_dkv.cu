// Entry points of the masked flash-attention backward's dk/dv kernel in f32
// (3xTF32 on the tensor cores): flash_bwd_dkv (Q5). The kernel template,
// its design and what bounds it are in flash_bwd_dkv.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_dkv.cuh"

// [B*H, L, D]; reads q, k, v, mask, dout, lse, delta, writes dk, dv.
extern "C" int flash_bwd_dkv(FLASH_BWD_PARAMS(float)) {
  return dkv_entry<flash_ops::kF32>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, batch, lq,
                                    lk, heads, head_dim, stream);
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_dkv_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return occupancy<flash_ops::kF32>(head_dim, smem_bytes, blocks_per_sm);
}
