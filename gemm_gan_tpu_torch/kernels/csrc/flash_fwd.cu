// Masked flash-attention forward on Hopper's tensor cores (sm_90a),
// f32-grade through 3xTF32 products; one kernel template for both layouts.
//
// Replaces two Pallas TPU kernels of gemm_gan_tpu/kernels/flash_attention.py:
//   flash_fwd_bhld <- `_fwd_kernel` (:84), reached via flash_mha: q, k, v
//                     [B*H, L, D] (the classic layout);
//   flash_fwd_ble  <- `_fwd_kernel_ble` (:290), reached via flash_mha_ble:
//                     q, k, v [B, L, E = H*D], head h the column slice
//                     [h*D, (h+1)*D); o in the same layout.
// Both take q already scaled and mask [B, Lk] (nonzero = valid), and write
// lse as [B, H, Lq] f32 (the TPU's ble kernel broadcasts it across 128 lanes
// for its (8, 128) tiling, which nothing here needs). Per (batch, head,
// query row):
//   s_j = q . k_j for valid keys j (masked keys and keys >= Lk take no part);
//   m = max_j s_j, l = sum_j exp(s_j - m);
//   o = sum_j exp(s_j - m) v_j / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   a row with no valid key gets o = 0 and lse = -1e30.
//
// What bounds it on an H100: the whole-slide patch self-attention (B 8,
// H 4, L 4,097, D 64; bhld) is 137.5 GFLOP over ~34 MB, and the canonical
// one (B 8, H 4, L 257, D 64; ble) 0.54 GFLOP over ~8.4 MB: both far above
// the ridge point, so operations bound them. On the CUDA cores (67 TFLOP/s
// f32) that is 2.05 / 0.0081 ms; in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product) 0.83 / 0.0033 ms.
//
// Design (FlashAttention-2 on mma.sync m16n8k8 tf32, helpers in tf32x3.cuh):
//  * a block of 4 warps owns 64 query rows of one (batch, head), 16 rows
//    per warp; grid (ceil(Lq / 64), H, B). At the ble layout's L 257 that is
//    160 blocks on 132 SMs with one live row in the last tile of each
//    (batch, head); blocks of 16 to 80 rows were no faster on the card:
//    smaller blocks stage every K/V tile for fewer rows (PERF.md,
//    scripts/torch_kernel_variants.py, variants ble_*rows).
//  * the layouts differ only in where a head's rows start and how far apart
//    they are: (b*H + h) * Lq * D and D (bhld, both compile-time multiples of
//    D), or (b * Lq * H + h) * D and H * D (ble; a head's D floats stay
//    contiguous and 16-byte aligned, so the cp.async copies are the same).
//  * Each warp splits its Q fragment into hi/lo A fragments once and keeps
//    them in registers (raw f32 at D = 128, split per use, to stay clear of
//    spills).
//  * K and V tiles of 32 keys (8 KB each at D = 64) are staged with
//    cp.async into a double-buffered ring in dynamic shared memory (32 KB
//    per block at D = 64), XOR-swizzled so that fragment reads have no bank
//    conflict. The next tile's copy and mask bytes are in flight while the
//    current tile is computed. 32-key tiles ran 4% faster than 64-key ones
//    on the card (fewer registers for S; registers, not shared memory, hold
//    it at 2 blocks per SM either way).
//  * K and V are split into hi/lo at each fragment load, not at staging:
//    pre-split tiles would double the ring and cost a pass over shared
//    memory and a barrier per tile; the split is 3 ALU operations per
//    element beside 3 mma per fragment, computed by each warp.
//  * S = Q.K^T by 3xTF32 mma; masked keys and keys >= Lk set to -1e30 by
//    select; online softmax (m, l) in f32 registers, row max over a quad by
//    __shfl_xor_sync, l kept per thread and summed over the quad at the end.
//  * K's columns are read in tf32x3::perm order, so S's C fragments are
//    P's A fragments for O = alpha O + P.V (3xTF32, P split hi/lo): no
//    shuffles. Each tile's P.V is summed in fresh accumulators and added to
//    O once (tf32x3::weight_rows).
//  * a tile whose keys are all masked is skipped (the mask is per batch, so
//    the branch is uniform in the block).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsQ = 16 * kWarps;  // query rows per block

struct Args {
  const float* q;       // [B*H, Lq, D] or [B, Lq, H*D]
  const float* k;       // [B*H, Lk, D] or [B, Lk, H*D]
  const float* v;
  const uint8_t* mask;  // [B, Lk]
  float* o;             // like q
  float* lse;           // [B, H, Lq]
  int lq, lk, heads;
};

template <int D>
struct Cfg {
  static constexpr int BK = 32;                 // keys per tile
  static constexpr int KS = D / 8;              // k8 steps of S over D
  static constexpr int NT = BK / 8;             // n8 tiles of S (per warp)
  static constexpr int OT = D / 8;              // n8 tiles of O
  static constexpr bool kQSplit = D <= 64;      // Q held as hi/lo fragments
  static constexpr int TILE = BK * D;           // floats per K or V tile
  static constexpr int SMEM = 4 * TILE * 4 + 2 * BK;  // K, V x 2 stages + valid flags
};

template <int D, bool kBle>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [2][BK, D]
  float* vs = smem + 2 * C::TILE;   // [2][BK, D]
  uint8_t* valid = reinterpret_cast<uint8_t*>(smem + 4 * C::TILE);  // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  // where (b, h)'s rows start, and the distance between rows, in floats
  const int64_t stride = kBle ? static_cast<int64_t>(a.heads) * D : D;
  const int64_t q_base = kBle ? (static_cast<int64_t>(b) * a.lq * a.heads + h) * D
                              : bh * a.lq * D;
  const int64_t k_base = kBle ? (static_cast<int64_t>(b) * a.lk * a.heads + h) * D
                              : bh * a.lk * D;
  const float* qb = a.q + q_base;
  const float* kb = a.k + k_base;
  const float* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const int row0 = blockIdx.x * kRowsQ + warp * 16;  // this warp's rows
  const int rows[2] = {row0 + g, row0 + g + 8};      // this thread's rows

  // Q as A fragments: a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
  float qf[C::KS][4];
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[i & 1];
      qf[kk][i] = r < a.lq ? qb[r * stride + 8 * kk + t + 4 * (i >> 1)] : 0.f;
    }
  }
  uint32_t qh[C::kQSplit ? C::KS : 1][4], ql[C::kQSplit ? C::KS : 1][4];
  if constexpr (C::kQSplit) {
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) split(qf[kk], qh[kk], ql[kk]);
  }

  float o[C::OT][4];
#pragma unroll
  for (int n = 0; n < C::OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  const int n_tiles = (a.lk + C::BK - 1) / C::BK;
  stage_rows<D, C::BK, kThreads>(ks, kb, 0, a.lk, stride);
  stage_rows<D, C::BK, kThreads>(vs, vb, 0, a.lk, stride);
  cp_async_commit();
  uint8_t mv = tid < C::BK && tid < a.lk ? mb[tid] : 0;  // next tile's flag

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const uint8_t mine = mv;
    if (tid < C::BK) valid[buf * C::BK + tid] = mine;
    if (it + 1 < n_tiles) {  // prefetch tile it + 1 into the other buffer
      const int k1 = (it + 1) * C::BK;
      stage_rows<D, C::BK, kThreads>(ks + (buf ^ 1) * C::TILE, kb, k1, a.lk, stride);
      stage_rows<D, C::BK, kThreads>(vs + (buf ^ 1) * C::TILE, vb, k1, a.lk, stride);
      mv = tid < C::BK && k1 + tid < a.lk ? mb[k1 + tid] : 0;
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed (for this thread's copies)
    if (!__syncthreads_or(mine)) continue;  // every key of the tile is masked

    const float* kt = ks + buf * C::TILE;
    const float* vt = vs + buf * C::TILE;
    const uint8_t* ok = valid + buf * C::BK;

    // S = Q.K^T; column j of n-tile nt holds key 8 nt + perm(j)
    float s[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::kQSplit) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk][i];
          al[i] = ql[kk][i];
        }
      } else {
        split(qf[kk], ah, al);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int r = 8 * nt + perm(g);
        const float kv[2] = {kt[swz<D>(r, 8 * kk + t)], kt[swz<D>(r, 8 * kk + t + 4)]};
        uint32_t bh_[2], bl_[2];
        split(kv, bh_, bl_);
        mma3(s[nt], ah, al, bh_, bl_);
      }
    }

    // mask by select, then the online softmax
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const bool ok0 = ok[8 * nt + t], ok1 = ok[8 * nt + t + 4];
      s[nt][0] = ok0 ? s[nt][0] : kNegInf;
      s[nt][1] = ok1 ? s[nt][1] : kNegInf;
      s[nt][2] = ok0 ? s[nt][2] : kNegInf;
      s[nt][3] = ok1 ? s[nt][3] : kNegInf;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // masked: exp(-1e30 - m) == 0
        l[e >> 1] += s[nt][e];
      }
    }
    // O = alpha O + P.V: n-tile nt of S is the A fragment of k-step nt
    weight_rows<D, C::NT>(o, s, vt, alpha[0], alpha[1], g, t);
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    const bool empty = m[i] <= 0.5f * kNegInf;  // no valid key in this row
    const int r = rows[i];
    if (r >= a.lq) continue;
    float* orow = a.o + q_base + r * stride;
#pragma unroll
    for (int n = 0; n < C::OT; ++n) {
      const float2 x = empty ? make_float2(0.f, 0.f)
                             : make_float2(o[n][2 * i] / lc, o[n][2 * i + 1] / lc);
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = x;
    }
    if (t == 0) a.lse[bh * a.lq + r] = m[i] + logf(lc);
  }
}

template <int D, bool kBle>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_fwd_kernel<D, kBle>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
}

template <int D, bool kBle>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = prepare<D, kBle>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lq + kRowsQ - 1) / kRowsQ, a.heads, batch);
  flash_fwd_kernel<D, kBle><<<grid, kThreads, Cfg<D>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBle>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D, kBle>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = Cfg<D>::SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<D, kBle>, kThreads, Cfg<D>::SMEM));
}

template <bool kBle>
int dispatch(const Args& a, int head_dim, int batch, cudaStream_t s) {
  switch (head_dim) {
    case 8: return launch<8, kBle>(a, batch, s);
    case 16: return launch<16, kBle>(a, batch, s);
    case 32: return launch<32, kBle>(a, batch, s);
    case 64: return launch<64, kBle>(a, batch, s);
    case 128: return launch<128, kBle>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBle>
int dispatch_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  switch (head_dim) {
    case 8: return occupancy<8, kBle>(smem_bytes, blocks_per_sm);
    case 16: return occupancy<16, kBle>(smem_bytes, blocks_per_sm);
    case 32: return occupancy<32, kBle>(smem_bytes, blocks_per_sm);
    case 64: return occupancy<64, kBle>(smem_bytes, blocks_per_sm);
    case 128: return occupancy<128, kBle>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* gemm_gan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B*H, Lq, D], k, v [B*H, Lk, D]; mask [B, Lk]; o like q; lse [B, H, Lq].
extern "C" int flash_fwd_bhld(const float* q, const float* k, const float* v,
                              const uint8_t* mask, float* o, float* lse,
                              int batch, int lq, int lk, int heads, int head_dim,
                              void* stream) {
  const Args a{q, k, v, mask, o, lse, lq, lk, heads};
  return dispatch<false>(a, head_dim, batch, static_cast<cudaStream_t>(stream));
}

// q, k, v [B, L, H*D] (k, v with Lk rows); mask [B, Lk]; o like q; lse [B, H, Lq].
extern "C" int flash_fwd_ble(const float* q, const float* k, const float* v,
                             const uint8_t* mask, float* o, float* lse,
                             int batch, int lq, int lk, int heads, int head_dim,
                             void* stream) {
  const Args a{q, k, v, mask, o, lse, lq, lk, heads};
  return dispatch<true>(a, head_dim, batch, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_fwd_bhld_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return dispatch_occupancy<false>(head_dim, smem_bytes, blocks_per_sm);
}

extern "C" int flash_fwd_ble_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  return dispatch_occupancy<true>(head_dim, smem_bytes, blocks_per_sm);
}
