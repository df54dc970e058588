// Masked flash-attention backward, dk and dv, classic layout, on Hopper's
// tensor cores (sm_90a), f32-grade through 3xTF32 products.
//
// flash_bwd_dkv replaces the Pallas TPU kernel `_bwd_dkv_kernel`
// (gemm_gan_tpu/kernels/flash_attention.py:220): q, dO [B*H, Lq, D], k, v
// [B*H, Lk, D], q already scaled, mask [B, Lk] (nonzero = valid), the
// forward's lse and delta = rowsum(dO * O), both [B, H, Lq]. Per (batch,
// head), with p_ij = exp(q_i . k_j - lse_i) for valid keys j (0 for masked
// keys), dp_ij = dO_i . v_j and ds_ij = p_ij (dp_ij - delta_i):
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i.
// Masked keys, and every key of a sample with no valid key, get exactly 0.
// dq is flash_bwd_dq's job.
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) it is 275 GFLOP (s, dp, dv, dk: 8 per query, key and head-dim
// element) over ~34 MB, so operations bound it: 4.1 ms on the CUDA cores
// (67 TFLOP/s f32), 1.67 ms in 3xTF32 on the tensor cores (495 TFLOP/s
// dense TF32, three products per f32 product).
//
// Design (FlashAttention-2's backward outer loop on mma.sync m16n8k8 tf32,
// helpers in tf32x3.cuh):
//  * a block of 4 warps owns 64 key rows of one (batch, head), 16 per
//    warp; grid (ceil(Lk / 64), H, B). dK and dV [16 x D per warp] stay in
//    f32 C fragments in registers for the whole loop; no atomics, so the
//    result is deterministic.
//  * the block's K and V stay resident in shared memory for the loop, raw
//    f32, and are split into hi/lo at each A-fragment load (12 ALU
//    operations per 24 mma at D = 64); kept pre-split they would take 128
//    registers or 64 KB more, halving the blocks per SM.
//  * tiles of BQ queries (64, or 32 at D = 128) of Q and dO, with their lse
//    and delta, stream through a double-buffered cp.async ring in dynamic
//    shared memory (96 KB per block at D = 64: two blocks per SM),
//    XOR-swizzled so that both fragment reads (as B of K.Q^T and of Q as
//    the right factor of dS^T.Q) are free of bank conflicts.
//  * per tile, four 3xTF32 products: S^T = K.Q^T and dP^T = V.dO^T, with
//    Q's and dO's rows read in tf32x3::perm order so their C fragments are
//    the A fragments of dV += P^T.dO and dK += dS^T.Q (no shuffles), each
//    tile's part summed in fresh accumulators and added once
//    (tf32x3::weight_rows);
//    P^T = exp(S^T - lse) by select on valid keys and query rows < Lq,
//    dS^T = P^T (dP^T - delta). Select, never a product with the mask: a
//    sample with no valid key has lse = -1e30, so exp(s - lse) is inf
//    there and inf * 0 would be NaN.
//  * a block whose 64 keys are all masked writes zeros and stops.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRowsK = 64;     // key rows per block

struct Args {
  const float* q;       // [B*H, Lq, D]
  const float* k;       // [B*H, Lk, D]
  const float* v;
  const uint8_t* mask;  // [B, Lk]
  const float* dout;    // like q
  const float* lse;     // [B, H, Lq]
  const float* delta;   // [B, H, Lq]
  float* dk;            // like k
  float* dv;
  int lq, lk, heads;
};

template <int D>
struct Cfg {
  static constexpr int BQ = D <= 64 ? 64 : 32;  // queries per tile
  static constexpr int NT = BQ / 8;             // n8 tiles of S^T (per warp)
  static constexpr int DT = D / 8;              // n8 tiles of dK, dV
  static constexpr int TILE = BQ * D;           // floats per Q or dO tile
  // K, V [64, D]; Q, dO x 2 stages; lse, delta x 2 stages
  static constexpr int SMEM = (2 * kRowsK * D + 4 * TILE + 4 * BQ) * 4;
};

// A fragment of rows [16 w, 16 w + 16) of a resident [64, D] tile, k-step kk
template <int D>
__device__ __forceinline__ void load_a(const float* tile, int r0, int kk, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {tile[swz<D>(r0 + g, 8 * kk + t)], tile[swz<D>(r0 + g + 8, 8 * kk + t)],
                      tile[swz<D>(r0 + g, 8 * kk + t + 4)],
                      tile[swz<D>(r0 + g + 8, 8 * kk + t + 4)]};
  split(x, hi, lo);
}

// acc[nt] += A.X^T over D for the 8 n-tiles of a streamed [BQ, D] tile X
// read in perm order (A: the warp's rows of a resident tile)
template <int D, int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const float* res, int r0,
                                         const float* x, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    load_a<D>(res, r0, kk, g, t, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = 8 * nt + perm(g);
      const float b[2] = {x[swz<D>(r, 8 * kk + t)], x[swz<D>(r, 8 * kk + t + 4)]};
      uint32_t bh_[2], bl_[2];
      split(b, bh_, bl_);
      mma3(acc[nt], ah, al, bh_, bl_);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [64, D]
  float* vs = ks + kRowsK * D;             // [64, D]
  float* qs = vs + kRowsK * D;             // [2][BQ, D]
  float* dos = qs + 2 * C::TILE;           // [2][BQ, D]
  float* lse_s = dos + 2 * C::TILE;        // [2][BQ]
  float* delta_s = lse_s + 2 * C::BQ;      // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const int k0 = blockIdx.x * kRowsK;
  const int r0 = warp * 16;                         // the warp's rows in the tile
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's key rows
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const bool key_ok[2] = {keys[0] < a.lk && mb[keys[0]], keys[1] < a.lk && mb[keys[1]]};
  float* dkb = a.dk + bh * a.lk * D;
  float* dvb = a.dv + bh * a.lk * D;

  const bool any = __syncthreads_or(tid < kRowsK && k0 + tid < a.lk && mb[k0 + tid]);
  float dk[C::DT][4], dv[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  if (any) {
    const float* qb = a.q + bh * a.lq * D;
    const float* dob = a.dout + bh * a.lq * D;
    const float* lseb = a.lse + bh * a.lq;
    const float* deltab = a.delta + bh * a.lq;
    auto stage = [&](int tile, int buf) {
      const int q0 = tile * C::BQ;
      stage_rows<D, C::BQ, kThreads>(qs + buf * C::TILE, qb, q0, a.lq);
      stage_rows<D, C::BQ, kThreads>(dos + buf * C::TILE, dob, q0, a.lq);
      if (tid < 2 * C::BQ) {
        const int i = tid % C::BQ;
        const bool live = q0 + i < a.lq;
        const float* src = (tid < C::BQ ? lseb : deltab) + (live ? q0 + i : 0);
        cp_async4((tid < C::BQ ? lse_s : delta_s) + buf * C::BQ + i, src, live);
      }
    };
    stage_rows<D, kRowsK, kThreads>(ks, a.k + bh * a.lk * D, k0, a.lk);
    stage_rows<D, kRowsK, kThreads>(vs, a.v + bh * a.lk * D, k0, a.lk);
    stage(0, 0);
    cp_async_commit();

    const int n_tiles = (a.lq + C::BQ - 1) / C::BQ;
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // K, V and tile it have landed (this thread's copies)
      __syncthreads();     // ... and everyone's

      const float* qt = qs + buf * C::TILE;
      const float* dot = dos + buf * C::TILE;
      const float* lse_t = lse_s + buf * C::BQ;
      const float* delta_t = delta_s + buf * C::BQ;
      const int q0 = it * C::BQ;

      // P^T = exp(K.Q^T - lse) on valid keys and live queries, else 0;
      // column j of n-tile nt is query 8 nt + perm(j)
      float p[C::NT][4];
      rows_dot<D, C::NT>(p, ks, r0, qt, g, t);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * nt + t + 4 * (e & 1);
          const bool live = key_ok[e >> 1] && q0 + qi < a.lq;
          p[nt][e] = live ? expf(p[nt][e] - lse_t[qi]) : 0.f;
        }
      }
      weight_rows<D, C::NT>(dv, p, dot, 1.f, 1.f, g, t);  // dV += P^T.dO

      // dS^T = P^T (V.dO^T - delta)
      float ds[C::NT][4];
      rows_dot<D, C::NT>(ds, vs, r0, dot, g, t);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[nt][e] = p[nt][e] * (ds[nt][e] - delta_t[8 * nt + t + 4 * (e & 1)]);
        }
      }
      weight_rows<D, C::NT>(dk, ds, qt, 1.f, 1.f, g, t);  // dK += dS^T.Q
      __syncthreads();  // every warp is done with buf before it is refilled
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.lk) continue;
    const int64_t off = static_cast<int64_t>(keys[i]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DT; ++n) {
      *reinterpret_cast<float2*>(dkb + off + 8 * n) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dvb + off + 8 * n) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lk + kRowsK - 1) / kRowsK, a.heads, batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, Cfg<D>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = Cfg<D>::SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_dkv_kernel<D>, kThreads, Cfg<D>::SMEM));
}

}  // namespace

// The backward entry points' common arguments (flash_bwd.cu); this one
// reads q, k, v, mask, dout, lse, delta and writes dk, dv ([B*H, L, D]).
extern "C" int flash_bwd_dkv(const float* q, const float* k, const float* v,
                             const uint8_t* mask, const float* /*o*/, const float* dout,
                             const float* lse, const float* delta, float* /*dq*/, float* dk,
                             float* dv, int batch, int lq, int lk, int heads, int head_dim,
                             void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dk, dv, lq, lk, heads};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 8: return launch<8>(a, batch, s);
    case 16: return launch<16>(a, batch, s);
    case 32: return launch<32>(a, batch, s);
    case 64: return launch<64>(a, batch, s);
    case 128: return launch<128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory per block and resident blocks per SM at head_dim.
extern "C" int flash_bwd_dkv_occupancy(int head_dim, int* smem_bytes, int* blocks_per_sm) {
  switch (head_dim) {
    case 8: return occupancy<8>(smem_bytes, blocks_per_sm);
    case 16: return occupancy<16>(smem_bytes, blocks_per_sm);
    case 32: return occupancy<32>(smem_bytes, blocks_per_sm);
    case 64: return occupancy<64>(smem_bytes, blocks_per_sm);
    case 128: return occupancy<128>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
