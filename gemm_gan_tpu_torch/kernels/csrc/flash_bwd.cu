// Masked flash-attention backward for Hopper (sm_90a), f32, on the CUDA cores.
//
// Replaces two of the four Pallas TPU backward kernels of
// gemm_gan_tpu/kernels/flash_attention.py (the other two run on the tensor
// cores: _bwd_dkv_kernel (:220) is flash_bwd_dkv in flash_bwd_dkv.cu,
// _bwd_fused_kernel (:179) flash_bwd_bhld_fused in flash_bwd_fused.cu):
//   flash_bwd_ble         <- _bwd_kernel_ble (:317). q, k, v, o, dO, dq, dk,
//                            dv in the projection layout [B, L, E = H*D];
//                            delta = rowsum(dO * O) is computed in-kernel.
//   flash_bwd_dq          <- _bwd_dq_kernel (:142), blocked dq of the
//                            classic layout [B*H, L, D]; delta given.
// lse and delta are [B, H, Lq] f32 (no TPU lane broadcast).
//
// What each computes, per (batch, head), with q already scaled and lse the
// forward's log-sum-exp:
//   p_ij  = exp(q_i . k_j - lse_i) for valid keys j, 0 for masked keys;
//   dp_ij = dO_i . v_j;  ds_ij = p_ij (dp_ij - delta_i);
//   dq_i = sum_j ds_ij k_j;  dk_j = sum_i ds_ij q_i;  dv_j = sum_i p_ij dO_i.
// Masked keys contribute exactly 0 and get dk = dv = 0; a row with no
// valid key gets dq = 0 (the mask is per batch, so its whole sample has
// no valid key and every p is 0).
//
// What bounds it on an H100: the canonical patch self-attention (B=8, H=4,
// L=257, D=64) needs 10*B*H*L*L*D = 1.35 GFLOP (s, dp, dv, dq, dk) over
// ~14 MB, the whole-slide dq pass (L=4097) 206 GFLOP (6 per element) over
// ~34 MB: both far above the f32 ridge point (20 FLOP/byte), so operations
// bound them.
//
// Design, simple and correct first. Every kernel is one template over two
// kinds of 128-thread tile, chosen by blockIdx.x:
//  * a dq tile owns a run of query rows, T_q = max(1, D/32) threads per
//    row, each holding a 32-wide slice of q, dO and the dq accumulator in
//    registers (96 floats at most: the forward's q[D] + acc[D] per thread
//    would not leave room for dO). Keys are staged through shared memory
//    in tiles of 64 (32 at D=128); the two dot products per key are summed
//    across the T_q threads with warp shuffles.
//  * a dk/dv tile owns a run of key rows, T_k = max(1, D/16) threads per
//    row, each holding 16-wide slices of k, v, dk and dv (64 floats).
//    Queries, dO, lse and delta are staged through shared memory in tiles
//    of 64 (32 at D=128).
// flash_bwd_dq launches only dq tiles, and the single-block ble kernel both
// kinds in ONE launch: the grid is (n_dq_tiles + n_dkv_tiles, H, B). Nothing passes between tiles,
// so the ble kernel's dk/dv tiles compute delta for their staged queries
// themselves (Lq*D FMAs, small beside the tile's 4*Lq*rows*D). At the
// canonical shape that gives (5 + 9) * 32 = 448 blocks, not the B*H = 32
// one block per (batch, head) would give on 132 SMs. All arithmetic is f32
// FMA on the CUDA cores; the tensor cores (wgmma) need tf32/bf16 operands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // [B, Lk], nonzero = valid
  const float* o;       // like q; read only when delta is computed here
  const float* dout;    // like q
  const float* lse;     // [B, H, Lq]
  const float* delta;   // [B, H, Lq], or null: computed from o and dout
  float* dq;            // like q
  float* dk;            // like k
  float* dv;            // like k
  int64_t q_sb, q_sh, q_sr;  // q, o, dout, dq: batch, head and row strides
  int64_t k_sb, k_sh, k_sr;  // k, v, dk, dv
  int lq, lk, heads;
};

template <int D>
struct Shape {
  static constexpr int TQ = D > 32 ? D / 32 : 1;  // threads per query row
  static constexpr int SQ = D / TQ;               // floats each of them holds
  static constexpr int RQ = kThreads / TQ;        // query rows per dq tile
  static constexpr int TK = D > 16 ? D / 16 : 1;  // threads per key row
  static constexpr int SK = D / TK;
  static constexpr int RK = kThreads / TK;        // key rows per dk/dv tile
  static constexpr int BT = D <= 64 ? 64 : 32;    // rows per staged tile
  static constexpr int SMEM = 2 * BT * D + 2 * BT;  // floats
};

// Sum over the T consecutive lanes that share a row (T divides 32).
template <int T>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int S>
__device__ __forceinline__ void load_slice(const float* p, bool live, float* x) {
#pragma unroll
  for (int c = 0; c < S; c += 4) {
    const float4 f = live ? *reinterpret_cast<const float4*>(p + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    x[c] = f.x;
    x[c + 1] = f.y;
    x[c + 2] = f.z;
    x[c + 3] = f.w;
  }
}

template <int S>
__device__ __forceinline__ void store_slice(float* p, const float* x) {
#pragma unroll
  for (int c = 0; c < S; c += 4)
    *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
}

template <int S>
__device__ __forceinline__ float dot_slice(const float* x, const float* smem_row) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < S; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(smem_row + c);
    acc = fmaf(x[c], f.x, acc);
    acc = fmaf(x[c + 1], f.y, acc);
    acc = fmaf(x[c + 2], f.z, acc);
    acc = fmaf(x[c + 3], f.w, acc);
  }
  return acc;
}

template <int S>
__device__ __forceinline__ void axpy_slice(float a, const float* smem_row, float* y) {
#pragma unroll
  for (int c = 0; c < S; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(smem_row + c);
    y[c] = fmaf(a, f.x, y[c]);
    y[c + 1] = fmaf(a, f.y, y[c + 1]);
    y[c + 2] = fmaf(a, f.z, y[c + 2]);
    y[c + 3] = fmaf(a, f.w, y[c + 3]);
  }
}

// Stage rows [r0, r0 + n) of two [*, D] operands (row stride `sr`) into
// shared memory as dense [n, D] tiles.
template <int D>
__device__ __forceinline__ void stage_pair(const float* x, const float* y, int64_t sr,
                                           int r0, int n, float* xs, float* ys) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < n * V4; i += kThreads) {
    const int r = i / V4;
    const int c = i % V4;
    const int64_t off = static_cast<int64_t>(r0 + r) * sr;
    reinterpret_cast<float4*>(xs + r * D)[c] = reinterpret_cast<const float4*>(x + off)[c];
    reinterpret_cast<float4*>(ys + r * D)[c] = reinterpret_cast<const float4*>(y + off)[c];
  }
}

// dq for query rows [tile * RQ, tile * RQ + RQ) of one (batch, head).
template <int D, bool kDeltaHere>
__device__ void dq_tile(const Args& a, int tile, int h, int b, float* smem) {
  using Sh = Shape<D>;
  constexpr int T = Sh::TQ, S = Sh::SQ, BK = Sh::BT;
  float* ks = smem;
  float* vs = smem + BK * D;
  uint8_t* valid = reinterpret_cast<uint8_t*>(smem + 2 * BK * D);

  const int part = threadIdx.x % T;
  const int row = tile * Sh::RQ + threadIdx.x / T;
  const bool live = row < a.lq;
  const int64_t q_off = b * a.q_sb + h * a.q_sh + static_cast<int64_t>(row) * a.q_sr + part * S;
  const int64_t stat = (static_cast<int64_t>(b) * a.heads + h) * a.lq + row;

  float q[S], dO[S], dq[S];
  load_slice<S>(a.q + q_off, live, q);
  load_slice<S>(a.dout + q_off, live, dO);
  const float lse = live ? a.lse[stat] : 0.f;
  float delta;
  if constexpr (kDeltaHere) {
    float o[S];
    load_slice<S>(a.o + q_off, live, o);
    float part_sum = 0.f;
#pragma unroll
    for (int c = 0; c < S; ++c) part_sum = fmaf(dO[c], o[c], part_sum);
    delta = group_sum<T>(part_sum);
  } else {
    delta = live ? a.delta[stat] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < S; ++c) dq[c] = 0.f;

  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.k_sb + h * a.k_sh;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  for (int k0 = 0; k0 < a.lk; k0 += BK) {
    const int n = min(BK, a.lk - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_pair<D>(kb, vb, a.k_sr, k0, n, ks, vs);
    for (int i = threadIdx.x; i < n; i += kThreads) valid[i] = mb[k0 + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!valid[j]) continue;  // the mask is per batch: uniform in the block
      const float* kr = ks + j * D + part * S;
      const float s = group_sum<T>(dot_slice<S>(q, kr));
      const float dp = group_sum<T>(dot_slice<S>(dO, vs + j * D + part * S));
      const float ds = expf(s - lse) * (dp - delta);
      axpy_slice<S>(ds, kr, dq);
    }
  }
  if (live) store_slice<S>(a.dq + q_off, dq);
}

// dk, dv for key rows [tile * RK, tile * RK + RK) of one (batch, head).
template <int D, bool kDeltaHere>
__device__ void dkv_tile(const Args& a, int tile, int h, int b, float* smem) {
  using Sh = Shape<D>;
  constexpr int T = Sh::TK, S = Sh::SK, BQ = Sh::BT, V4 = D / 4;
  float* qs = smem;
  float* dos = smem + BQ * D;
  float* lse_s = smem + 2 * BQ * D;
  float* delta_s = lse_s + BQ;

  const int part = threadIdx.x % T;
  const int row = tile * Sh::RK + threadIdx.x / T;
  const bool live = row < a.lk;
  const bool key_valid = live && a.mask[static_cast<int64_t>(b) * a.lk + row];
  const int64_t k_off = b * a.k_sb + h * a.k_sh + static_cast<int64_t>(row) * a.k_sr + part * S;

  float k[S], v[S], dk[S], dv[S];
  load_slice<S>(a.k + k_off, live, k);
  load_slice<S>(a.v + k_off, live, v);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    dk[c] = 0.f;
    dv[c] = 0.f;
  }

  const int64_t q_base = b * a.q_sb + h * a.q_sh;
  const int64_t stat_base = (static_cast<int64_t>(b) * a.heads + h) * a.lq;
  for (int q0 = 0; q0 < a.lq; q0 += BQ) {
    const int n = min(BQ, a.lq - q0);
    __syncthreads();
    stage_pair<D>(a.q + q_base, a.dout + q_base, a.q_sr, q0, n, qs, dos);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      lse_s[i] = a.lse[stat_base + q0 + i];
      if constexpr (kDeltaHere) {
        const int64_t off = q_base + static_cast<int64_t>(q0 + i) * a.q_sr;
        const float4* o4 = reinterpret_cast<const float4*>(a.o + off);
        const float4* d4 = reinterpret_cast<const float4*>(a.dout + off);
        float acc = 0.f;
        for (int c = 0; c < V4; ++c) {
          const float4 x = o4[c];
          const float4 y = d4[c];
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
        }
        delta_s[i] = acc;
      } else {
        delta_s[i] = a.delta[stat_base + q0 + i];
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* qr = qs + i * D + part * S;
      const float* dr = dos + i * D + part * S;
      const float s = group_sum<T>(dot_slice<S>(k, qr));
      const float dp = group_sum<T>(dot_slice<S>(v, dr));
      const float p = key_valid ? expf(s - lse_s[i]) : 0.f;
      axpy_slice<S>(p, dr, dv);
      axpy_slice<S>(p * (dp - delta_s[i]), qr, dk);
    }
  }
  if (live) {
    store_slice<S>(a.dk + k_off, dk);
    store_slice<S>(a.dv + k_off, dv);
  }
}

// Blocks [0, n_dq_tiles) run dq tiles, the rest dk/dv tiles.
template <int D, bool kDq, bool kDkv, bool kDeltaHere>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const Args a, int n_dq_tiles) {
  __shared__ __align__(16) float smem[Shape<D>::SMEM];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = blockIdx.x;
  if constexpr (kDq) {
    if (t < n_dq_tiles) {
      dq_tile<D, kDeltaHere>(a, t, h, b, smem);
      return;
    }
  }
  if constexpr (kDkv) dkv_tile<D, kDeltaHere>(a, t - n_dq_tiles, h, b, smem);
}

template <int D, bool kDq, bool kDkv, bool kDeltaHere>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using Sh = Shape<D>;
  const int n_dq = kDq ? (a.lq + Sh::RQ - 1) / Sh::RQ : 0;
  const int n_dkv = kDkv ? (a.lk + Sh::RK - 1) / Sh::RK : 0;
  const dim3 grid(n_dq + n_dkv, a.heads, batch);
  flash_bwd_kernel<D, kDq, kDkv, kDeltaHere><<<grid, kThreads, 0, stream>>>(a, n_dq);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq, bool kDkv, bool kDeltaHere>
int dispatch(const Args& a, int head_dim, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 8: return launch<8, kDq, kDkv, kDeltaHere>(a, batch, stream);
    case 16: return launch<16, kDq, kDkv, kDeltaHere>(a, batch, stream);
    case 32: return launch<32, kDq, kDkv, kDeltaHere>(a, batch, stream);
    case 64: return launch<64, kDq, kDkv, kDeltaHere>(a, batch, stream);
    case 128: return launch<128, kDq, kDkv, kDeltaHere>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args ble_args(const float* q, const float* k, const float* v, const uint8_t* mask,
              const float* o, const float* dout, const float* lse, const float* delta,
              float* dq, float* dk, float* dv, int lq, int lk, int heads, int head_dim) {
  const int64_t e = static_cast<int64_t>(heads) * head_dim;
  return Args{q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
              lq * e, head_dim, e,
              lk * e, head_dim, e,
              lq, lk, heads};
}

Args bhld_args(const float* q, const float* k, const float* v, const uint8_t* mask,
               const float* o, const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int lq, int lk, int heads, int head_dim) {
  const int64_t d = head_dim;
  return Args{q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
              heads * (lq * d), lq * d, d,
              heads * (lk * d), lk * d, d,
              lq, lk, heads};
}

}  // namespace

// All backward entry points (flash_bwd_dkv.cu's and flash_bwd_fused.cu's
// too) take the same arguments; each reads or writes only the pointers it
// names below and ignores the rest (pass null).
#define FLASH_BWD_PARAMS                                                          \
  const float *q, const float *k, const float *v, const uint8_t *mask,            \
      const float *o, const float *dout, const float *lse, const float *delta,    \
      float *dq, float *dk, float *dv, int batch, int lq, int lk, int heads,      \
      int head_dim, void *stream

// [B, L, H*D]; reads o (delta computed here), writes dq, dk, dv.
extern "C" int flash_bwd_ble(FLASH_BWD_PARAMS) {
  const Args a = ble_args(q, k, v, mask, o, dout, lse, nullptr, dq, dk, dv, lq, lk,
                          heads, head_dim);
  return dispatch<true, true, true>(a, head_dim, batch, static_cast<cudaStream_t>(stream));
}

// [B*H, L, D]; reads delta, writes dq.
extern "C" int flash_bwd_dq(FLASH_BWD_PARAMS) {
  const Args a = bhld_args(q, k, v, mask, nullptr, dout, lse, delta, dq, nullptr, nullptr,
                           lq, lk, heads, head_dim);
  return dispatch<true, false, false>(a, head_dim, batch, static_cast<cudaStream_t>(stream));
}
