// Masked flash-attention forward for Hopper (sm_90a), f32, projection layout.
//
// flash_fwd_ble replaces the Pallas TPU kernel `_fwd_kernel_ble`
// (gemm_gan_tpu/kernels/flash_attention.py:290), reached via flash_mha_ble:
// q, k, v [B, L, E = H*D]; head h is the column slice [h*D, (h+1)*D); o is
// written in the same layout, lse as [B, H, Lq] f32 (the TPU kernel
// broadcasts it across 128 lanes to satisfy its (8, 128) tiling, which
// nothing here needs). The classic layout's forward, flash_fwd_bhld, is in
// flash_fwd_bhld.cu.
//
// What it computes, per (batch, head, query row), with q already scaled:
//   s_j = q . k_j over the keys whose mask[b, j] is true (masked keys take
//   no part: the TPU's exp(-1e30 - m) is exactly 0 for them);
//   m = max_j s_j, l = sum_j exp(s_j - m);
//   o = sum_j exp(s_j - m) v_j / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//   A row with no valid key gets o = 0 and lse = -1e30, as on the TPU.
//
// What bounds it on an H100: the canonical patch self-attention
// (B=8, L=257, E=256, H=4) is ~0.54 GFLOP over ~8.4 MB per launch, far
// above the f32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so
// operations, not bytes, bound it.
//
// Design, simple and correct first: one block of 64 threads per (64-row q
// tile, head, batch). Each thread owns one query row and keeps q, acc[D], m
// and l in f32 registers. Tiles of k and v (64 rows for D <= 64, 32 rows for
// D = 128: 32 KB of shared memory either way) are staged in shared memory,
// where all threads read the same key at once (a broadcast, no bank
// conflicts). The online softmax rescales acc once per chunk of 16 keys.
// Ragged edges (Lq, Lk not multiples of a tile) are masked here, so the
// caller pads nothing. All arithmetic is f32 FMA on the CUDA cores, so the
// f32 peak of 67 TFLOP/s is this kernel's ceiling; flash_fwd_bhld.cu shows
// the tensor-core (3xTF32) design that would lift it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowsQ = 64;  // query rows per block = threads per block
constexpr int kChunk = 16;  // keys per online-softmax rescale

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // [B, Lk], nonzero = valid
  float* o;             // same layout as q
  float* lse;           // [B, H, Lq]
  int64_t q_sb, q_sh, q_sr;  // q and o: batch, head and row strides (floats)
  int64_t k_sb, k_sh, k_sr;  // k and v
  int lq, lk, heads;
};

template <int D>
__global__ void __launch_bounds__(kRowsQ) flash_fwd_kernel(const Args a) {
  constexpr int BK = D <= 64 ? 64 : 32;  // key rows per shared-memory tile
  constexpr int V4 = D / 4;              // float4 per row
  static_assert(BK % kChunk == 0, "a chunk never straddles two tiles");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ uint8_t valid[BK];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRowsQ + threadIdx.x;
  const bool live = row < a.lq;
  const int64_t q_off = b * a.q_sb + h * a.q_sh + static_cast<int64_t>(row) * a.q_sr;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.k_sb + h * a.k_sh;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;

  float q[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 x = live ? reinterpret_cast<const float4*>(a.q + q_off)[c]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    q[4 * c] = x.x;
    q[4 * c + 1] = x.y;
    q[4 * c + 2] = x.z;
    q[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < a.lk; k0 += BK) {
    const int n = min(BK, a.lk - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < n * V4; i += kRowsQ) {
      const int r = i / V4;
      const int c = i % V4;
      const int64_t off = static_cast<int64_t>(k0 + r) * a.k_sr;
      reinterpret_cast<float4*>(ks[r])[c] = reinterpret_cast<const float4*>(kb + off)[c];
      reinterpret_cast<float4*>(vs[r])[c] = reinterpret_cast<const float4*>(vb + off)[c];
    }
    for (int i = threadIdx.x; i < n; i += kRowsQ) valid[i] = mb[k0 + i];
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      // the mask is per batch, so every branch below is uniform in the block
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float dot = kNegInf;
        if (j < n && valid[j]) {
          dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(q[d], ks[j][d], dot);
        }
        s[c] = dot;
        m_new = fmaxf(m_new, dot);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      m = m_new;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j < n && valid[j]) {
          const float p = expf(s[c] - m);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        }
      }
    }
  }

  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
  const bool empty = m <= 0.5f * kNegInf;  // no valid key in this row
  float4* orow = reinterpret_cast<float4*>(a.o + q_off);
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    orow[c] = empty ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : make_float4(acc[4 * c] / lc, acc[4 * c + 1] / lc,
                                  acc[4 * c + 2] / lc, acc[4 * c + 3] / lc);
  }
  a.lse[(static_cast<int64_t>(b) * a.heads + h) * a.lq + row] = m + logf(lc);
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.lq + kRowsQ - 1) / kRowsQ, a.heads, batch);
  flash_fwd_kernel<D><<<grid, kRowsQ, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int head_dim, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 8: return launch<8>(a, batch, stream);
    case 16: return launch<16>(a, batch, stream);
    case 32: return launch<32>(a, batch, stream);
    case 64: return launch<64>(a, batch, stream);
    case 128: return launch<128>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* gemm_gan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v [B, L, H*D] (k, v with Lk rows); mask [B, Lk]; o like q; lse [B, H, Lq].
extern "C" int flash_fwd_ble(const float* q, const float* k, const float* v,
                             const uint8_t* mask, float* o, float* lse,
                             int batch, int lq, int lk, int heads, int head_dim,
                             void* stream) {
  const int64_t e = static_cast<int64_t>(heads) * head_dim;
  const Args a{q, k, v, mask, o, lse,
               lq * e, head_dim, e,
               lk * e, head_dim, e,
               lq, lk, heads};
  return dispatch(a, head_dim, batch, static_cast<cudaStream_t>(stream));
}
