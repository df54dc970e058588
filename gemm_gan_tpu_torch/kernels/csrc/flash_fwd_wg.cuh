// The attention forward's bf16-ref modes on Hopper's warpgroup MMA
// (wgmma.mma_async, wgmma.cuh), in either layout: flash_fwd_bhld_bf16
// (kBf16: P in three bf16 terms, f32-exact), flash_fwd_bhld_mxu and
// flash_fwd_ble_mxu on bf16 refs (kMxuBf16: P rounded once, per key block
// as F4 requires) at head dims 16, 32 and 64. They replace the Pallas TPU
// kernels `_fwd_kernel` (gemm_gan_tpu/kernels/flash_attention.py:84) and
// `_fwd_kernel_ble` (:290) in those modes; what they compute, the layouts,
// the masking rules and the key blocks of mxu_bf16 are flash_fwd.cuh's,
// whose mma.sync tile still serves the f32 modes, mxu_bf16 on f32 refs
// (cp.async cannot round f32 to bf16 as it stages), head dims 8 and 128,
// and flash_fwd_ble_bf16 (flash_fwd.cuh's kWg says why).
//
// What bounds it on an H100: at the whole-slide shape (B 8, H 4, L 4,097,
// D 64) a product (S or P.V) is 68.8 GFLOP; the bf16 mode takes 4 bf16
// passes (S once, P.V in three terms: 0.278 ms at 989 TFLOP/s), mxu_bf16 3
// (S twice, P.V once: 0.209 ms), against 17 MB of q, k, v, o (0.005 ms at
// 3.35 TB/s): operations. The mma.sync tile ran 5.6x (bf16) and 8.0x (mxu)
// that bound: a shared-memory load per tensor-core instruction, and under
// mxu_bf16 both passes over a key block on mma.sync. At the ble layout's
// canonical L 257 the bound is the bytes (0.0013 ms), far below one tile's
// chain of dependent steps.
//
// Design (one warpgroup of 4 warps per block, 64 query rows of one (batch,
// head); grid (ceil(Lq / 64), H, B), 2,080 blocks at the whole-slide shape,
// 160 at the canonical ble one):
//  * The layouts differ only in where a head's rows start and how far apart
//    they are (flash_bwd_tc::head_base, row_stride: the ble layout's rows
//    are H*D apart); lse is [B, H, Lq] in both.
//  * Q stays resident in shared memory; K and V tiles of kKeys = 128 keys
//    stream through a ring of kStages buffers (one K and one V tile each; a
//    template argument, flash_fwd.cuh's kWgStages), staged by cp.async in
//    wgmma's swizzled layout (wg_tile::stage), each thread fencing the
//    async proxy before the barrier that precedes the products.
//  * S = Q.K^T on wgmma with both operands in shared memory (K-major), one
//    m64n128k16 per k16 step; masked keys and keys >= Lk
//    become -1e30 by select, so exp(s - m) is 0 for them without a branch;
//    a row's max is reduced over its quad.
//  * O += P.V takes P from S's accumulators packed to bf16 (A from
//    registers: the accumulator layout is the A layout, wgmma.cuh) and V
//    from shared memory read MN-major, in sub-steps of 64 keys; in kBf16 P
//    goes in as three terms (wg_tile::a_terms). O stays in the wgmma
//    accumulators; o is rounded once at the store.
//  * The online softmax keeps m and l in f32 registers (l per thread,
//    summed over the quad at the end). A row with no valid key gets o = 0
//    and lse = -1e30; a step whose keys are all masked is skipped (the mask
//    is per batch, so the branch is uniform).
//  * mxu_bf16 (F4): a classic shape whose 128-padded Lk exceeds 512 rounds
//    P per block of kBlockK = 256 keys from key 0, else (and always in the
//    ble layout) in one block of all the keys. P = exp(s - the running max
//    at the block's end) is rounded once and l sums the unrounded p. A
//    block of more than one tile is taken twice: first its K alone,
//    kPass1Tiles = 2 tiles a step (a buffer's K and V rows hold 256 keys
//    of K), for each row's max over the block, then o and l rescaled
//    to the new running max; then its tiles' K and V, P with no rescale. A
//    block of one tile is the online softmax's step. Every step, of either
//    pass, goes through the same ring, so the next one is in flight across
//    block and pass boundaries.
//  * Each step's products are waited for at once (no A registers in flight
//    past other products: ptxas serialized every wgmma of the backward
//    tile when they were, C7512). __launch_bounds__ asks for kMinBlocks
//    blocks per SM, the three-term P's registers included.
// The step sizes were measured (scripts/torch_kernel_variants.py, PERF.md):
// the step's fixed cost (barrier, waits, the dependent product chain)
// weighs more than its products, so 128-key steps beat 64-key ones at
// L 4,097 (both modes) and under mxu_bf16 at L 257 (in the bf16 mode 64-key
// steps won there); a ring of 3 buffers helps the ble mxu_bf16 mode at
// L 257 (its 108 KB leave 2 blocks per SM, which the 160-block grid fills)
// and slows the classic one at L 4,097; a first pass of 256 keys a step
// beat one of a tile a step, and S in one m64n128k16 per k16 step beat two
// m64n64k16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "wg_tile.cuh"
#include "wgmma.cuh"

namespace flash_fwd_wg {

using bf16 = __nv_bfloat16;
using wg_tile::kTakes;    // the head dims the tile takes
using wg_tile::kThreads;  // one warpgroup
using wg_tile::R;         // query rows per block: wgmma's M
constexpr int kKeys = 128;     // keys per streamed step
constexpr int kStages = 2;     // buffers of the ring, each a K and a V tile (unless a kernel asks)
constexpr int kMinBlocks = 3;  // blocks per SM that __launch_bounds__ asks for
constexpr int kBlockK = 256;   // keys per block of JAX's classic forward under mxu_bf16 (long Lk)
constexpr int kSubKeys = 64;   // keys per P.V sub-step
constexpr int kPass1Tiles = 2;  // key tiles per first-pass step: K in a buffer's K and V rows

static_assert(kBlockK % kKeys == 0 && kKeys % kSubKeys == 0,
              "a key block is whole steps, a step whole sub-steps");
constexpr int kStageKeys = kPass1Tiles * kKeys;  // keys a buffer's flags cover
constexpr int kFlags = (kStageKeys + kThreads - 1) / kThreads;  // keys' valid flags per thread

// the tile's shared memory with a ring of NS buffers
template <int D, int NS = kStages>
struct Cfg {
  static constexpr int kQ = R * D * 2;       // bytes of the resident Q tile
  static constexpr int kKV = kKeys * D * 2;  // bytes of a K or V tile
  // Q; (K, V) x NS; valid flags x NS; room for the 1,024-byte boundary
  static constexpr int SMEM = kQ + NS * (2 * kKV + kStageKeys) + 1024;
};

// o += P.V over a [8 NT, D] V tile, P the f32 accumulator p taken as kTerms
// bf16 terms, in sub-steps of kSubKeys keys, each waited for at once
template <int D, int kTerms, int NT>
__device__ __forceinline__ void weigh(float (&o)[D / 8][4], const float (&p)[NT][4],
                                      const uint8_t* v) {
  constexpr int NC = kSubKeys / 8;  // n8 tiles of a sub-step
#pragma unroll
  for (int c = 0; c < NT / NC; ++c) {
    uint32_t pa[NC / 2][kTerms][4];
    wg_tile::a_terms<kTerms>(pa, *reinterpret_cast<const float(*)[NC][4]>(p[NC * c]));
    wgmma::fence();
    wg_tile::issue_rs<D, kTerms>(o, pa, v + c * 8 * NC * 2 * D);
    wgmma::commit();
    wgmma::wait<0>();
  }
  wgmma::fence_operand(o);
}

// S = Q.K^T of one step's keys, waited for; masked keys (valid flag 0) and
// keys >= Lk become -1e30 by select. Element e of n-tile nt is row
// 16 warp + g + 8 (e >> 1), key 8 nt + 2t + (e & 1) of the tile.
template <int D, int NT>
__device__ __forceinline__ void masked_scores(float (&s)[NT][4], const uint8_t* q,
                                              const uint8_t* k, const uint8_t* ok, int t) {
  wgmma::fence();
  wg_tile::issue_ss<D, 8 * NT>(s, q, k);  // one m64nNk16 per k16 step, N = the step's keys
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(s);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ok[8 * nt + 2 * t + (e & 1)] ? s[nt][e] : tf32x3::kNegInf;
    }
  }
}

// o, lse for query rows [qt * 64, qt * 64 + 64) of (batch b, head h) in the
// classic layout or (kBle) the [B, L, H*D] one, through a ring of kStages
// buffers; A is flash_fwd.cuh's Args<bf16>
template <int D, int kTerms, bool kRoundsP, bool kBle, int kStages, class A>
__device__ __forceinline__ void tile(const A& a, int qt, int h, int b, uint8_t* smem) {
  using C = Cfg<D, kStages>;
  using tf32x3::kNegInf;
  constexpr int NT = kKeys / 8;  // n8 tiles of a step's S
  constexpr int DT = D / 8;      // n8 tiles of O
  uint8_t* qs = smem;                         // [64, D]
  uint8_t* ring = qs + C::kQ;                 // [kStages][K, V: kKeys, D]
  uint8_t* valid = ring + kStages * 2 * C::kKV;  // [kStages][kStageKeys]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  // where (b, h)'s rows start and how far apart they are, in elements
  const int64_t stride = flash_bwd_tc::row_stride<D, kBle>(a.heads);
  const int64_t q_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lq);
  const int64_t k_base = flash_bwd_tc::head_base<D, kBle>(b, h, a.heads, a.lk);
  const bf16* kb = a.k + k_base;
  const bf16* vb = a.v + k_base;
  const uint8_t* mb = a.mask + static_cast<int64_t>(b) * a.lk;
  const int q0 = qt * R;

  // The steps: every key tile once (the online softmax), or under mxu_bf16
  // with key blocks of more than one tile, each block twice: first its K
  // alone, kPass1Tiles tiles a step, then its tiles' K and V. The ble
  // kernel rounds P in one block of every key.
  const int n_tiles = (a.lk + kKeys - 1) / kKeys;
  const int bt =
      kRoundsP && !kBle && (a.lk + 127) / 128 * 128 > 512 ? kBlockK / kKeys : n_tiles;
  const bool two_pass = kRoundsP && bt > 1;
  auto first_steps = [](int len) { return (len + kPass1Tiles - 1) / kPass1Tiles; };
  const int n_blocks = (n_tiles + bt - 1) / bt;
  const int last = n_tiles - (n_blocks - 1) * bt;  // tiles of the last block
  const int n_steps = !two_pass ? n_tiles
                                : (n_blocks - 1) * (first_steps(bt) + bt) + first_steps(last) + last;
  // step s: its first key tile and number of tiles; whether it takes V (P.V)
  auto step_of = [&](int s, int& tile, int& n) {
    n = 1;
    if (!two_pass) {
      tile = s;
      return true;
    }
    const int blk = s / (first_steps(bt) + bt), r = s % (first_steps(bt) + bt);
    const int len = min(bt, n_tiles - blk * bt), n1 = first_steps(len);
    if (r < n1) {
      tile = blk * bt + kPass1Tiles * r;
      n = min(kPass1Tiles, len - kPass1Tiles * r);
      return false;
    }
    tile = blk * bt + r - n1;
    return true;
  };
  auto stage_step = [&](int s) {
    uint8_t* st = ring + (s % kStages) * 2 * C::kKV;
    int tile, n;
    if (step_of(s, tile, n)) {
      wg_tile::stage<D, kKeys>(st, kb, tile * kKeys, a.lk, stride);
      wg_tile::stage<D, kKeys>(st + C::kKV, vb, tile * kKeys, a.lk, stride);
    } else {  // K of n tiles, in the buffer's K and V rows; rows past them zero-filled
      wg_tile::stage<D, kStageKeys>(st, kb, tile * kKeys, min(a.lk, (tile + n) * kKeys), stride);
    }
  };
  // the valid flags of step s's keys tid + kThreads j (0 past its tiles)
  auto flags = [&](int s, uint8_t (&f)[kFlags]) {
    int tile, n;
    step_of(s, tile, n);
#pragma unroll
    for (int j = 0; j < kFlags; ++j) {
      const int i = tid + kThreads * j, k = tile * kKeys + i;
      f[j] = i < n * kKeys && k < a.lk ? mb[k] : 0;
    }
  };

  wg_tile::stage<D, R>(qs, a.q + q_base, q0, a.lq, stride);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) stage_step(s);
    tf32x3::cp_async_commit();
  }
  uint8_t mv[kFlags];  // the next step's flags
  flags(0, mv);

  float o[DT][4];
  tf32x3::zero(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  float bm[2] = {kNegInf, kNegInf};  // first pass: this thread's part of the block's row max

  for (int s = 0; s < n_steps; ++s) {
    const int buf = s % kStages;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < kFlags; ++j) {
      const int i = tid + kThreads * j;
      if (i < kStageKeys) valid[buf * kStageKeys + i] = mv[j];
      mine |= mv[j] != 0;
    }
    if (s + kStages - 1 < n_steps) stage_step(s + kStages - 1);
    tf32x3::cp_async_commit();
    if (s + 1 < n_steps) flags(s + 1, mv);
    int tile, n;
    const bool pv = step_of(s, tile, n);
    if (two_pass && pv && tile % bt == 0) {
      // the block's first P.V step: its row max is known; o and l rescaled
      // to the new running max, which P of the whole block is taken from
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mx = fmaxf(m[i], tf32x3::quad_max(bm[i]));
        const float alpha = expf(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha;
        bm[i] = kNegInf;
#pragma unroll
        for (int n8 = 0; n8 < DT; ++n8) {
          o[n8][2 * i] *= alpha;
          o[n8][2 * i + 1] *= alpha;
        }
      }
    }
    tf32x3::cp_async_wait<kStages - 1>();  // step s has landed (this thread's copies)
    wgmma::fence_proxy_async();
    if (!__syncthreads_or(mine)) continue;  // every key of the step is masked

    const uint8_t* kt = ring + buf * 2 * C::kKV;
    const uint8_t* ok = valid + buf * kStageKeys;
    float sc[NT][4];
    if (!pv) {  // the first pass over a block: its row max only, kKeys keys at a time
#pragma unroll
      for (int i = 0; i < kPass1Tiles; ++i) {
        if (i >= n) break;
        masked_scores<D>(sc, qs, kt + i * C::kKV, ok + i * kKeys, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          bm[0] = fmaxf(bm[0], fmaxf(sc[nt][0], sc[nt][1]));
          bm[1] = fmaxf(bm[1], fmaxf(sc[nt][2], sc[nt][3]));
        }
      }
      __syncthreads();  // every warp is done with buf before it is refilled
      continue;
    }
    masked_scores<D>(sc, qs, kt, ok, t);
    if (!two_pass) {  // the online softmax: the running max over this step too
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = tf32x3::quad_max(mx[i]);
        const float alpha = expf(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha;
#pragma unroll
        for (int n8 = 0; n8 < DT; ++n8) {
          o[n8][2 * i] *= alpha;
          o[n8][2 * i + 1] *= alpha;
        }
      }
    }
    // P = exp(S - m): masked keys exp(-1e30 - m) = 0 (m is finite: the
    // step has a valid key)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += sc[nt][e];
      }
    }
    weigh<D, kTerms>(o, sc, kt + C::kKV);
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(tf32x3::quad_sum(l[i]), 1e-30f);
    const bool empty = m[i] <= 0.5f * kNegInf;  // no valid key in this row
    const int r = q0 + 16 * warp + g + 8 * i;
    if (r >= a.lq) continue;
    bf16* orow = a.o + q_base + r * stride + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < DT; ++n8) {
      bf16mma::store_pair(orow + 8 * n8, empty ? 0.f : o[n8][2 * i] / lc,
                          empty ? 0.f : o[n8][2 * i + 1] / lc);
    }
    if (t == 0) a.lse[bh * a.lq + r] = m[i] + logf(lc);
  }
}

}  // namespace flash_fwd_wg
