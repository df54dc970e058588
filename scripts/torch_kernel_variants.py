"""Build variants of the port's tensor-core attention kernels, hold each
against its plain PyTorch version and time it, on the card.

    python3 scripts/torch_kernel_variants.py [--parent CSRC] [--lengths LQ:LK,...] [variant ...]

Needs one CUDA card (an H100: sm_90a) and nvcc. A variant is a copy of one
source under `gemm_gan_tpu_torch/kernels/csrc/` (with the headers there),
or, for the `*_parent` variants, under `--parent`: the `csrc/` directory of
another commit, unpacked beside the repository (for example with
`git archive <commit> gemm_gan_tpu_torch/kernels/csrc | tar -x -C DIR`), so
that the two trees are timed in one run on one card. Text substitutions
are applied to the copy, which its own nvcc compiles (all in parallel) into
a library under `gemm_gan_tpu_torch/kernels/build/variants/` (ignored by
git), called through ctypes with the entry point's usual arguments.

For each variant it prints ptxas' registers, spills and warnings at D = 64,
the dynamic shared memory and blocks per SM; then, at the entry point's
main path shape (whole-slide B 8, H 4, L 4,097, D 64 for flash_fwd_bhld,
flash_bwd_dq and flash_bwd_dkv; canonical B 8, H 4, L 257, D 64 for
flash_fwd_ble, flash_bwd_ble and flash_bwd_bhld_fused; each also in its
bf16 modes), the largest |kernel - plain version| of each
output on all-valid and ragged masks, and on the all-valid one the
kernel's time by CUDA events (20 launches after 3 warm-up) and its device
time by torch.profiler. The bf16 modes (`*_bf16`, and `*_mxu` on bf16
refs: their entry points get bf16_refs 1) take bf16 inputs and are held
to their plain versions under chip_smoke's gate: each output within
BF16_ULPS bf16 ulp of each row's largest entry ("gate ok" or "GATE
FAILED"; the timing splits `*_dkv_only` / `*_dq_only` leave one kind of
output unwritten and are not gated). The variants are timed in the order
given, and a name may be given more than once (parent, change, change,
parent). `--lengths` runs the bf16 modes at other lengths instead (each
Lq:Lk pair in turn), to separate a tile's fixed cost from its per-step one. With no name it runs every variant in VARIANTS (the `*_parent`
ones only with `--parent`). Exits non-zero if a gated variant misses the
gate. A measuring tool for tuning only: the port builds and calls the
sources as they are.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "gemm_gan_tpu_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "gemm_gan_tpu_torch", "kernels", "build", "variants")
# the fresh per-tile accumulators of tf32x3::weight_rows, undone: the
# product accumulates straight into acc, as the first version did
DIRECT = [("for (int n = 0; n < NC; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;",
           "for (int n = 0; n < NC; ++n) { part[n][0] = acc[n0 + n][0] * scale_lo; "
           "part[n][1] = acc[n0 + n][1] * scale_lo; part[n][2] = acc[n0 + n][2] * scale_hi; "
           "part[n][3] = acc[n0 + n][3] * scale_hi; }"),
          (re.compile(r"fmaf\(acc\[n0 \+ n\]\[(\d)\], scale_\w+, part\[n\]\[\d\]\)"),
           r"part[n][\1]")]
FAST_EXP = [(re.compile(r"\bexpf\("), "__expf(")]
# TF32 rounding by the cvt.rna.tf32.f32 instruction in place of
# tf32x3::to_tf32's integer arithmetic (the same results)
CVT_RNA = [("return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
            'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;')]
# lo passed on unrounded (the tensor cores read its top 19 bits: truncation)
LO_RAW = [("lo = to_tf32(x - __uint_as_float(hi));",
           "lo = __float_as_uint(x - __uint_as_float(hi));")]
NO_WARP_SKIP = [("if (__any_sync(0xffffffffu, key_ok[0] || key_ok[1])) {", "if (true) {")]
FWD_LB = "__launch_bounds__(kThreads)"
BLOCKS_3 = (FWD_LB, "__launch_bounds__(kThreads, 3)")  # Q4, Q5: at most 168 registers
DKV_BQ32 = ("kQueries = D <= 64 ? 64 : 32;", "kQueries = 32;")
# Q6 with 32-row tiles: 2 warps, and 32-query dk/dv tiles
FUSED_2_WARPS = ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")
FUSED_BQ = "kQueries = !kBle && D <= 64 ? 64 : 32;"  # Q6: 64 at D <= 64; Q2: 32
FUSED_BQ32 = (FUSED_BQ, "kQueries = 32;")
DQ_BK32 = ("kKeys = D <= 64 ? 64 : 32;", "kKeys = 32;")  # Q4's keys per streamed tile
HELD = "kHeld = D <= 64 ? 1 : 0;"  # Q4's operands held split in registers


# timing splits of the fused kernel: one kind of tile launched, the other's
# outputs left unwritten (NaN)
NO_DQ_TILES = ("const int n_dq = (a.lq", "const int n_dq = 0 * (a.lq")
NO_DKV_TILES = ("const int n_dkv = (a.lk", "const int n_dkv = 0 * (a.lk")
# the wgmma tile (flash_bwd_wg.cuh): 32 queries per dk/dv step, or no cap
# of 168 registers (3 blocks per SM)
WG_BQ32 = ("constexpr int kQueries = 64;", "constexpr int kQueries = 32;")
WG_NO_CAP = ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 1;")
# the step's products in one sub-step (64 queries of a dk/dv step, 64 keys
# of a dq step) instead of two of 32
WG_SUB64 = [("constexpr int kSubQueries = 32;", "constexpr int kSubQueries = 64;"),
            ("constexpr int kSubKeys = 32;", "constexpr int kSubKeys = 64;")]
# the dq tile's products in one sub-step of 64 keys
WG_SUBKEYS64 = ("constexpr int kSubKeys = 32;", "constexpr int kSubKeys = 64;")
# a sub-step's S^T and dP^T (S and dP) issued while the last sub-step's
# register-A products still run
WG_OVERLAP = [("        wgmma::commit();\n        wgmma::wait<0>();\n      }\n"
               "      wgmma::fence_operand(dv);",
               "        wgmma::commit();\n      }\n      wgmma::wait<0>();\n"
               "      wgmma::fence_operand(dv);"),
              ("      wgmma::commit();\n      wgmma::wait<0>();\n    }\n    wgmma::fence_operand(dq);",
               "      wgmma::commit();\n    }\n    wgmma::wait<0>();\n    wgmma::fence_operand(dq);")]
# exp(s - lse) under a select, as the mma.sync tiles take it: one divergent
# branch per element
WG_EXP_BRANCH = [("expf(live ? p[nt][e] - lse_t[qi] : kMinusInf)",
                  "(live ? expf(p[nt][e] - lse_t[qi]) : 0.f)"),
                 ("expf(ok[ks0 + 8 * nt + 2 * t + (e & 1)] ? s[nt][e] - lse[e >> 1] : kMinusInf)",
                  "(ok[ks0 + 8 * nt + 2 * t + (e & 1)] ? expf(s[nt][e] - lse[e >> 1]) : 0.f)")]
# Ablations of the wgmma tile, timing only (their results are wrong, and
# not gated): each takes one piece of work out of a step, so that its
# share of the step shows. exp: P = S - lse without the exp; proxy: no
# fence.proxy.async; rs: no register-A products; prefetch: the next step's
# tiles not loaded (the stale ones reused); in ble, delta: the dk/dv tile's
# per-step delta and its barrier left out; o: the step's O rows not staged.
ABLATIONS = {
    "exp": [("expf(live ? p[nt][e] - lse_t[qi] : kMinusInf)",
             "(live ? p[nt][e] - lse_t[qi] : 0.f)"),
            ("expf(ok[ks0 + 8 * nt + 2 * t + (e & 1)] ? s[nt][e] - lse[e >> 1] : kMinusInf)",
             "(ok[ks0 + 8 * nt + 2 * t + (e & 1)] ? s[nt][e] - lse[e >> 1] : 0.f)")],
    "proxy": [('asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', "")],
    "rs": [("for (int k = kTerms - 1; k >= 0; --k) wgmma::mma_rs<D>(acc, a[j][k], b);",
            "for (int k = kTerms - 1; k >= 0; --k) acc[0][0] += __uint_as_float(a[j][k][0]);")],
    "prefetch": [("      if (it + NS - 1 < n_steps) stage_step(it + NS - 1, (it + NS - 1) % NS);", ""),
                 ("    if (it + NS - 1 < n_steps) stage_step(it + NS - 1, nbuf);", "")],
}
# the header an ablation edits, where it is not flash_bwd_wg.cuh
ABLATION_FILES = {"proxy": "wgmma.cuh", "rs": "wg_tile.cuh"}
BLE_ABLATIONS = {
    "delta": [("        if (kBle && sub == 0) {  // the step's delta, while S^T and dP^T run",
               "        if (false) {")],
    "o": [("      if constexpr (kBle) stage<D, BQ>(os + buf * C::kQTile, a.o + q_base, q0, a.lq, stride);",
           "")],
}
# variant (a): the bf16 modes on the mma.sync tiles of flash_bwd_tc.cuh
# instead of the wgmma tile, their fragments loaded by ldmatrix
NO_WG = ("&& flash_bwd_wg::kTakes<D>;", "&& false;")
LDMATRIX = ("constexpr bool kLdmatrix = false;", "constexpr bool kLdmatrix = true;")
# (entry point, mode) -> the source of its bf16-mode entry points
BF16_SOURCES = {("flash_bwd_ble", "bf16"): "flash_bwd_bf16.cu",
                ("flash_bwd_ble", "mxu"): "flash_bwd_mxu.cu",
                ("flash_bwd_bhld_fused", "bf16"): "flash_bwd_bhld_bf16.cu",
                ("flash_bwd_bhld_fused", "mxu"): "flash_bwd_bhld_mxu.cu",
                ("flash_fwd_bhld", "bf16"): "flash_fwd_bhld_bf16.cu",
                ("flash_fwd_bhld", "mxu"): "flash_fwd_bhld_bf16.cu",
                ("flash_bwd_dkv", "bf16"): "flash_bwd_dkv_bf16.cu",
                ("flash_bwd_dkv", "mxu"): "flash_bwd_dkv_bf16.cu",
                ("flash_bwd_dq", "bf16"): "flash_bwd_dq_bf16.cu",
                ("flash_bwd_dq", "mxu"): "flash_bwd_dq_bf16.cu",
                ("flash_fwd_ble", "bf16"): "flash_fwd_bf16.cu",
                ("flash_fwd_ble", "mxu"): "flash_fwd_bf16.cu"}
# The classic layout's wgmma tiles of Q3 (flash_fwd_wg.cuh) and Q5 (the
# dk/dv tile of flash_bwd_wg.cuh), whole-slide: routed off (the mma.sync
# tiles, as the parent has them); a ring of 3 buffers; 64 keys per forward
# step (128 shipped); S in wgmmas of 64 keys (one of 128 shipped); under
# mxu_bf16 one pass per 256-key block (a step of 256 keys, its S in
# registers: 1 block per SM, as its 137 KB of shared memory allow); a
# persistent dk/dv grid (one block per resident slot walks the plain
# grid's (key tile, head, batch) items in order)
FWD_NO_WG = ("flash_fwd_wg::kTakes<D>;", "false;")
FWD_STAGES3 = ("constexpr int kStages = 2;", "constexpr int kStages = 3;")
FWD_KEYS = "constexpr int kKeys = 128;"
FWD_KEYS64 = (FWD_KEYS, "constexpr int kKeys = 64;")


def fwd_split_scores(keys: int) -> tuple:
    """S of a forward step in wgmmas of `keys` keys each."""
    return ("  wg_tile::issue_ss<D, 8 * NT>(s, q, k);  // one m64nNk16 per k16 step, N = the step's keys",
            f"#pragma unroll\n  for (int c = 0; c < NT / {keys // 8}; ++c) {{\n"
            f"    wg_tile::issue_ss<D, {keys}>(*reinterpret_cast<float(*)[{keys // 8}][4]>("
            f"s[{keys // 8} * c]), q, k + c * {keys} * 2 * D);\n  }}")


FWD_S64 = fwd_split_scores(64)
FWD_ONE_PASS = [(FWD_KEYS, "constexpr int kKeys = 256;"), fwd_split_scores(128), WG_NO_CAP]
DKV_STAGES3 = ("constexpr int kDkvStages = 2;", "constexpr int kDkvStages = 3;")
DKV_PERSISTENT = [
    ("""    flash_bwd_dkv_wg_kernel(const Args<Elem<kMode>> a) {
  extern __shared__ __align__(16) float smem[];
  flash_bwd_wg::dkv_tile<D, false, flash_ops::Ops<kMode, D>::kTerms>(
      a, blockIdx.x, blockIdx.y, blockIdx.z, flash_bwd_wg::aligned(smem));
}""", """    flash_bwd_dkv_wg_kernel(const Args<Elem<kMode>> a, int n_work) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (a.lk + flash_bwd_wg::R - 1) / flash_bwd_wg::R;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int bh = w / n_tiles;
    flash_bwd_wg::dkv_tile<D, false, flash_ops::Ops<kMode, D>::kTerms>(
        a, w % n_tiles, bh % a.heads, bh / a.heads, flash_bwd_wg::aligned(smem));
    __syncthreads();  // every warp is done with the tiles before the next item stages them
  }
}"""),
    ("""  const auto fn = kernel<D, kMode>();
  fn<<<grid, threads<D, kMode>(), smem_size<D, kMode>(), stream>>>(a);""",
     """  if constexpr (kWg<D, kMode>) {  // as many blocks as fit at once, at most one per item
    const int n_work = grid.x * grid.y * grid.z;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<D, kMode>(),
                                                        threads<D, kMode>(), smem_size<D, kMode>());
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto fn = kernel<D, kMode>();
    fn<<<n_work < sms * per_sm ? n_work : sms * per_sm, threads<D, kMode>(), smem_size<D, kMode>(),
         stream>>>(a, n_work);
  } else {
    const auto fn = kernel<D, kMode>();
    fn<<<grid, threads<D, kMode>(), smem_size<D, kMode>(), stream>>>(a);
  }"""),
]
# Q4's wgmma dq tile (flash_bwd_dq.cuh's kWgStages, kWgSubKeys; shipped:
# 64-key steps, one 64-key sub-step, a ring of 3), {file: substitutions}:
# 128-key steps (a ring of 2: 83 KB, 2 blocks per SM), in 64- or 32-key
# sub-steps; a ring of 2; 32-key sub-steps (the fused grids'); a ring of 2
# and 4 blocks per SM asked of __launch_bounds__ (at most 128 registers)
DQ_KEYS128 = ("constexpr int kKeys = 64;      // keys per streamed step of a dq tile",
              "constexpr int kKeys = 128;      // keys per streamed step of a dq tile")
DQ_SUB32 = ("constexpr int kWgSubKeys = 64;", "constexpr int kWgSubKeys = 32;")
DQ_STAGES2 = ("constexpr int kWgStages = 3;", "constexpr int kWgStages = 2;")
DQ_BLOCKS4 = ("__launch_bounds__(flash_bwd_wg::kThreads, flash_bwd_wg::kMinBlocks)\n"
              "    flash_bwd_dq_wg_kernel",
              "__launch_bounds__(flash_bwd_wg::kThreads, 4)\n    flash_bwd_dq_wg_kernel")
DQ_OPTIONS = {"keys128": {"flash_bwd_wg.cuh": [DQ_KEYS128], "flash_bwd_dq.cuh": [DQ_STAGES2]},
              "keys128_sub32": {"flash_bwd_wg.cuh": [DQ_KEYS128],
                                "flash_bwd_dq.cuh": [DQ_STAGES2, DQ_SUB32]},
              "stages2": {"flash_bwd_dq.cuh": [DQ_STAGES2]},
              "sub32": {"flash_bwd_dq.cuh": [DQ_SUB32]},
              "stages2_blocks4": {"flash_bwd_dq.cuh": [DQ_STAGES2, DQ_BLOCKS4]}}
# Q1 on the forward wgmma tile (shipped: both bf16-ref modes with 128-key
# steps and a ring of 3, flash_fwd.cuh's kWgStages; the mma.sync tile is
# `fwd_ble_{mode}_mma_sync`), {file: substitutions}: 64-key steps or a
# ring of 2
FWD_KEYS64_FILE = {"flash_fwd_wg.cuh": [FWD_KEYS64]}
BLE_STAGES2 = {"flash_fwd.cuh": [("constexpr int kWgStages = kBle ? 3 :",
                                  "constexpr int kWgStages = kBle ? 2 :")]}
BLE_OPTIONS = {mode: {"keys64": FWD_KEYS64_FILE, "stages2": BLE_STAGES2}
               for mode in ("bf16", "mxu")}
# Ablations of the forward tile, timing only (as ABLATIONS): exp: P = S - m
# without the exp; rs: no P.V products; prefetch: no step staged ahead;
# pass1 (mxu_bf16): no first pass over a key block (P rounded per step)
FWD_ABLATIONS = {
    "exp": [("sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);", "sc[nt][e] = sc[nt][e] - m[e >> 1];")],
    "rs": [("wg_tile::issue_rs<D, kTerms>(o, pa, v + c * 8 * NC * 2 * D);",
            "o[0][0] += __uint_as_float(pa[0][0][0]);")],
    "prefetch": [("    if (s + kStages - 1 < n_steps) stage_step(s + kStages - 1);\n", "")],
    "pass1": [("const bool two_pass = kRoundsP && bt > 1;", "const bool two_pass = false;")],
}


def held(n: int):
    return (HELD, f"kHeld = D <= 64 ? {n} : 0;")


def warps(n: int):  # warps per block of a source's kernel
    return ("constexpr int kWarps = 4;", f"constexpr int kWarps = {n};")


# name -> (tree: "new" or "parent", source, entry point,
#          {file under csrc/: substitutions})
VARIANTS = {
    # flash_fwd_bhld (Q3), whole-slide
    "fwd_parent": ("parent", "flash_fwd_bhld.cu", "flash_fwd_bhld", {}),
    "fwd": ("new", "flash_fwd.cu", "flash_fwd_bhld", {}),
    "fwd_direct_acc": ("new", "flash_fwd.cu", "flash_fwd_bhld", {"tf32x3.cuh": DIRECT}),
    "fwd_bk64": ("new", "flash_fwd.cu", "flash_fwd_bhld",
                 {"flash_fwd.cuh": [("int BK = 32;", "int BK = 64;")]}),
    "fwd_3_blocks": ("new", "flash_fwd.cu", "flash_fwd_bhld",
                     {"flash_fwd.cuh": [(FWD_LB, "__launch_bounds__(kThreads, 3)")]}),
    "fwd_q_raw": ("new", "flash_fwd.cu", "flash_fwd_bhld",
                  {"flash_ops.cuh": [("kQSplit = D <= 64;", "kQSplit = false;")]}),
    "fwd_fast_exp": ("new", "flash_fwd.cu", "flash_fwd_bhld", {"flash_fwd.cuh": FAST_EXP}),
    "fwd_cvt_rna": ("new", "flash_fwd.cu", "flash_fwd_bhld", {"tf32x3.cuh": CVT_RNA}),
    # flash_fwd_ble (Q1), canonical: blocks of 16 to 80 query rows
    **{f"ble_{16 * w}rows": ("new", "flash_fwd.cu", "flash_fwd_ble", {"flash_fwd.cuh": [warps(w)]})
       for w in (1, 2, 3, 4, 5)},
    "ble_bk64": ("new", "flash_fwd.cu", "flash_fwd_ble",
                 {"flash_fwd.cuh": [("int BK = 32;", "int BK = 64;")]}),
    "ble_fast_exp": ("new", "flash_fwd.cu", "flash_fwd_ble", {"flash_fwd.cuh": FAST_EXP}),
    "ble_cvt_rna": ("new", "flash_fwd.cu", "flash_fwd_ble", {"tf32x3.cuh": CVT_RNA}),
    "ble_lo_raw": ("new", "flash_fwd.cu", "flash_fwd_ble", {"tf32x3.cuh": LO_RAW}),
    # flash_bwd_dq (Q4), whole-slide: Q (1, shipped), Q and dO (2) or
    # neither (0) held split in registers; 64-key (shipped) or 32-key tiles;
    # 2, 4 or 8 warps; 3 blocks per SM
    "dq_parent": ("parent", "flash_bwd.cu", "flash_bwd_dq", {}),
    "dq": ("new", "flash_bwd_dq.cu", "flash_bwd_dq", {}),
    "dq_bk32": ("new", "flash_bwd_dq.cu", "flash_bwd_dq", {"flash_bwd_dq.cuh": [DQ_BK32]}),
    **{f"dq_held{n}": ("new", "flash_bwd_dq.cu", "flash_bwd_dq", {"flash_bwd_dq.cuh": [held(n)]})
       for n in (0, 2)},
    **{f"dq_held{n}_bk32": ("new", "flash_bwd_dq.cu", "flash_bwd_dq",
                            {"flash_bwd_dq.cuh": [held(n), DQ_BK32]}) for n in (0, 2)},
    **{f"dq_{w}_warps": ("new", "flash_bwd_dq.cu", "flash_bwd_dq", {"flash_bwd_dq.cuh": [warps(w)]})
       for w in (2, 8)},
    "dq_held0_bk32_2_warps": ("new", "flash_bwd_dq.cu", "flash_bwd_dq",
                              {"flash_bwd_dq.cuh": [held(0), DQ_BK32, warps(2)]}),
    "dq_bk32_3_blocks": ("new", "flash_bwd_dq.cu", "flash_bwd_dq",
                         {"flash_bwd_dq.cuh": [DQ_BK32, BLOCKS_3]}),
    "dq_held0_bk32_3_blocks": ("new", "flash_bwd_dq.cu", "flash_bwd_dq",
                               {"flash_bwd_dq.cuh": [held(0), DQ_BK32, BLOCKS_3]}),
    # flash_bwd_dkv (Q5), whole-slide
    "dkv_parent": ("parent", "flash_bwd_dkv.cu", "flash_bwd_dkv", {}),
    "dkv": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv", {}),
    "dkv_fast_exp": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv", {"flash_bwd_tc.cuh": FAST_EXP}),
    "dkv_direct_acc": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv", {"tf32x3.cuh": DIRECT}),
    "dkv_cvt_rna": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv", {"tf32x3.cuh": CVT_RNA}),
    "dkv_no_warp_skip": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv",
                         {"flash_bwd_tc.cuh": NO_WARP_SKIP}),
    "dkv_bq32": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv", {"flash_bwd_dkv.cuh": [DKV_BQ32]}),
    "dkv_bq32_3_blocks": ("new", "flash_bwd_dkv.cu", "flash_bwd_dkv",
                          {"flash_bwd_dkv.cuh": [DKV_BQ32, BLOCKS_3]}),
    # flash_bwd_ble (Q2), canonical: the ble instantiation of Q6's template,
    # 32-query dk/dv tiles (shipped) or 64; 32-row tiles (2 warps)
    "ble_bwd_parent": ("parent", "flash_bwd.cu", "flash_bwd_ble", {}),
    "ble_bwd": ("new", "flash_bwd_fused.cu", "flash_bwd_ble", {}),
    "ble_bwd_bq64": ("new", "flash_bwd_fused.cu", "flash_bwd_ble",
                     {"flash_bwd_fused.cuh": [(FUSED_BQ, "kQueries = D <= 64 ? 64 : 32;")]}),
    "ble_bwd_32rows": ("new", "flash_bwd_fused.cu", "flash_bwd_ble",
                       {"flash_bwd_fused.cuh": [FUSED_2_WARPS]}),
    # flash_bwd_bhld_fused (Q6), canonical: 64-row tiles (4 warps, dk/dv
    # tiles of 64 or 32 queries), 32-row tiles (2 warps, 32 queries)
    "fused_parent": ("parent", "flash_bwd_fused.cu", "flash_bwd_bhld_fused", {}),
    "fused": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused", {}),
    "fused_bq32": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                   {"flash_bwd_fused.cuh": [FUSED_BQ32]}),
    "fused_32rows": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                     {"flash_bwd_fused.cuh": [FUSED_2_WARPS, FUSED_BQ32]}),
    "fused_fast_exp": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                       {"flash_bwd_tc.cuh": FAST_EXP}),
    "fused_cvt_rna": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused", {"tf32x3.cuh": CVT_RNA}),
    "fused_lo_raw": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused", {"tf32x3.cuh": LO_RAW}),
    "fused_no_warp_skip": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                           {"flash_bwd_tc.cuh": NO_WARP_SKIP}),
    # timing splits
    "fused_dkv_only": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                       {"flash_bwd_fused.cuh": [NO_DQ_TILES]}),
    "fused_dq_only": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                      {"flash_bwd_fused.cuh": [NO_DKV_TILES]}),
    "fused_dq_bk64": ("new", "flash_bwd_fused.cu", "flash_bwd_bhld_fused",
                      {"flash_bwd_fused.cuh": [("constexpr int kKeys = 32;",
                                               "constexpr int kKeys = 64;")]}),
    # the bf16-ref modes of Q2 and Q6 on bf16 inputs: the wgmma tile of
    # flash_bwd_wg.cuh, and the parent's
    **{f"{prefix}_{mode}{suffix}": (tree, source, f"{entry}_{mode}", {})
       for prefix, entry in (("ble_bwd", "flash_bwd_ble"), ("fused", "flash_bwd_bhld_fused"))
       for mode in ("bf16", "mxu") for tree, suffix in (("new", ""), ("parent", "_parent"))
       for source in (BF16_SOURCES[entry, mode],)},
    # the wgmma tile's design choices, in both layouts and both modes:
    # 32-query dk/dv steps, no 3-blocks-per-SM register cap, one product
    # sub-step of 64 (in both tiles, or in the dq tile alone), __expf, exp
    # under a branch, a sub-step's products overlapping the next; timing
    # splits
    **{f"{prefix}_{mode}_{name}": ("new", BF16_SOURCES[entry, mode], f"{entry}_{mode}",
                                   {file: sub if isinstance(sub, list) else [sub]})
       for prefix, entry in (("ble_bwd", "flash_bwd_ble"), ("fused", "flash_bwd_bhld_fused"))
       for mode in ("bf16", "mxu")
       for name, file, sub in (("bq32", "flash_bwd_wg.cuh", WG_BQ32),
                               ("no_cap", "flash_bwd_wg.cuh", WG_NO_CAP),
                               ("sub64", "flash_bwd_wg.cuh", WG_SUB64),
                               ("subkeys64", "flash_bwd_wg.cuh", WG_SUBKEYS64),
                               ("fast_exp", "flash_bwd_wg.cuh", FAST_EXP),
                               ("exp_branch", "flash_bwd_wg.cuh", WG_EXP_BRANCH),
                               ("overlap", "flash_bwd_wg.cuh", WG_OVERLAP),
                               ("dkv_only", "flash_bwd_fused.cuh", NO_DQ_TILES),
                               ("dq_only", "flash_bwd_fused.cuh", NO_DKV_TILES))},
    # ablations of the wgmma tile's steps (timing only), one kind of tile
    **{f"fused_{mode}_{kind}_ablate_{name}": (
        "new", BF16_SOURCES["flash_bwd_bhld_fused", mode], f"flash_bwd_bhld_fused_{mode}",
        {"flash_bwd_fused.cuh": [NO_DQ_TILES if kind == "dkv" else NO_DKV_TILES],
         ABLATION_FILES.get(name, "flash_bwd_wg.cuh"): subs})
       for mode in ("bf16", "mxu") for kind in ("dkv", "dq") for name, subs in ABLATIONS.items()},
    **{f"ble_bwd_{mode}_dkv_ablate_{name}": (
        "new", BF16_SOURCES["flash_bwd_ble", mode], f"flash_bwd_ble_{mode}",
        {"flash_bwd_fused.cuh": [NO_DQ_TILES], "flash_bwd_wg.cuh": subs})
       for mode in ("bf16", "mxu") for name, subs in BLE_ABLATIONS.items()},
    # the classic layout's bf16-ref modes of Q3 and Q5 (bf16 inputs; mxu
    # with bf16 refs), whole-slide: the wgmma tiles, the parent's, the
    # mma.sync tiles of this tree, and the tiles' options
    **{f"{prefix}_{mode}{suffix}": (tree, BF16_SOURCES[entry, mode], f"{entry}_{mode}", subs)
       for prefix, entry, no_wg in (("fwd_bhld", "flash_fwd_bhld", {"flash_fwd.cuh": [FWD_NO_WG]}),
                                    ("dkv", "flash_bwd_dkv", {"flash_bwd_dkv.cuh": [NO_WG]}))
       for mode in ("bf16", "mxu")
       for tree, suffix, subs in (("new", "", {}), ("parent", "_parent", {}),
                                  ("new", "_mma_sync", no_wg))},
    **{f"fwd_bhld_{mode}_{name}": ("new", "flash_fwd_bhld_bf16.cu", f"flash_fwd_bhld_{mode}",
                                   {"flash_fwd_wg.cuh": sub if isinstance(sub, list) else [sub]})
       for mode in ("bf16", "mxu")
       for name, sub in (("stages3", FWD_STAGES3), ("keys64", FWD_KEYS64),
                         ("no_cap", WG_NO_CAP), ("fast_exp", FAST_EXP), ("s64", FWD_S64))},
    "fwd_bhld_mxu_one_pass": ("new", "flash_fwd_bhld_bf16.cu", "flash_fwd_bhld_mxu",
                              {"flash_fwd_wg.cuh": FWD_ONE_PASS}),
    **{f"fwd_bhld_{mode}_ablate_{name}": ("new", "flash_fwd_bhld_bf16.cu", f"flash_fwd_bhld_{mode}",
                                          {"flash_fwd_wg.cuh": subs})
       for mode in ("bf16", "mxu") for name, subs in FWD_ABLATIONS.items()
       if name != "pass1" or mode == "mxu"},
    **{f"dkv_{mode}_{name}": ("new", "flash_bwd_dkv_bf16.cu", f"flash_bwd_dkv_{mode}", subs)
       for mode in ("bf16", "mxu")
       for name, subs in (("stages3", {"flash_bwd_wg.cuh": [DKV_STAGES3]}),
                          ("persistent", {"flash_bwd_dkv.cuh": DKV_PERSISTENT}),
                          ("bq32", {"flash_bwd_wg.cuh": [WG_BQ32]}),
                          ("sub64", {"flash_bwd_wg.cuh": WG_SUB64}),
                          ("no_cap", {"flash_bwd_wg.cuh": [WG_NO_CAP]}),
                          ("fast_exp", {"flash_bwd_wg.cuh": FAST_EXP}))},
    **{f"dkv_{mode}_ablate_{name}": ("new", "flash_bwd_dkv_bf16.cu", f"flash_bwd_dkv_{mode}",
                                     {ABLATION_FILES.get(name, "flash_bwd_wg.cuh"): subs})
       for mode in ("bf16", "mxu") for name, subs in ABLATIONS.items()},
    # the bf16-ref modes of Q4 (whole-slide, the wgmma dq tile) and Q1
    # (canonical, the forward wgmma tile in the ble layout): the tiles, the
    # parent's, the mma.sync tiles of this tree, the tiles' options and
    # Q4's ablations (timing only)
    **{f"{prefix}_{mode}{suffix}": (tree, BF16_SOURCES[entry, mode], f"{entry}_{mode}", subs)
       for prefix, entry, no_wg in (("dq", "flash_bwd_dq", {"flash_bwd_dq.cuh": [NO_WG]}),
                                    ("fwd_ble", "flash_fwd_ble", {"flash_fwd.cuh": [FWD_NO_WG]}))
       for mode in ("bf16", "mxu")
       for tree, suffix, subs in (("new", "", {}), ("parent", "_parent", {}),
                                  ("new", "_mma_sync", no_wg))},
    **{f"dq_{mode}_{name}": ("new", "flash_bwd_dq_bf16.cu", f"flash_bwd_dq_{mode}", subs)
       for mode in ("bf16", "mxu") for name, subs in DQ_OPTIONS.items()},
    **{f"dq_{mode}_fast_exp": ("new", "flash_bwd_dq_bf16.cu", f"flash_bwd_dq_{mode}",
                               {"flash_bwd_wg.cuh": FAST_EXP}) for mode in ("bf16", "mxu")},
    **{f"dq_{mode}_ablate_{name}": ("new", "flash_bwd_dq_bf16.cu", f"flash_bwd_dq_{mode}",
                                    {ABLATION_FILES.get(name, "flash_bwd_wg.cuh"): subs})
       for mode in ("bf16", "mxu") for name, subs in ABLATIONS.items()},
    **{f"fwd_ble_{mode}_{name}": ("new", "flash_fwd_bf16.cu", f"flash_fwd_ble_{mode}", subs)
       for mode, options in BLE_OPTIONS.items() for name, subs in options.items()},
    # (a): the mma.sync tile as the parent has it, and with ldmatrix loads
    **{f"{prefix}_{mode}_{name}": ("new", BF16_SOURCES[entry, mode], f"{entry}_{mode}", subs)
       for prefix, entry in (("ble_bwd", "flash_bwd_ble"), ("fused", "flash_bwd_bhld_fused"))
       for mode in ("bf16", "mxu")
       for name, subs in (("mma_sync", {"flash_bwd_fused.cuh": [NO_WG]}),
                          ("ldmatrix", {"flash_bwd_fused.cuh": [NO_WG],
                                        "bf16mma.cuh": [LDMATRIX]}))},
}
_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# entry point -> (layout, B, H, L, D) of its main path
SHAPES = {"flash_fwd_bhld": ("bhld", 8, 4, 4097, 64), "flash_bwd_dq": ("bhld", 8, 4, 4097, 64),
          "flash_bwd_dkv": ("bhld", 8, 4, 4097, 64),
          "flash_fwd_ble": ("ble", 8, 4, 257, 64), "flash_bwd_ble": ("ble", 8, 4, 257, 64),
          "flash_bwd_bhld_fused": ("bhld", 8, 4, 257, 64)}
SHAPES.update({f"{entry}_{mode}": SHAPES[entry]
               for entry in ("flash_bwd_ble", "flash_bwd_bhld_fused", "flash_fwd_bhld", "flash_bwd_dkv",
                             "flash_bwd_dq", "flash_fwd_ble")
               for mode in ("bf16", "mxu")})
# which of (dq, dk, dv) a backward entry point writes
BWD_OUTPUTS = {"flash_bwd_dq": (0,), "flash_bwd_dkv": (1, 2)}
# ptxas' names for the parent's kernel templates that the sources renamed:
# flash_bwd.cu's <kDq, kDkv, kDeltaHere>, the fused kernel before it took a
# layout flag, and the classic forward's wgmma kernel before it took one
PARENT_PTXAS = {("flash_bwd_kernel", (1, 1, 1)): "flash_bwd_ble",
                ("flash_bwd_kernel", (1, 0, 0)): "flash_bwd_dq",
                ("flash_bwd_fused_kernel", ()): "flash_bwd_bhld_fused",
                ("flash_fwd_wg_kernel", (), 1): "flash_fwd_bhld_bf16",
                ("flash_fwd_wg_kernel", (), 3): "flash_fwd_bhld_mxu"}


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if isinstance(old, str):
            if old not in text:
                raise ValueError(f"substitution target not found: {old!r}")
            text = text.replace(old, new)
        else:
            text, n = old.subn(new, text)
            if not n:
                raise ValueError(f"substitution pattern not found: {old.pattern!r}")
    return text


def build(names, trees, entry_of, records):
    """Compile the variants in parallel; returns {name: (entry point fn,
    ptxas lines at D = 64, (smem bytes, blocks per SM) at D = 64)}.
    `entry_of(mangled)` gives ptxas' kernel name's (entry point, D),
    `records(log)` the (kernel, text) lines of ptxas' report."""
    procs = {}
    for name in names:
        tree, source, _, subs = VARIANTS[name]
        src_dir, vdir = trees[tree], os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        files = [n for n in os.listdir(src_dir) if n.endswith(".cuh")] + [source]
        if set(subs) - set(files):
            raise ValueError(f"{name}: substitutions for files it does not copy: {set(subs)}")
        for fname in files:
            with open(os.path.join(src_dir, fname)) as f:
                text = substitute(f.read(), subs.get(fname, []))
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             os.path.join(vdir, "lib.so"), os.path.join(vdir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        entry = VARIANTS[name][2]
        # the instantiation that entry launches at D = 64
        ptxas = [text for kernel, text in records(log) if text and entry_of(kernel) == (entry, 64)]
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        fn = getattr(lib, entry)
        fn.argtypes = ((_FWD_ARGS if entry.startswith("flash_fwd") else _BWD_ARGS)
                       + [ctypes.c_int] * entry.endswith("_mxu"))  # bf16_refs
        fn.restype = ctypes.c_int
        occ = getattr(lib, entry + "_occupancy", None)
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        if occ is not None:  # flash_bwd.cu's kernels had none
            occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            if occ(64, ctypes.byref(smem), ctypes.byref(blocks)):
                raise RuntimeError(f"{name}: occupancy query failed")
        built[name] = (fn, ptxas, (smem.value, blocks.value))
    return built


def is_bf16(entry: str) -> bool:
    """Whether `entry` is a bf16 mode (bf16 inputs; mxu with bf16 refs)."""
    return entry.endswith(("_bf16", "_mxu"))


def run_shape(cs, fa, torch, built, names, shape, stream, lengths=None) -> list:
    """Check and time the variants `names` (entry points of one shape and
    one input dtype) on all-valid and ragged inputs, at the shape's length
    or at `lengths` (Lq, Lk; bf16 modes only); returns the gated variants
    that missed the gate."""
    layout, B, H, L, D = shape
    Lq, Lk = lengths or (L, L)
    failed = []
    for ragged, seed in ((False, 200), (True, 26)):
        entry0 = VARIANTS[names[0]][2]
        if is_bf16(entry0):  # chip_smoke's inputs of the mode, and its plain version
            args = cs.bf16_args(fa, entry0, B, H, Lq, Lk, D, ragged, seed, torch.bfloat16)
            if entry0.startswith("flash_fwd"):
                q, k, v, mask = args[:4]  # (and H in the ble layout)
                o_in = do = delta = None
            elif layout == "ble":
                q, k, v, mask, o_in, plse, do, _ = args
                delta = None
            else:
                q, k, v, mask, do, plse, delta = args
                o_in = None
            want_of = {}
            for name in names:
                entry = VARIANTS[name][2]
                if entry not in want_of:
                    want_of[entry] = getattr(fa, entry + "_plain")(*args)
            po = None
            if entry0.startswith("flash_fwd"):
                plse = want_of[entry0][1]
        else:
            q, k, v, mask = cs.attention_inputs(layout, B, H, L, L, D, ragged, seed)
            g = torch.Generator(device="cuda").manual_seed(seed + 1000)
            do = torch.randn(q.shape, device="cuda", generator=g)
            if layout == "ble":  # the backward reads o; delta is computed in the kernel
                po, plse = fa.flash_fwd_ble_plain(q, k, v, mask, H)
                o_in, delta = po, None
                grads = fa.flash_bwd_ble_plain(q, k, v, mask, po, plse, do, H)
            else:
                po, plse = fa.flash_fwd_bhld_plain(q, k, v, mask)
                o_in, delta = None, (do * po).sum(-1)
                grads = fa.flash_bwd_bhld_fused_plain(q, k, v, mask, do, plse, delta)
            want_of = {VARIANTS[n][2]: grads for n in names}
        o, lse = torch.empty_like(q), torch.empty_like(plse)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        bwd_ptrs = [None if x is None else x.data_ptr()
                    for x in (q, k, v, mask, o_in, do, plse, delta, dq, dk, dv)]
        for name in names:
            fn, entry = built[name][0], VARIANTS[name][2]
            extra = (1,) if entry.endswith("_mxu") else ()  # bf16 refs
            if entry.startswith("flash_fwd"):
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731
                                  mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                  B, Lq, Lk, H, D, stream, *extra)
                outs, want = (o, lse), want_of[entry] if is_bf16(entry) else (po, plse)
            else:
                call = lambda: fn(*bwd_ptrs, B, Lq, Lk, H, D, stream, *extra)  # noqa: E731
                which = BWD_OUTPUTS.get(entry.removesuffix("_bf16").removesuffix("_mxu"), (0, 1, 2))
                outs = tuple((dq, dk, dv)[i] for i in which)
                # a bf16 mode's plain version returns what its kernel writes
                # (dq alone as a tensor)
                want = want_of[entry]
                want = ((want,) if isinstance(want, torch.Tensor) else tuple(want)) if is_bf16(entry) \
                    else tuple(want[i] for i in which)
            for x in outs:  # a variant that writes nothing must not pass
                x.fill_(float("nan"))
            if call():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(outs, want)]
            gate = ""
            if is_bf16(entry):
                if name.endswith(("_dkv_only", "_dq_only")) or "_ablate_" in name:
                    gate = "; timing split, not gated"
                else:
                    heads = H if layout == "ble" else 1
                    fwd = entry.startswith("flash_fwd")  # outs (o, lse): lse within LSE_ATOL
                    excess = max(cs.ulp_excess(a, b, heads) for a, b in zip(outs[:1] if fwd else outs,
                                                                           want))
                    if fwd:
                        excess = max(excess, errs[1] - cs.LSE_ATOL)
                    ok = excess <= 0
                    gate = (f"; gate ok (within {cs.BF16_ULPS} bf16 ulp of each row's largest "
                            f"entry)" if ok else f"; GATE FAILED (excess {excess:.3e})")
                    if not ok:
                        failed.append(name)
            ms = "" if ragged else (f"; {cs.cuda_ms(call):.4f} ms (events), "
                                    f"{cs.device_ms(call, iters=20):.4f} ms (device)")
            at = f" Lq {Lq} Lk {Lk}" if lengths else ""
            print(f"{'ragged' if ragged else 'full  '} {name}{at}: max|err| "
                  f"{' / '.join(f'{e:.3e}' for e in errs)}{gate}{ms}", flush=True)
        del q, k, v, mask, do, plse, o_in, delta, want_of, o, lse, dq, dk, dv, outs, want
        torch.cuda.empty_cache()
    return failed


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="csrc/ of another commit, for the *_parent variants")
    ap.add_argument("--lengths", type=lambda x: [tuple(map(int, p.split(":"))) for p in x.split(",")],
                    help="LQ:LK,... to run the bf16 modes at instead of their main path's L")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gemm_gan_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"new": CSRC, "parent": args.parent}
    order = args.variants or [n for n, v in VARIANTS.items()
                              if v[0] == "new" or args.parent]
    unknown = [n for n in order if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if any(VARIANTS[n][0] == "parent" for n in order) and not args.parent:
        raise SystemExit("the *_parent variants need --parent")
    print(f"card: {cs.card_line()}", flush=True)
    entries = {**cs.PTXAS_ENTRIES, **PARENT_PTXAS}
    built = build(list(dict.fromkeys(order)), trees, lambda m: cs.ptxas_entry(m, entries),
                  cs.ptxas_records)
    for name, (_, ptxas, (smem, blocks)) in built.items():
        print(f"{name}: D=64 {'; '.join(ptxas)}; {smem} bytes of shared memory, "
              f"{blocks} blocks per SM", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    for shape in dict.fromkeys(SHAPES.values()):
        for bf16 in (False, True):
            for fwd in (True, False):  # the bf16 modes' inputs differ between the two
                names = [n for n in order if SHAPES[VARIANTS[n][2]] == shape
                         and is_bf16(VARIANTS[n][2]) == bf16
                         and VARIANTS[n][2].startswith("flash_fwd") == fwd]
                if not names:
                    continue
                for lengths in (args.lengths if bf16 and args.lengths else [None]):
                    failed += run_shape(cs, fa, torch, built, names, shape, stream, lengths)
    if failed:
        print(f"variants that missed the gate: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
