"""On-card smoke run of the PyTorch / CUDA port (`gemm_gan_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of the JAX package. Phases:

1. Build the CUDA kernels from `gemm_gan_tpu_torch/kernels/csrc/` (one nvcc
   per source, in parallel, into the ignored build dir) and print the build
   time, nvcc's register/spill/shared-memory report and ptxas' advice
   (such as wgmma serialized) for every kernel and head dim and product
   mode (a kernel template it cannot name raises),
   every kernel's dynamic shared memory and blocks per SM (all eighteen
   (kernel, mode) entry points run on the tensor cores), the tile each
   kernel's main path runs (TILES, held to the report), and the card's name
   and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it plus ragged and
   fully-masked cases and D 8 / 128, and time kernel, plain version and the
   library's `scaled_dot_product_attention` (forward, or its backward
   through `torch.autograd.grad`; a yardstick only: the port never calls
   it) by CUDA events, kernel and library also by their device time
   (torch.profiler), with the names of the CUDA kernels the library ran.
   The bf16 modes of every kernel (`<kernel>_bf16` and `<kernel>_mxu`;
   mxu_bf16 on bf16 and on f32 inputs; Q3-Q5 at the whole-slide shape, Q1,
   Q2, Q6 at L 257, and ragged, fully-masked, D 8 / 128 and, for the
   classic layout, Lk 600 cases; their bf16-ref modes all run wgmma tiles:
   Q1, Q2 and Q6 also at L 512, Lq 300 against Lk 257 and D 16 / 32, Q3-Q5
   also at Lk 600 with D 16 / 32 and at B 8, L 1,100 (more than one wave),
   each of the six its main path shape three times: BF16_SHAPES) are held
   to their plain
   versions within BF16_ULPS bf16 ulp of each row's largest entry (each
   side rounds once from f32), lse within LSE_ATOL, and timed on bf16
   inputs against the library's bf16 SDPA. Every mode of Q1 / Q2 is also
   held at token cross-attention's Lq 300 x Lk 300 with a ragged key mask,
   and of Q3 / Q4 / Q5 at its whole-slide Lq 300 x Lk 4,097
   (XATTN_TOKENS_SHAPE, XATTN_WHOLE_SLIDE_SHAPE; Q5's mxu_bf16 mode there,
   where a rounded dS or P summed over only 300 queries can move an output
   by more than one ulp, under the per-entry bound of `rounded_operand_bound`
   instead (ROUNDED_OPERAND_GATED), with a negative control: its dk scaled
   by 1 + 2^-5 must fail it).
3. Serving, the main path: `GeneratorServer.sample_all` with the flagship
   `film_cross_attention` generator at canonical widths (random weights from
   a seeded numpy tree in Flax layout, carried over by `convert.py`),
   4 batches of 8 with 256 x 1024 patches and 300 x 768 tokens, 2 repeats.
   Checks shape and finiteness, that the patch self-attention went through
   `flash_fwd_ble` 2 layers x 4 batches times, and one batch against the same
   server on the CPU.
4. Whole-slide serving (4,096 patches per sample, batch 8): the patch
   self-attention goes through `flash_fwd_bhld`; one batch against the same
   weights with `fusion.use_pallas=False` (the blocked reference), both on
   the card.
5. Training, the main path: `WGANGPEngine.step` of the flagship at canonical
   widths with `cond_embed_reuse="per_update"` and `batched_scores` (the
   production setting), batch 8, n_critic 5, clipping D <= 10 / G <= 2,
   dropout 0.1, both nets from seeded Flax-layout trees. One warm-up step,
   then TRAIN_STEPS timed steps; checks finite metrics, that the params
   moved, and the per-step launches of `flash_fwd_ble` and `flash_bwd_ble`;
   one dropout-free step on the card against the same step on the CPU,
   beside the same step with `fusion.use_pallas=False` on the card against
   the CPU (its count of params beyond atol printed, not gated: how far
   cuBLAS's f32 alone lands), and phase 9 (b)'s gradient gate
   (`grad_gate`) at that step's starting params in f32, with its two
   negative controls on `flash_fwd_ble` (their ratios printed); a
   CUDA-event split of one step.
6. Whole-slide training (4,096 patches, batch 8): `flash_fwd_bhld`,
   `flash_bwd_dq` and `flash_bwd_dkv`; one dropout-free step against the
   same step with `fusion.use_pallas=False`, both on the card, gated by
   how far the kernels' plain versions on the card land from the same.
7. Canonical training with `fusion.flash_layout="bhld"`: `flash_fwd_bhld`
   and `flash_bwd_bhld_fused`; one dropout-free step against the same step
   with `fusion.use_pallas=False`, both on the card, gated as in phase 6.
8. The epoch loop, the production path: a `DeviceCache` bank on the card
   (1,024 cases of 512 ragged patch slots x 1024 and 300 ragged tokens x
   768, in bf16, subsampled to 256 patches per step; a TCGA cohort is about
   10k cases: only depth is cut, to keep the bank's making short) and the
   phase-5 model (dropout 0.1) trained through `step_many_cached`, one CUDA
   graph of the fused step replayed K times. (a) A 4-step epoch of 32 cases
   through `step_many_cached` against the same 4 steps run eagerly over
   `cache.epoch(e)` from the same state and seeds (bitwise equality
   printed; gated by `step_diff`); (d) `step_many` on the same epoch
   stacked, under the same gate; a `fusion.remat_layers=True` epoch the
   same way; (b) two full epochs of 128 steps on the bank: finite metrics,
   moved params, graphed steps/s by the host clock beside phase 5's eager
   steps/s; (c) launches of Q1 and Q2 equal the replays (and the eager
   warm-up step) times `step_launches`, and one replay records exactly
   `step_launches`. Prints the device busy share of replayed steps
   (torch.profiler), the bank's bytes, the graph pool's and the phase's
   peak memory.
9. The bench configuration: phase 5's model and settings with
   `compute_dtype="bfloat16"` (the JAX package's production preset). (a)
   Canonical serving through `sample_all` (Q1's bf16 mode, launches
   checked), one batch card vs CPU within BF16_E2E_TOL of the output's
   largest entry, printed beside `use_pallas=False` on the card vs the CPU.
   (b) The bf16 step against the CPU, with the kernels' plain versions on
   the card as the yardstick (`plain_kernels`): first the gradient gate
   (`grad_gate`): at the step's starting params, dropout 0, the gradients
   of each net's fusion's params under the cotangent that the critic loss
   (with its penalty) or the generator loss gives the fusion's output on
   the CPU, each param's ||g - g_cpu|| / ||g_cpu|| at most
   PLAIN_LOOSE_FACTOR times the plain versions' (or GRAD_GATE_FLOOR), and
   the gate must reject both negative controls, Q1's output scaled by
   1 + 2^-5 and Q1 with the last valid key of every row masked out; then
   one dropout-free step: each
   net may miss PARAM_ATOL on at most PLAIN_LOOSE_FACTOR times as many
   entries (or MAX_LOOSE) as the plain versions' step, each metric within
   `bf16_metric_tol` of the CPU's with that step as the yardstick; the
   same kernel step with cuBLAS's reduced-precision bf16 reductions off is
   printed beside it. (c) A
   4-step graphed epoch from phase 8's small cache against eager steps
   (bitwise equality printed, `step_diff` gated), then a 128-step graphed
   epoch of phase 8's bank: steps/s and the replays' busy share, device
   events and top kernels beside phase 8's f32 figures, launches 16 Q1 and
   12 Q2 per step in the bf16 mode and no other kernel. (d) (a) and (b)
   with `fusion.flash_mxu_bf16=True`. (e) A canonical bf16
   `flash_layout="bhld"` step: 16 Q3 and 12 Q6 launches in the bf16 mode
   and no other, one dropout-free step against `use_pallas=False` on the
   card (`relative_step_gate` in bf16: params as phase 7, each metric
   within PLAIN_LOOSE_FACTOR times the plain versions' distance or
   BF16_STEP_RTOL of its value). (f) Whole-slide bf16 serving (Q3's bf16
   mode), one batch against `use_pallas=False` on the card within
   BF16_E2E_TOL. (g) Whole-slide bf16 training: 16 / 12 / 12 launches of
   Q3 / Q4 / Q5 in the bf16 mode per step, steps/s beside phase 6's f32,
   one dropout-free step against `use_pallas=False` as (e). (h) (f), (g)
   and (e) with `flash_mxu_bf16=True` (the `_mxu` kernels). (i)
   `train.grad_accum=2`: a whole-slide bf16 step at batch 16 (finite,
   params moved, launches by `step_launches`, peak memory beside (g)'s
   batch of 8); one dropout-free canonical f32 step against
   `grad_accum=1` under phase 5's gate; a 4-step epoch of phase 8's small
   cache graphed against eager steps under `step_diff`. (j) The graphed
   whole-slide epoch: a `DeviceCache` bank of WS_BANK_CASES whole slides
   (WS_BANK_SLOTS ragged patch slots, bf16 store, 2.5 GB) subsampled to
   WHOLE_SLIDE_PATCHES a step, through `step_many_cached` in bf16 and
   under mxu_bf16: a 4-step epoch against eager steps (bitwise equality
   printed, `step_diff` gated) and its replays' device time, then two
   32-step epochs, graphed steps/s beside (g)'s / (h)'s eager steps/s and
   device time, Q3 / Q4 / Q5 launches per replay (16 / 12 / 12) and no
   other kernel.
   Every step-level device time (`device_busy`, `replay_busy`) is read
   until a whole profile records the same work as the last whole one
   (`agreed_profile`; whole: it kept one or more of the sentinel kernels
   that open each profiler window, `profiled`), and prints how many
   readings it took.
10. The product path, `python -m gemm_gan_tpu_torch.cli.train` (`main`)
   with the product run's settings (`scripts/quality_experiment.py`:
   `film_cross_attention` f32, per_update, drift 1e-3, EMA 0.999, on-device
   validation every epoch capped at 1,024 cases, a checkpoint at each, bf16
   bank store), 4 epochs and one test run, on a TCGA layout it writes to a
   temporary directory: 768 cases of `structured_dataset` at the published
   widths (18,868 genes, 256 x 1024 patches, 300 x 768 tokens; only the case
   count is cut), split 491 / 122 / 155 by `load_tcga`. Gates: Q1 / Q2
   launches over `fit` equal `step_launches` per graphed step plus
   `num_layers` Q1 per generation batch, no other kernel; every logged,
   validation and test metric and the final state finite; `best.json`'s
   checkpoint exists and `--evaluate_only --evaluate_which best` restores
   exactly its step; `--evaluate_only` (last) regenerates the test block's
   dumps bitwise equal to fit's; and on 128 of the cases, 2 epochs then
   `--resume` to 4 end in a checkpoint bitwise equal to 4 straight epochs
   (a new graph captured after the restore; the runs validate at different
   epochs). Prints the seconds of each part (load, fit, graphed epochs,
   validations, checkpoint saves with their bytes and restores, the test
   block's LR / MLP / RF / two-sample logistic regression / PCA / PRDC / Γ,
   evaluate, the post-hoc suites), graphed steps/s inside `fit`, and
   whether scikit-learn and matplotlib are importable.
11. The paper's other variants (VARIANTS: concat_text, concat_image,
   attention, img_transformer, film, cross_attention and the benchmark
   label oracle) at the published widths (18,868 genes, 256 x 1024
   patches, 300 x 768 tokens with ragged masks, a 768-d text CLS vector,
   cond_dim 256, 4 heads, ff 512, 2 layers; seeded random Flax-layout
   weights through `convert.py`): (a) `sample_all`, 4 batches of 8, one
   batch card vs CPU within E2E_RTOL / E2E_ATOL, Q1 launches per batch by
   `kernel_attentions` (0 for concat, attention and the labels; 2 for
   img_transformer and film; 4 for cross_attention: its text queries over
   the patches and over the ragged tokens reach Q1 too); (b) one
   dropout-free f32 step card vs CPU, its metrics and RMSprop's bound held
   as phase 5 (its count of params beyond PARAM_ATOL printed beside the
   plain versions', not held: it is chaotic), launches by `step_launches`,
   and for img_transformer, film and cross_attention `attention_gate`:
   each kernel attention's output and q / k / v gradients under a fixed
   cotangent, on the inputs the CPU forward gives it, card kernels vs
   CPU within PLAIN_LOOSE_FACTOR times the plain versions' distance on
   the card (or ATTN_GATE_FLOOR), rejecting Q1's output scaled by
   ATTN_CONTROL_SCALE and Q1 with the last valid key of every row masked;
   (c) a graphed epoch from a `DeviceCache` of what the
   variant reads: 4 graphed steps against 4 eager ones, then 32-step
   epochs, steps/s, busy share and launches per replay. (d)
   cross_attention in the bench configuration: serving and phase 9 (b)'s
   gates in bf16 and under mxu_bf16, and at 4,096 patches a bf16 serving
   batch against `use_pallas=False` and a step through
   `relative_step_gate` with its Q3 / Q4 / Q5 (and Q1 / Q2) launches. (e)
   `cli.train --variant cross_attention` and `--variant film`, 2 epochs on
   phase 10's 128-case layout (which carries the text-CLS table the
   multi_patch schema reads), one test run: finite metrics, `best.json`,
   launches as `product_launches` counts them.
12. The post-hoc evaluator, `python -m gemm_gan_tpu_torch.cli.evaluate`
   (`main`), over phase 10's product run directory (`--epoch auto`: the
   dumps of best.json's epoch, test 155 and train 491 cases x 18,868
   genes; the utility suites on): every number finite, the exact 1- /
   2-Wasserstein against scipy's assignment over a float64 cost built on
   the host (OT_RTOL), the linear / polynomial MMD against numpy in float64
   (POSTHOC_MMD_RTOL), DCR / NNDR equal `Experiment.posthoc_privacy`'s,
   `PrivacyEvaluator` over the run finite, `--plots` without matplotlib
   raising; the seconds of each part (utility, Γ, the cost matrix, OT,
   MMD, privacy) and Sinkhorn's 2-Wasserstein beside the exact one.
13. The VAE family (`vae`, `cvae`) at the published widths of
   `variant_config` (18,868 genes, encoder and decoder (256, 256), latent
   64; seeded random Flax-layout weights through `convert.py`): (a) one
   step card vs CPU with the same eps (metrics within VAE_METRIC_RTOL, each
   parameter's first gradient within VAE_GRAD_RTOL, rejecting the
   decoder's output scaled by 1 + 2^-5); (b) a 4-step graphed epoch
   (`VAEEngine.step_many`, one CUDA graph) bitwise equal to 4 eager steps,
   graphed and eager steps/s, a replay's device time; (c) sampled
   profiles/s; (d) `cli.train --variant vae` and `cvae`, 2 epochs on phase
   10's 128-case layout: finite metrics, the dumps' files and shapes,
   best.json, evaluate best, then `cli.evaluate` over each run dir; (e)
   1 epoch, then `--resume` to 2: the final checkpoint bitwise equal to
   (d)'s. No kernel launches over the phase.
14. The serving artifact and `cli.sample`'s data sources over phase 10's
   run: `python -m gemm_gan_tpu_torch.cli.export --which best --use_ema`
   on the card (`torch.export`, every attention the op
   `gemm_gan_tpu_torch::masked_mha`), loaded and served at batches of 8
   and 3 at 256 and 1,024 patches against `GeneratorServer` of the
   restored EMA generator on the same z (E2E_RTOL / E2E_ATOL, bitwise
   printed), with its launches per call (Q1 per patch layer at 256
   patches, Q3 at 1,024: `kernel_attentions`) and its ms per call beside
   the server's; the CVAE decoder of phase 13's run exported and held
   against `VAEEngine.sample`; `cli.sample --data_dir --ckpt_dir --which
   best --balanced --host_dtype float16`, per call and with `--scan`
   (bitwise equal), profiles/s.
15. The encoders and the ingest path at the published widths on seeded
   random weights: UNI ViT-L/16 at 256-pixel tiles and ModernBERT-base
   at 300 tokens, card against CPU on two inputs in f32 (ENCODER_TOL of
   the output's largest entry), bf16 against f32 by cosine (> 0.99),
   tiles/s at batch 64 and sequences/s at batch 32 in f32 and bf16 beside
   their bounds, and the bf16 batch's top device kernels;
   `IngestPipeline` over synthetic tiles of 8 cases through
   `cli.ingest`'s embed stage, the text caches over random ids and the
   contrastive caches (`cli.preprocess`'s stages), read back by
   `load_tcga`. No kernel launches.
16. The rest of the single-device port. (a) `viz.tsne_2d` on the card
   (`utils/tsne.py`): TSNE_CLUSTERS x TSNE_PER seeded Gaussian cluster
   points at the gene width, perplexity 30: seconds, final exact KL, the
   10-NN label agreement (at least TSNE_MIN_AGREEMENT); TSNE_SUBSET of the
   points on the card and on the CPU, final exact KLs within TSNE_KL_RTOL.
   (b) The flagship generator with `use_batchnorm=True` from seeded
   Flax-layout trees (params and `batch_stats`): its eval forward served
   card vs CPU in f32 (BN_EVAL_TOL) and bf16 (BF16_E2E_TOL), Q1 launches
   by `kernel_attentions`; one `train=True` forward card vs CPU, output
   and updated running buffers within BN_TRAIN_TOL. (c)
   `train.hoist_fakes=True`: the hoisted fakes against the per-update ones
   (card) and the CPU's; one dropout-free f32 step card vs CPU under phase
   5's gates with phase 5's draws (at most MAX_LOOSE params beyond
   PARAM_ATOL) and against the same step without the hoist on the card;
   phase 9
   (c)'s graphed bf16 flagship without and with the hoist in HOIST_TURNS
   turns each (steps/s, a replay's device ms and events, Q1 / Q2 launches
   a replay gated at `step_launches`). (d) `gemm_gan_tpu_torch.bench`
   (the torch step measurement) in bf16 and f32 at BENCH_SCAN_LEN rows:
   its JSON line, prefixed, and its launches.
17. Multi-device at world size 1 (`mesh_phase`): (a) `distributed_init`
   over NCCL (one rank, a free localhost port) and `make_mesh(1, 1)`; (b)
   one flagship f32 per_update step (dropout 0) on the mesh against the
   unmeshed step from the same params and draws, bitwise (params, moments,
   metrics; two unmeshed steps bitwise first), Q1 / Q2 launches equal; (c)
   phase 9 (c)'s graphed bf16 `step_many_cached` on and off the mesh over a
   MESH_BANK_CASES bank (the NCCL all-reduces captured in the graph):
   median steps/s of MESH_TURNS epochs each in turns, a replay's device ms
   and events and the per-kernel difference, launches a replay; (d)
   `Experiment` with `data.shard_bank` (a `ShardedDeviceCache`, S = 1) for
   one epoch of phase 10's RESUME_CASES layout, then `evaluate("last")`;
   (e) `destroy_process_group`. Several ranks need a card each: NCCL
   refuses two ranks on one card.
18. Prints the most sentinel records a profiler window lost, one
   `{"kernels": [...]}` JSON line (each kernel with its tile),
   the card's line, then the contract line `{"ok": true, "device": {...}}`
   last.

Any failed check raises, so the exit code is non-zero and the last line is
not printed. TF32 is switched off for matmuls and cuDNN, so every f32
product on the card is full f32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "gemm_gan_tpu_torch/kernels/csrc/"
TPU_KERNELS = "gemm_gan_tpu/kernels/flash_attention.py"
# kernel (a wrapper and its C entry point) -> (source, the TPU kernel it
# replaces); the last four are the bf16 modes of Q1 and Q2
KERNELS = {
    "flash_fwd_ble": (CSRC + "flash_fwd.cu", f"{TPU_KERNELS}:290"),
    "flash_fwd_bhld": (CSRC + "flash_fwd.cu", f"{TPU_KERNELS}:84"),
    "flash_bwd_ble": (CSRC + "flash_bwd_fused.cu", f"{TPU_KERNELS}:317"),
    "flash_bwd_dq": (CSRC + "flash_bwd_dq.cu", f"{TPU_KERNELS}:142"),
    "flash_bwd_dkv": (CSRC + "flash_bwd_dkv.cu", f"{TPU_KERNELS}:220"),
    "flash_bwd_bhld_fused": (CSRC + "flash_bwd_fused.cu", f"{TPU_KERNELS}:179"),
    "flash_fwd_ble_bf16": (CSRC + "flash_fwd_bf16.cu", f"{TPU_KERNELS}:290"),
    "flash_fwd_ble_mxu": (CSRC + "flash_fwd_bf16.cu", f"{TPU_KERNELS}:290"),
    "flash_bwd_ble_bf16": (CSRC + "flash_bwd_bf16.cu", f"{TPU_KERNELS}:317"),
    "flash_bwd_ble_mxu": (CSRC + "flash_bwd_mxu.cu", f"{TPU_KERNELS}:317"),
    "flash_fwd_bhld_bf16": (CSRC + "flash_fwd_bhld_bf16.cu", f"{TPU_KERNELS}:84"),
    "flash_fwd_bhld_mxu": (CSRC + "flash_fwd_bhld_bf16.cu", f"{TPU_KERNELS}:84"),
    "flash_bwd_bhld_fused_bf16": (CSRC + "flash_bwd_bhld_bf16.cu", f"{TPU_KERNELS}:179"),
    "flash_bwd_bhld_fused_mxu": (CSRC + "flash_bwd_bhld_mxu.cu", f"{TPU_KERNELS}:179"),
    "flash_bwd_dq_bf16": (CSRC + "flash_bwd_dq_bf16.cu", f"{TPU_KERNELS}:142"),
    "flash_bwd_dq_mxu": (CSRC + "flash_bwd_dq_bf16.cu", f"{TPU_KERNELS}:142"),
    "flash_bwd_dkv_bf16": (CSRC + "flash_bwd_dkv_bf16.cu", f"{TPU_KERNELS}:220"),
    "flash_bwd_dkv_mxu": (CSRC + "flash_bwd_dkv_bf16.cu", f"{TPU_KERNELS}:220"),
}
# the tile each kernel's main path runs (the bf16 modes: bf16 refs, the bench
# configuration's); phase 1 holds it to ptxas' report, where a wgmma tile
# has its `*_wg_kernel` instantiation for the entry point at D 64 and an
# mma.sync one none
_MMA_F32 = "mma.sync m16n8k8 3xTF32"
_WG_FWD = "wgmma m64nNk16, flash_fwd_wg.cuh"
_WG_FUSED = "wgmma m64nNk16, flash_bwd_wg.cuh dk/dv and dq tiles"
TILES = {"flash_fwd_ble": f"{_MMA_F32}, flash_fwd.cuh",
         "flash_fwd_bhld": f"{_MMA_F32}, flash_fwd.cuh",
         "flash_bwd_ble": f"{_MMA_F32}, flash_bwd_tc.cuh",
         "flash_bwd_dq": f"{_MMA_F32}, flash_bwd_tc.cuh dq tile",
         "flash_bwd_dkv": f"{_MMA_F32}, flash_bwd_tc.cuh dk/dv tile",
         "flash_bwd_bhld_fused": f"{_MMA_F32}, flash_bwd_tc.cuh",
         **{f"flash_fwd_{layout}_{mode}": _WG_FWD for layout in ("ble", "bhld")
            for mode in ("bf16", "mxu")},
         **{f"flash_bwd_{kind}_{mode}": _WG_FUSED for kind in ("ble", "bhld_fused")
            for mode in ("bf16", "mxu")},
         **{f"flash_bwd_dq_{mode}": "wgmma m64nNk16, flash_bwd_wg.cuh dq tile"
            for mode in ("bf16", "mxu")},
         **{f"flash_bwd_dkv_{mode}": "wgmma m64nNk16, flash_bwd_wg.cuh dk/dv tile"
            for mode in ("bf16", "mxu")}}
# the bf16 modes: Q1, Q2 (ble) and Q3, Q6, Q4, Q5 (the classic layout)
BF16_KERNELS = ("flash_fwd_ble_bf16", "flash_fwd_ble_mxu", "flash_bwd_ble_bf16",
                "flash_bwd_ble_mxu", "flash_fwd_bhld_bf16", "flash_fwd_bhld_mxu",
                "flash_bwd_bhld_fused_bf16", "flash_bwd_bhld_fused_mxu", "flash_bwd_dq_bf16",
                "flash_bwd_dq_mxu", "flash_bwd_dkv_bf16", "flash_bwd_dkv_mxu")
# FLOP per (query, valid key, head-dim element) of each backward kernel:
# s = q.k, dp = dO.v, then dv, dq, dk, 2 FLOP per multiply-add each
BWD_FLOP = {"flash_bwd_ble": 10, "flash_bwd_bhld_fused": 10,
            "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
BWD_FLOP.update({f"{name}_{mode}": n for name, n in BWD_FLOP.items() for mode in ("bf16", "mxu")})
# bf16 tensor-core passes per product of the bf16 modes (csrc/flash_ops.cuh):
# the bf16 mode takes P and dS in 3 bf16 terms and the bf16 operands in one
# (forward S 1 + P.V 3; backward S 1, dP 1, then dV 3, dK 3, dQ 3 over the
# products each kernel computes), mxu_bf16 one each, its forward S twice (a
# first pass for the row max of each key block)
BF16_PASSES = {"flash_fwd_ble_bf16": 4 / 2, "flash_fwd_ble_mxu": 3 / 2,
               "flash_bwd_ble_bf16": 11 / 5, "flash_bwd_ble_mxu": 5 / 5,
               "flash_fwd_bhld_bf16": 4 / 2, "flash_fwd_bhld_mxu": 3 / 2,
               "flash_bwd_bhld_fused_bf16": 11 / 5, "flash_bwd_bhld_fused_mxu": 5 / 5,
               "flash_bwd_dq_bf16": 5 / 3, "flash_bwd_dq_mxu": 3 / 3,
               "flash_bwd_dkv_bf16": 8 / 4, "flash_bwd_dkv_mxu": 4 / 4}
# which of (dq, dk, dv) a backward kernel writes
BWD_OUTPUTS = {"dq": ("dq",), "dkv": ("dk", "dv")}
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)
# a bf16 mode's output vs its plain version: each rounds once from f32
# sums taken in another order, so within one bf16 ulp of the row's largest
# entry; lse (f32) within LSE_ATOL
BF16_ULPS, LSE_ATOL = 1, 1e-5
# phase 9 (the bench configuration, bf16): serving card vs CPU within
# BF16_E2E_TOL of the output's largest entry (bf16 rounds at 2^-8 relative;
# cuBLAS's bf16 GEMMs and the CPU's round at other places through two
# encoder layers and the trunk). One step card vs CPU: bf16 rounding
# reaches most gradients' signs, and RMSprop turns each into a +-10 lr
# move, so after n_critic updates most params and the last update's
# metrics differ (8.0 M of 17.2 M params beyond PARAM_ATOL, g_loss 5.7% on
# an NVIDIA H100 80GB HBM3 at 700 W). So the step is held relative to the
# same bf16 step with use_pallas=False on the card (cuBLAS's bf16 and the
# plain references against the CPU): params as phase 6, and each metric
# within PLAIN_LOOSE_FACTOR times that step's distance, or BF16_STEP_RTOL
# of its value if more
BF16_E2E_TOL = 2e-2
BF16_STEP_RTOL = 5e-2
# Phase 9 (b) / (d) hold the bf16 step's first gradients, before any
# optimizer move (`grad_gate`), where the step's metrics, after n_critic
# RMSprop updates, scatter chaotically (`scripts/torch_bf16_step_scatter.py`
# prints both). Of those gradients the gate takes the part that passes
# through the attention kernels: each net's fusion's params' gradients,
# with the cotangent the step's loss gives the fusion's output fixed
# (computed once, on the CPU). The trunks' ReLUs, whose pattern flips with
# any rounding of their inputs, stay out: they move the whole nets'
# gradients in jumps as large as a wrong Q1 does. Each param's gradient may
# lie from the CPU's at most PLAIN_LOOSE_FACTOR times as far as the plain
# versions' on the card (relative distance), or GRAD_GATE_FLOOR if more:
# per param, since a key dropped by a wrong kernel moves the attention
# projections' gradients far beyond bf16's scatter, and the whole nets'
# norm would drown it. The yardstick is itself one draw of how bf16
# rounding lands, and a draw closer to the CPU than half of bf16's unit
# roundoff (2^-8) says nothing of where another right computation lands:
# below that the gate would reject right kernels by chance.
GRAD_GATE_FLOOR = 2 ** -9
# the gate's negative controls: Q1's output scaled by Q1_SCALE (4 to 8
# bf16 ulps of each entry), or the last valid key of every row masked out
Q1_SCALE = 1 + 2 ** -5
# H100 SXM data sheet: f32 outside the tensor cores, dense TF32 on the
# tensor cores, and HBM3 bandwidth. `bound_tc_ms` counts 3 TF32 products per
# f32 product (3xTF32, as every kernel under csrc/ computes and as the
# library's f32 attention on sm80+ does).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs its plain version, f32 on the card (different summation order)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# whole generator, card (kernels, cuBLAS) vs CPU (plain versions)
E2E_RTOL, E2E_ATOL = 1e-4, 1e-4
BATCH, N_BATCHES, REPEATS = 8, 4, 2
WHOLE_SLIDE_PATCHES = 4096
TRAIN_STEPS, WS_TRAIN_STEPS = 4, 2
# phase 8: the DeviceCache bank (cases, patch slots per case), the patches
# each step subsamples, the tokens per case, the cases of the small epoch
BANK_CASES, BANK_SLOTS, NUM_PATCHES, NUM_TOKENS = 1024, 512, 256, 300
SMALL_CASES = 32
# phase 9 (j): the whole-slide bank (cases, patch slots per case, the
# fewest valid slots of a case), subsampled to WHOLE_SLIDE_PATCHES a step:
# every case holds more patches than a step takes, as most TCGA slides do,
# so that each step's patches are all valid, as in 9 (g)'s batch
WS_BANK_CASES, WS_BANK_SLOTS, WS_MIN_VALID = 256, 4608, 4096
# one dropout-free training step, card (kernels, cuBLAS) vs CPU (plain
# versions): metrics within STEP_RTOL / STEP_ATOL, and the params.
# RMSprop's first update is +-10 lr sign(g), so an entry whose gradient is
# mostly rounding (the k projection's bias, which the softmax cancels; the
# critic head's bias, which the Wasserstein loss cancels) may move
# differently on the two devices. Unlike tests/test_torch_train.py (two
# updates per net), the accumulator cannot tell these entries apart here:
# over the critic's n_critic updates an entry whose first gradient was
# rounding may still end with a clear RMS. So at most MAX_LOOSE entries may
# miss PARAM_ATOL (a wrong dk in one layer would flip ~10^5 k_proj
# updates), and every entry stays within RMSprop's bound of 10 lr per
# update. The summary counts the misses whose RMS by the CPU run's
# accumulator is above NEGLIGIBLE_GRAD times their net's.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-4
F32_EPS = 2 ** -23  # float32's machine epsilon
PARAM_ATOL = 5e-5  # 1% of RMSprop's largest single update (10 lr, lr 5e-4)
NEGLIGIBLE_GRAD = 1e-4
MAX_LOOSE = 200
# the params whose exact gradient is 0: an attention's k projection bias
# adds q . b_k to every score of a softmax row, which the softmax cancels
ZERO_GRAD_SUFFIX = "k_proj.bias"
# The whole-slide step (phase 6), kernels vs use_pallas=False on the card:
# there the critic's first-layer q/k projections get gradients that are
# mostly rounding (a near-uniform softmax over 4,097 keys), and any f32
# reordering flips ~10^4 of their RMSprop updates: the kernels' own plain
# versions on the card, same dispatch, cuBLAS arithmetic, miss PARAM_ATOL on
# ~36,000 entries there. So each net may miss it on at most
# PLAIN_LOOSE_FACTOR times as many entries as the plain versions do on the
# same step (or MAX_LOOSE, if more), besides the metrics and bound gates.
PLAIN_LOOSE_FACTOR = 2
# phase 11 (b)'s attention gate (f32): a kernel attention's output or input
# gradient may lie from the CPU's at most PLAIN_LOOSE_FACTOR times as far
# (relative norm) as the plain versions' on the card, or ATTN_GATE_FLOOR if
# more: phase 2 holds every f32 kernel to its plain version within
# KERNEL_RTOL of each entry, so a distance below it is one that phase 2
# already accepts. The kernels multiply in 3xTF32 (each operand split into
# two TF32 terms, 22 of f32's 24 bits, the lo x lo product dropped): about
# 2^-21 a product, 8 times f32's unit roundoff, so they land a few times as
# far from the CPU as the f32 plain versions do. Its controls: Q1's output
# scaled by ATTN_CONTROL_SCALE (2.4 times the floor), and the last valid
# key of every row masked out
ATTN_GATE_FLOOR = KERNEL_RTOL
ATTN_CONTROL_SCALE = 1 + 2 ** -12


# (kernel template, its bool template arguments[, its product mode when
# not f32]) -> entry point; <D, kBle, kMode>, kMode of csrc/flash_ops.cuh
# (1 bf16, 2 mxu_bf16 on f32 refs, 3 mxu_bf16 on bf16 refs)
PTXAS_ENTRIES = {("flash_fwd_kernel", (1,)): "flash_fwd_ble",
                 ("flash_fwd_kernel", (0,)): "flash_fwd_bhld",
                 ("flash_bwd_fused_kernel", (1,)): "flash_bwd_ble",
                 ("flash_bwd_fused_kernel", (0,)): "flash_bwd_bhld_fused",
                 ("flash_bwd_dq_kernel", ()): "flash_bwd_dq",
                 ("flash_bwd_dkv_kernel", ()): "flash_bwd_dkv",
                 ("flash_fwd_kernel", (1,), 1): "flash_fwd_ble_bf16",
                 ("flash_fwd_kernel", (1,), 2): "flash_fwd_ble_mxu",
                 ("flash_fwd_kernel", (1,), 3): "flash_fwd_ble_mxu",
                 ("flash_bwd_fused_kernel", (1,), 1): "flash_bwd_ble_bf16",
                 ("flash_bwd_fused_kernel", (1,), 2): "flash_bwd_ble_mxu",
                 ("flash_bwd_fused_kernel", (1,), 3): "flash_bwd_ble_mxu",
                 ("flash_fwd_kernel", (0,), 1): "flash_fwd_bhld_bf16",
                 ("flash_fwd_kernel", (0,), 2): "flash_fwd_bhld_mxu",
                 ("flash_fwd_kernel", (0,), 3): "flash_fwd_bhld_mxu",
                 ("flash_bwd_fused_kernel", (0,), 1): "flash_bwd_bhld_fused_bf16",
                 ("flash_bwd_fused_kernel", (0,), 2): "flash_bwd_bhld_fused_mxu",
                 ("flash_bwd_fused_kernel", (0,), 3): "flash_bwd_bhld_fused_mxu",
                 ("flash_bwd_dq_kernel", (), 1): "flash_bwd_dq_bf16",
                 ("flash_bwd_dq_kernel", (), 2): "flash_bwd_dq_mxu",
                 ("flash_bwd_dq_kernel", (), 3): "flash_bwd_dq_mxu",
                 ("flash_bwd_dkv_kernel", (), 1): "flash_bwd_dkv_bf16",
                 ("flash_bwd_dkv_kernel", (), 2): "flash_bwd_dkv_mxu",
                 ("flash_bwd_dkv_kernel", (), 3): "flash_bwd_dkv_mxu",
                 # the bf16-ref modes of Q2 and Q6 on the wgmma tiles
                 # (csrc/flash_bwd_wg.cuh), D 16, 32, 64
                 ("flash_bwd_wg_kernel", (1,), 1): "flash_bwd_ble_bf16",
                 ("flash_bwd_wg_kernel", (1,), 3): "flash_bwd_ble_mxu",
                 ("flash_bwd_wg_kernel", (0,), 1): "flash_bwd_bhld_fused_bf16",
                 ("flash_bwd_wg_kernel", (0,), 3): "flash_bwd_bhld_fused_mxu",
                 # the bf16-ref modes of Q1, Q3, Q4 and Q5 on the wgmma tiles
                 # (csrc/flash_fwd_wg.cuh in either layout, csrc/flash_bwd_wg.cuh's
                 # dq and dk/dv tiles), D 16, 32, 64
                 ("flash_fwd_wg_kernel", (1,), 1): "flash_fwd_ble_bf16",
                 ("flash_fwd_wg_kernel", (1,), 3): "flash_fwd_ble_mxu",
                 ("flash_fwd_wg_kernel", (0,), 1): "flash_fwd_bhld_bf16",
                 ("flash_fwd_wg_kernel", (0,), 3): "flash_fwd_bhld_mxu",
                 ("flash_bwd_dq_wg_kernel", (), 1): "flash_bwd_dq_bf16",
                 ("flash_bwd_dq_wg_kernel", (), 3): "flash_bwd_dq_mxu",
                 ("flash_bwd_dkv_wg_kernel", (), 1): "flash_bwd_dkv_bf16",
                 ("flash_bwd_dkv_wg_kernel", (), 3): "flash_bwd_dkv_mxu"}
MODE_REFS = {2: " (f32 refs)", 3: " (bf16 refs)"}


def _ptxas_key(mangled: str):
    """(key of PTXAS_ENTRIES, head dim, product mode) of a mangled kernel
    name, or None."""
    m = re.search(r"\d(flash_\w+?_kernel)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return None
    args = re.findall(r"L([ib])(\d+)E", m.group(2))
    bools = tuple(int(v) for kind, v in args if kind == "b")
    modes = [int(v) for kind, v in args[1:] if kind == "i"]
    mode = modes[0] if modes else 0
    return ((m.group(1), bools) if mode == 0 else (m.group(1), bools, mode)), int(args[0][1]), mode


def ptxas_entry(mangled: str, entries=PTXAS_ENTRIES):
    """(entry point, head dim) of the kernel template instantiation that
    ptxas names `mangled`; raises on a kernel that `entries` does not know,
    so that none goes unreported."""
    parsed = _ptxas_key(mangled)
    if parsed is None or parsed[0] not in entries:
        raise ValueError(f"ptxas reports a kernel chip_smoke does not know: {mangled}")
    return entries[parsed[0]], parsed[1]


def ptxas_label(mangled: str) -> str:
    """"entry D=d" of an instantiation, with mxu_bf16's element type."""
    entry, D = ptxas_entry(mangled)
    return f"{entry} D={D}{MODE_REFS.get(_ptxas_key(mangled)[2], '')}"


def ptxas_records(log: str):
    """(mangled kernel name, text) for each line of nvcc's ptxas -v output
    worth printing: "" where a kernel's own report starts, then its
    registers, spills and warnings; ptxas' advice (such as C7512, wgmma
    serialized) under the function it names, which ptxas prints before
    that function's own report."""
    current = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        advice = re.search(r"\((C\d+)\) (.*?) for the function '(\w+)'", line)
        if entry:
            current = entry.group(1)
            yield current, ""
        elif advice:
            yield advice.group(3), f"ptxas {advice.group(1)} {advice.group(2)}"
        elif current and any(w in line for w in ("registers", "spill", "arning")):
            yield current, line.replace("ptxas info    :", "").strip()


def ptxas_report(log: str) -> list:
    """Phase 1's lines of `ptxas_records`, each kernel by its label."""
    return [f"    {ptxas_label(name)}:" if not text else
            f"    {ptxas_label(name)}: {text}" if text.startswith("ptxas ") else f"      {text}"
            for name, text in ptxas_records(log)]


def check_tiles(log: str) -> None:
    """Hold TILES to nvcc's ptxas report `log`: each entry point whose tile
    is a wgmma one has a `*_wg_kernel` instantiation at D 64, each other
    entry point none; raises on a mismatch."""
    wg = {ptxas_entry(name) for name, _ in ptxas_records(log) if "_wg_kernel" in name}
    for name, tile in TILES.items():
        has = (name, 64) in wg
        assert has == tile.startswith("wgmma"), (name, tile, "wgmma kernel built" if has else
                                                  "no wgmma kernel built")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed):
    """q (pre-scaled), k, v, mask on the card; with `ragged`, random valid
    lengths and sample 0 fully masked."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "ble":
        qs, ks = (B, Lq, H * D), (B, Lk, H * D)
    else:
        qs, ks = (B, H, Lq, D), (B, H, Lk, D)
    q = torch.randn(qs, device="cuda", generator=g) * D ** -0.5
    k = torch.randn(ks, device="cuda", generator=g)
    v = torch.randn(ks, device="cuda", generator=g)
    if ragged:
        lens = torch.randint(1, Lk + 1, (B,), device="cuda", generator=g)
        lens[0] = 0
    else:
        lens = torch.full((B,), Lk, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None, :] < lens[:, None]
    return q, k, v, mask


def bounds(flops, nbytes) -> dict:
    """Least time (ms) for `flops` over `nbytes`: `bound_ms` at the f32
    CUDA-core peak, `bound_tc_ms` in 3xTF32 on the tensor cores, each the
    larger of its operations time and the bytes time."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(3 * flops / PEAK_TF32_FLOPS, t_bytes)}


def bound(H, Lq, D, q, k, v, mask) -> dict:
    """Bounds of a forward: the bytes each input read once and each output
    written once, against the operations that the valid keys need (q.k and
    p.v, 2 FLOP per multiply-add)."""
    valid = int(mask.sum())
    flops = 4 * H * Lq * D * valid
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + mask.numel() \
        + 4 * q.shape[0] * H * Lq  # q, k, v, o, mask, lse
    return bounds(flops, nbytes)


PROFILER_PAD_S = 0.05  # host time inside each torch.profiler window, before and after the work
PROFILER_ATTEMPTS = 8  # readings device_ms and agreed_profile take at most before they give up
SENTINEL_CYCLES = 1_000_000  # clock cycles each sentinel kernel spins (about 0.5 ms on an H100)
SENTINEL_KEY = "spin_kernel"  # the name of the sentinels' records (torch.cuda._sleep's kernel)
LEAD_IN_MAX = 4096  # the most sentinels a window opens with
# sentinels that open the next torch.profiler window (`profiled`); doubled
# whenever a window keeps fewer than half of them
PROFILER_LEAD_IN = {"n": 64}
# readings device_ms took, the device times it returned (two readings each
# when the profiler misses no record), and the most sentinels a window lost
PROFILER_READINGS = {"readings": 0, "times": 0, "most_sentinels_lost": 0}


def profiled(fn):
    """torch.profiler (CPU and CUDA activities) over `fn()` and a
    synchronise, with PROFILER_PAD_S of host time at each end of the window.
    Returns (the profile, whether it is whole).

    The profiler drops the first device records of a window, more of them
    the more windows a process has opened (on an NVIDIA H100 80GB HBM3 at
    700 W: the first records of an eager step, its host-to-device copies
    and random draws, in most readings of it). So each window opens with PROFILER_LEAD_IN sentinel kernels
    (`torch.cuda._sleep`), synchronised before `fn`: they take the dropped
    records, `device_records` leaves them out, and the profile is whole
    when it kept one of them or more (the drop ended inside the lead-in).
    The lead-in doubles, up to LEAD_IN_MAX, when a window keeps fewer than
    half of its sentinels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = PROFILER_LEAD_IN["n"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(n):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    kept = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and SENTINEL_KEY in e.key)
    PROFILER_READINGS["most_sentinels_lost"] = max(PROFILER_READINGS["most_sentinels_lost"],
                                                   n - kept)
    if 2 * kept < n:
        PROFILER_LEAD_IN["n"] = min(2 * n, LEAD_IN_MAX)
    return prof, kept > 0


def device_records(prof) -> list:
    """The device-side events of a profile (kernels, copies, memsets),
    without `profiled`'s sentinels: a host op's own device time, or a user
    annotation's span, would count its kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and not getattr(e, "is_user_annotation", False) and SENTINEL_KEY not in e.key]


def agreeing_reading(readings) -> int:
    """The index of the first reading that settles a measurement, else
    None. `readings` is a sequence of (whole, counts): whether `profiled`
    found the profile whole, and its device records' counts by key. A
    reading settles it when it is whole, has records, and records the same
    work, key for key, as the last whole reading before it."""
    last = None
    for i, (whole, counts) in enumerate(readings):
        if not whole or not counts:
            continue
        if counts == last:
            return i
        last = counts
    return None


def device_ms(fn, iters: int = 10) -> float:
    """Device time (ms) per call of `fn`: the device time of the kernels,
    copies and memsets that `iters` calls ran, by torch.profiler, over
    `iters` (after one warm-up call). Unlike `cuda_ms` it leaves out the
    host's time between launches. A reading counts only when it is whole:
    `profiled` found it so, each kernel, copy and memset has a multiple of
    `iters` records (every call runs the same work), and the last whole
    reading before it has as many of each (`agreeing_reading`). After
    PROFILER_ATTEMPTS readings with none that counts, it raises."""
    fn()
    readings = []
    for _ in range(PROFILER_ATTEMPTS):
        prof, whole = profiled(lambda: [fn() for _ in range(iters)])
        records = device_records(prof)
        counts = {e.key: e.count for e in records}
        readings.append((whole and all(c % iters == 0 for c in counts.values()), counts))
        PROFILER_READINGS["readings"] += 1
        if agreeing_reading(readings) is not None:
            PROFILER_READINGS["times"] += 1
            return sum(e.self_device_time_total for e in records) / 1e3 / iters
    raise RuntimeError(f"torch.profiler missed device records in {PROFILER_ATTEMPTS} readings "
                       f"of {iters} calls: no two whole readings agree (last {counts})")


def device_kernels(fn) -> list:
    """Names of the CUDA kernels one call of `fn` ran, from torch.profiler."""
    return sorted({e.key[:90] for e in device_records(profiled(fn)[0])
                   if e.self_device_time_total > 0})


def check_kernel(fa, layout, B, H, Lq, Lk, D, ragged, seed):
    """Kernel vs plain version on one input; returns (max |o err|, inputs)."""
    import torch

    q, k, v, mask = attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed)
    if layout == "ble":
        o, lse = fa.flash_fwd_ble(q, k, v, mask, H)
        po, plse = fa.flash_fwd_ble_plain(q, k, v, mask, H)
    else:
        o, lse = fa.flash_fwd_bhld(q, k, v, mask)
        po, plse = fa.flash_fwd_bhld_plain(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, po, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    torch.testing.assert_close(lse, plse, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if ragged:  # sample 0 has no valid key
        assert float(o[0].abs().max()) == 0.0, "fully-masked rows must be 0"
    err = float((o - po).abs().max())
    print(f"  {layout:4s} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
          f"{'ragged' if ragged else 'full  '} max|o err|={err:.3e} "
          f"max|lse err|={float((lse - plse).abs().max()):.3e}", flush=True)
    return err, (q, k, v, mask)


def time_kernel(fa, layout, H, Lq, D, q, k, v, mask):
    import torch
    from torch.nn import functional as F

    if layout == "ble":
        B, L, E = q.shape

        def heads(x):
            return x.view(B, x.shape[1], H, D).transpose(1, 2)

        kernel = lambda: fa.flash_fwd_ble(q, k, v, mask, H)  # noqa: E731
        plain = lambda: fa.flash_fwd_ble_plain(q, k, v, mask, H)  # noqa: E731
        q4, k4, v4 = heads(q), heads(k), heads(v)
    else:
        kernel = lambda: fa.flash_fwd_bhld(q, k, v, mask)  # noqa: E731
        plain = lambda: fa.flash_fwd_bhld_plain(q, k, v, mask)  # noqa: E731
        q4, k4, v4 = q, k, v
    attn_mask = mask[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=attn_mask, scale=1.0)
    with torch.inference_mode():
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(library)
        print(f"  library forward ran: {device_kernels(library)}", flush=True)
        device = {"device_ms": device_ms(kernel), "library_device_ms": device_ms(library)}
    return {"ms": ms, "plain_ms": plain_ms, **bound(H, Lq, D, q, k, v, mask),
            "library_ms": library_ms, **device}


def bwd_args(fa, name, H, q, k, v, mask, seed):
    """The positional args of backward kernel `name` (and its plain
    version): the inputs, a random dO and the plain forward's o and lse."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(q.shape, device="cuda", generator=g)
    if name == "flash_bwd_ble":
        o, lse = fa.flash_fwd_ble_plain(q, k, v, mask, H)
        return (q, k, v, mask, o, lse, do, H)
    o, lse = fa.flash_fwd_bhld_plain(q, k, v, mask)
    return (q, k, v, mask, do, lse, (do * o).sum(-1))


def check_bwd_kernel(fa, name, layout, B, H, Lq, Lk, D, ragged, seed):
    """Backward kernel vs its plain version on one input; returns (max
    |err| over its outputs, args)."""
    import torch

    q, k, v, mask = attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed)
    args = bwd_args(fa, name, H, q, k, v, mask, seed + 1000)
    got = getattr(fa, name)(*args)
    want = getattr(fa, name + "_plain")(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        err = max(err, float((a - b).abs().max()))
    if ragged:  # sample 0 has no valid key: dq = 0 there, dk = dv = 0 at masked keys
        for a in got:
            assert float(a[0].abs().max()) == 0.0, f"{name}: sample 0 not 0"
        if name != "flash_bwd_dq":
            for a in got[-2:]:  # dk, dv as [B, Lk, ...]
                x = a if layout == "ble" else a.transpose(1, 2)
                assert float(x[~mask].abs().max()) == 0.0, f"{name}: masked keys not 0"
    scale = max(float(b.abs().max()) for b in want)
    print(f"  {name:20s} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
          f"{'ragged' if ragged else 'full  '} max|err|={err:.3e} (max|grad|={scale:.3e})",
          flush=True)
    return err, args


def time_bwd_kernel(fa, name, layout, H, args):
    """CUDA-event times of backward kernel `name`, its plain version, and the
    backward of `scaled_dot_product_attention` with the same boolean mask
    through `torch.autograd.grad` over a retained graph (w.r.t. q for dq,
    k and v for dk/dv, all three otherwise), with its bound."""
    import torch
    from torch.nn import functional as F

    q, k, v, mask = args[:4]
    do = args[4] if name != "flash_bwd_ble" else args[6]
    if layout == "ble":
        B, L, E = q.shape
        D = E // H

        def heads(x):
            return x.view(B, x.shape[1], H, D).transpose(1, 2)
    else:
        D = q.shape[-1]

        def heads(x):
            return x
    qs, ks, vs = (heads(x).detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[:, None, None, :],
                                         scale=1.0)
    wrt = {"flash_bwd_dq": (qs,), "flash_bwd_dkv": (ks, vs)}.get(name, (qs, ks, vs))
    dout = heads(do)
    kernel = getattr(fa, name)
    plain = getattr(fa, name + "_plain")
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args), iters=5)
    library = lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)  # noqa: E731
    library_ms = cuda_ms(library)
    print(f"  library backward ran: {device_kernels(library)}", flush=True)
    device = {"device_ms": device_ms(lambda: kernel(*args)),
              "library_device_ms": device_ms(library)}
    Lq = q.shape[1] if layout == "ble" else q.shape[2]
    flops = BWD_FLOP[name] * H * Lq * D * int(mask.sum())
    reads = [x for x in args if isinstance(x, torch.Tensor)]
    writes = {"flash_bwd_dq": [q], "flash_bwd_dkv": [k, v]}.get(name, [q, k, v])
    nbytes = sum(x.numel() * x.element_size() for x in reads + writes)
    return {"ms": ms, "plain_ms": plain_ms, **bounds(flops, nbytes),
            "library_ms": library_ms, **device}


def ulp_excess(got, want, num_heads) -> float:
    """The largest amount by which an entry of `got` lies farther from
    `want` than BF16_ULPS bf16 ulps of the largest entry of its row (one
    head's D entries) of `want`; <= 0 when every row is within (a row of
    `want` that is all 0 must be exactly 0)."""
    import torch

    shape = (*want.shape[:-1], num_heads, want.shape[-1] // num_heads)
    g, w = got.float().reshape(shape), want.float().reshape(shape)
    top = w.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(top)
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), torch.zeros_like(top))
    return float(((g - w).abs() - BF16_ULPS * ulp).max())


def assert_rows_within_ulps(got, want, num_heads, what):
    """Each row (one head's D entries) of `got` within BF16_ULPS bf16 ulps
    of the largest entry of that row of `want` (exactly 0 where it is 0)."""
    excess = ulp_excess(got, want, num_heads)
    assert excess <= 0, (what, excess)


def kernel_layout(name: str) -> str:
    """"ble" for Q1 and Q2's entries, "bhld" for the classic layout's."""
    return "ble" if "_ble" in name else "bhld"


def bf16_args(fa, name, B, H, Lq, Lk, D, ragged, seed, dtype):
    """The positional args of bf16 mode `name` (and of its plain version)
    on the card in `dtype`: q (pre-scaled), k, v, mask (and H for the ble
    layout); for a backward, a random dO and the plain forward's o and lse
    of the same mode (ble: o, lse, dO, H; bhld: dO, lse and delta =
    rowsum(dO * o) from their f32 upcast)."""
    import torch

    layout = kernel_layout(name)
    heads = (H,) if layout == "ble" else ()
    q, k, v, mask = (x.to(dtype) if x.is_floating_point() else x
                     for x in attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed))
    if name.startswith("flash_fwd"):
        return (q, k, v, mask, *heads)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    mode = name.rsplit("_", 1)[1]
    o, lse = getattr(fa, f"flash_fwd_{layout}_{mode}_plain")(q, k, v, mask, *heads)
    if layout == "ble":
        return (q, k, v, mask, o, lse, do, H)
    return (q, k, v, mask, do, lse, (do.float() * o.float()).sum(-1))


def output_labels(name: str) -> tuple:
    if name.startswith("flash_fwd"):
        return ("o", "lse")
    return BWD_OUTPUTS.get(name.split("_")[2], ("dq", "dk", "dv"))


def check_bf16_kernel(fa, name, B, H, Lq, Lk, D, ragged, seed, dtype):
    """A bf16 mode against its plain version on one input, within
    BF16_ULPS of each row's largest entry (lse within LSE_ATOL), or for a
    (mode, shape) of ROUNDED_OPERAND_GATED within `rounded_operand_bound`;
    returns (max |err| over its outputs, args)."""
    import torch

    layout = kernel_layout(name)
    args = bf16_args(fa, name, B, H, Lq, Lk, D, ragged, seed, dtype)
    got, want = getattr(fa, name)(*args), getattr(fa, name + "_plain")(*args)
    got, want = ((x,) if isinstance(x, torch.Tensor) else x for x in (got, want))
    torch.cuda.synchronize()
    labels = output_labels(name)
    rounded = (name, (B, H, Lq, Lk, D)) in ROUNDED_OPERAND_GATED
    bounds = rounded_operand_bound(args) if rounded else None
    err = 0.0
    for label, a, b in zip(labels, got, want, strict=True):
        assert a.dtype == b.dtype, (name, label, a.dtype, b.dtype)
        if label == "lse":
            torch.testing.assert_close(a, b, rtol=0, atol=LSE_ATOL)
        else:
            assert a.dtype == dtype, (name, label, a.dtype)
            if rounded:
                ratio = bound_ratio(a, b, bounds[label])
                control = bound_ratio(a.float() * (1 + 2 ** -5), b, bounds[label])
                print(f"    {name} {label}: |kernel - plain| at most {ratio:.4f} of "
                      f"rounded_operand_bound; scaled by 1 + 2^-5 (the control) "
                      f"{control:.4f}", flush=True)
                assert ratio <= 1.0, (name, label, ratio)
                assert control > 1.0, (name, label, "the control passed", control)
            else:
                assert_rows_within_ulps(a, b, H if layout == "ble" else 1, f"{name} {label}")
            err = max(err, float((a.float() - b.float()).abs().max()))
    if ragged:  # sample 0 has no valid key; dk = dv = 0 at masked keys
        mask = args[3]
        for label, a in zip(labels, got):
            if label == "lse":
                continue
            assert float(a[0].abs().max()) == 0.0, f"{name} {label}: sample 0 not 0"
            if label in ("dk", "dv"):
                x = a if layout == "ble" else a.transpose(1, 2)
                assert float(x[~mask].abs().max()) == 0.0, f"{name} {label}: masked keys not 0"
    print(f"  {name:26s} {str(dtype).split('.')[-1]:8s} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
          f"{'ragged' if ragged else 'full  '} max|err|={err:.3e} ("
          + ("within rounded_operand_bound" if rounded else
             f"within {BF16_ULPS} bf16 ulp of each row's largest entry") + ")", flush=True)
    return err, args


def bf16_ulp(x):
    """One bf16 ulp of each entry of `x` (f32): 2^(e - 8) for |x| in
    [2^(e-1), 2^e), 0 where x is 0."""
    import torch

    _, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8),
                       torch.zeros_like(x, dtype=torch.float32))


def rounded_operand_bound(args) -> dict:
    """Per-entry bounds of |kernel - plain| for `flash_bwd_dkv_mxu`'s dk and
    dv on the classic layout's args (q, k, v, mask, dO, lse, delta).

    Under mxu_bf16 both sides round the f32 dS (and P) to bf16 before
    dK = dSᵀ·Q (dV = Pᵀ·dO), each from its own f32 value. The two f32
    values differ by far less than a bf16 ulp, so their roundings agree or,
    where they straddle a rounding boundary, differ by one ulp of dS_ij.
    Summed over the queries i, the products then differ by at most
    Σ_i ulp(dS_ij)·|q_id| (Σ_i ulp(P_ij)·|dO_id|); their f32 summation
    orders differ by ≈Lq·2^-24 of Σ_i |dS_ij||q_id|, which that sum covers
    many times (ulp(x) > 2^-8 |x|). Each side then rounds its output once
    (bf16 refs): together one bf16 ulp of the row's largest entry, as
    BF16_ULPS counts. dS and P are taken from the plain version's formula
    on the operands as the mode rounds them; the entries where no key is
    valid are 0 on both sides and bound 0."""
    import torch

    from gemm_gan_tpu_torch.kernels.flash_attention import _bwd_probs

    q, k, v, mask, do, lse, delta = args
    qf, kf, vf, dof = (x.to(torch.bfloat16).float() for x in (q, k, v, do))
    p = _bwd_probs(qf, kf, mask[:, None, None, :], lse)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    return {"dk": bf16_ulp(ds).transpose(-1, -2) @ qf.abs(),
            "dv": bf16_ulp(p).transpose(-1, -2) @ dof.abs()}


def bound_ratio(got, want, bound) -> float:
    """The largest |got - want| over its per-entry bound plus one bf16 ulp
    of the row's (last axis's) largest |want|; <= 1 within the bound (a
    zero bound must be met exactly)."""
    import torch

    g, w = got.float(), want.float()
    limit = bound + bf16_ulp(w.abs().amax(-1, keepdim=True))
    diff = (g - w).abs()
    if bool((diff[limit == 0] > 0).any()):
        return float("inf")
    return float((diff / torch.where(limit > 0, limit, 1.0)).max())


def time_bf16_kernel(fa, name, args) -> dict:
    """CUDA-event and device times of bf16 mode `name` on `args`, of its
    plain version, and of `scaled_dot_product_attention` on the same inputs
    in their dtype with the same boolean mask (forward, or its backward by
    `torch.autograd.grad` w.r.t. what the kernel writes: q for dq, k and v
    for dk/dv, all three otherwise); `bound_ms` the larger of the mode's
    bf16 passes over the FLOPs at PEAK_BF16_FLOPS and the bytes (each input
    read and each output written once) at PEAK_BYTES_PER_S."""
    import torch
    from torch.nn import functional as F

    q, k, v, mask = args[:4]
    if kernel_layout(name) == "ble":
        H = args[-1]
        B, Lq, E = q.shape
        D = E // H

        def heads(x):
            return x.view(B, x.shape[1], H, D).transpose(1, 2)
        do = None if name.startswith("flash_fwd") else args[6]
    else:
        B, H, Lq, D = q.shape

        def heads(x):
            return x
        do = None if name.startswith("flash_fwd") else args[4]

    kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
    attn_mask = mask[:, None, None, :]
    if name.startswith("flash_fwd"):
        q4, k4, v4 = heads(q), heads(k), heads(v)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=attn_mask, scale=1.0)
        flops, writes = 4 * H * Lq * D * int(mask.sum()), kernel(*args)
    else:
        qs, ks, vs = (heads(x).detach().clone().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn_mask, scale=1.0)
        labels = output_labels(name)
        wrt = tuple(x for label, x in zip(("dq", "dk", "dv"), (qs, ks, vs)) if label in labels)
        library = lambda: torch.autograd.grad(out, wrt, heads(do),  # noqa: E731
                                              retain_graph=True)
        flops = BWD_FLOP[name] * H * Lq * D * int(mask.sum())
        writes = tuple(x for label, x in zip(("dq", "dk", "dv"), (q, k, v)) if label in labels)
    with torch.inference_mode(name.startswith("flash_fwd")):
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        library_ms = cuda_ms(library)
        print(f"  library ({str(q.dtype).split('.')[-1]}) ran: {device_kernels(library)}",
              flush=True)
        device = {"device_ms": device_ms(lambda: kernel(*args)),
                  "library_device_ms": device_ms(library)}
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *writes)
                 if isinstance(x, torch.Tensor))
    t_ops = BF16_PASSES[name] * flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, **device}


# phase 2's shapes of the bf16 modes (B, H, Lq, Lk, D): each kernel's main
# path shape first (checked ragged, then timed all-valid), then ragged ones
# at D 8 / 64 / 128; the classic forward's Lk 600 is three key blocks of
# 256, the last one short. The ble layout's kernels (Q1, Q2) and the
# single-block backward (Q6), whose bf16-ref modes run the wgmma tiles at
# D 16 / 32 / 64, also at L 512 (the largest single-block length: 8 tiles
# of each kind, no tail), Lq 300 against Lk 257 (CrossAttentionFusion's
# text queries over the patches) and D 16 / 32; their main path shape is
# checked MAIN_REPEATS times, so that a missing fence shows as a mismatch.
# So are the classic layout's (Q3-Q5), whose bf16-ref modes run the wgmma
# tiles at D 16 / 32 / 64: also at Lk 600 with D 16 / 32, and at L 1,100
# with B 8 (a key and a query tail, five key blocks under mxu_bf16, 576
# blocks of 64 rows: more than one wave at 3 blocks per SM on 132 SMs).
SINGLE_BLOCK_SHAPES = ((4, 4, 512, 512, 64), (2, 4, 300, 257, 64), (2, 2, 136, 260, 32),
                       (2, 2, 136, 260, 16))
MAIN_REPEATS = 3
# Token cross-attention (phase 11) adds its two new shapes: its text
# queries over the ragged tokens (Q1 / Q2, Lq 300 x Lk 300), and over a
# whole slide's patch sequence (Q3-Q5, Lq 300 x Lk 4,097).
XATTN_TOKENS_SHAPE = (8, 4, 300, 300, 64)
XATTN_WHOLE_SLIDE_SHAPE = (8, 4, 300, WHOLE_SLIDE_PATCHES + 1, 64)
# (mode, shape) held to `rounded_operand_bound` instead of BF16_ULPS:
# under mxu_bf16 dS and P are rounded to bf16 before dK = dS^T Q and
# dV = P^T dO, so an output takes a second rounding where the two sides'
# f32 dS straddle a bf16 boundary, and BF16_ULPS (one rounding each) is no
# bound. Summed over only 300 queries the flips reach a row's largest
# entry: Q5's dk lands beyond one ulp of its plain version at Lq 300 x Lk
# 4,097 for some seeds (`scripts/torch_mxu_rounding.py` measures both
# bounds' margins; PERF.md).
ROUNDED_OPERAND_GATED = {("flash_bwd_dkv_mxu", XATTN_WHOLE_SLIDE_SHAPE)}
BF16_SHAPES = {
    "ble": ((8, 4, 257, 257, 64), (2, 2, 136, 260, 8), (2, 2, 136, 260, 128),
            *SINGLE_BLOCK_SHAPES, XATTN_TOKENS_SHAPE),
    "bhld_fused": ((8, 4, 257, 257, 64), (2, 2, 130, 260, 64), (2, 2, 136, 260, 8),
                   (2, 2, 136, 260, 128), *SINGLE_BLOCK_SHAPES),
    "bhld": ((8, 4, WHOLE_SLIDE_PATCHES + 1, WHOLE_SLIDE_PATCHES + 1, 64),
             (2, 2, 136, 600, 8), (2, 2, 136, 600, 16), (2, 2, 136, 600, 32),
             (2, 2, 136, 600, 64), (2, 2, 136, 600, 128), (8, 4, 1100, 1100, 64),
             XATTN_WHOLE_SLIDE_SHAPE),
}


def check_bf16_modes(fa, errs: dict, timed: dict) -> None:
    """Phase 2 for the bf16 modes: each against its plain version (bf16
    inputs; mxu_bf16 also on f32 ones) at its main path's shape and at D 8
    / 128 (BF16_SHAPES), ragged with a fully-masked sample; then timed at
    the main path's shape on all-valid bf16 inputs. Fills errs and timed."""
    import torch

    print(f"[2] bf16 modes vs plain (within {BF16_ULPS} bf16 ulp of each row's largest "
          f"entry, lse within {LSE_ATOL})", flush=True)
    for i, name in enumerate(BF16_KERNELS):
        layout = kernel_layout(name)
        shapes = BF16_SHAPES["bhld_fused" if "bhld_fused" in name else layout]
        repeats = MAIN_REPEATS if name.startswith(
            ("flash_fwd_ble", "flash_bwd_ble", "flash_bwd_bhld_fused", "flash_fwd_bhld",
             "flash_bwd_dq", "flash_bwd_dkv")) else 1
        for dtype in ((torch.bfloat16, torch.float32) if "mxu" in name else (torch.bfloat16,)):
            for j, shape in enumerate(shapes):
                for r in range(repeats if j == 0 else 1):
                    err, _ = check_bf16_kernel(fa, name, *shape, True,
                                               300 + 10 * i + j + 1000 * r, dtype)
                    errs[name] = max(errs[name], err)
        err, args = check_bf16_kernel(fa, name, *shapes[0], False, 400 + i, torch.bfloat16)
        errs[name] = max(errs[name], err)
        timed[name] = time_bf16_kernel(fa, name, args)
        print(f"  {name}: {json.dumps(timed[name])}", flush=True)
        del args
        torch.cuda.empty_cache()


def bf16_serving(fa, cfg16, params, batches, label, kernel) -> dict:
    """Phase 9 (a) / (d), 11 (d): `sample_all` of the bf16 model on the card
    (its launches: `kernel` once per kernel attention of the fusion
    (`kernel_attentions`) and batch, no other), then one batch
    card vs CPU within BF16_E2E_TOL of the output's largest entry, printed
    beside `use_pallas=False` on the card vs the CPU. Returns the launches."""
    import torch

    from gemm_gan_tpu_torch.serving import GeneratorServer

    server = GeneratorServer.from_flax(cfg16, params)
    server.sample_all(batches[:1], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.sample_all(batches, REPEATS, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()
    n = BATCH * len(batches) * REPEATS
    assert out["fake"].shape == (n, cfg16.n_genes) and out["fake"].dtype == np.float32
    assert np.isfinite(out["fake"]).all(), "non-finite profiles"
    assert launches == {**dict.fromkeys(KERNELS, 0),
                        kernel: sum(kernel_attentions(cfg16).values()) * len(batches)}, launches
    z = torch.randn(BATCH, cfg16.latent_dim, generator=torch.Generator().manual_seed(3))
    on_cpu = GeneratorServer.from_flax(cfg16, params, device="cpu")(z, batches[0])
    on_card = server(z, batches[0]).cpu()
    ref = dataclasses.replace(cfg16, fusion=dataclasses.replace(cfg16.fusion, use_pallas=False))
    plain = GeneratorServer.from_flax(ref, params)(z, batches[0]).cpu()
    scale = float(on_cpu.abs().max())
    err, plain_err = (float((x - on_cpu).abs().max()) for x in (on_card, plain))
    print(f"    ({label}) {cfg16.compute_dtype} serving, mxu_bf16={cfg16.fusion.flash_mxu_bf16}: "
          f"{n / seconds:.1f} profiles/s ({seconds * 1e3:.1f} ms for {n}) on {card_line()}; "
          f"launches {launches}; one batch card vs CPU max|err|={err:.3e} beside "
          f"use_pallas=False on the card vs CPU {plain_err:.3e} (max|out|={scale:.3f}; within "
          f"{BF16_E2E_TOL} x max|out|)", flush=True)
    assert err <= BF16_E2E_TOL * scale, (err, scale)
    return launches


def fusion_cotangents(cfg, g_params, d_params, batch, draws) -> dict:
    """On the CPU, at the step's starting params (Flax-layout trees) and with
    its draws: the gradient of the first critic update's loss (Wasserstein
    loss + gp_weight x gp) w.r.t. the critic fusion's output ("D") and of
    the generator loss w.r.t. the generator fusion's output ("G"), from the
    engine's own `critic_update` and `generator_update` (the optimizers'
    `update` replaced by a no-op, so no param moves)."""
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device="cpu")
    state = engine.state_from_flax(g_params, d_params)
    real, cond = engine._tensors(batch)
    d = {k: torch.as_tensor(np.asarray(draws[k])) for k in ("z", "alpha", "z_gen")}
    cot = {}
    for net, module, opt in (("D", state.critic, state.d_opt), ("G", state.gen, state.g_opt)):
        opt.update = lambda grads: None

        def hook(mod, inputs, out, net=net):
            if out.requires_grad:  # not the embeddings taken without grad
                out.register_hook(lambda g: cot.__setitem__(net, g.detach().clone()))

        module.fusion.register_forward_hook(hook)
    state.gen.train()
    state.critic.train()
    engine.critic_update(state, real, cond, engine.embed_generator(state, cond), d["z"][0],
                         d["alpha"][0])
    engine.generator_update(state, cond, d["z_gen"])
    return cot


def fusion_grads(cfg, device, g_params, d_params, batch, cot) -> dict:
    """Per net, the gradient w.r.t. each of its fusion's params of
    <cot[net], the fusion's output> (`fusion_cotangents`), as float64 on the
    host ({net: {param name: gradient}}): the part of the step's first
    gradients that passes through the attention kernels (forward and
    backward), with the trunk's cotangent fixed. Dropout is `cfg`'s (0 for
    a gate)."""
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device=device)
    state = engine.state_from_flax(g_params, d_params)
    _, cond = engine._tensors(batch)
    grads = {}
    for net, module in (("D", state.critic), ("G", state.gen)):
        module.train()
        out = module.fusion(cond)
        names, params = zip(*module.fusion.named_parameters())
        gs = torch.autograd.grad(out, params, cot[net].to(out.device, out.dtype))
        grads[net] = {n: g.detach().double().cpu() for n, g in zip(names, gs)}
    return grads


def _relative(got, want, floor: float = 0.0) -> float:
    """||got - want|| / max(||want||, floor); 0 where both are 0."""
    diff, scale = float((got - want).norm()), max(float(want.norm()), floor)
    return diff / scale if scale else (0.0 if diff == 0 else float("inf"))


def grad_distances(grads: dict, ref: dict) -> dict:
    """Per net, ||g - g_ref|| / ||g_ref|| over all its gradients."""
    import torch

    return {net: _relative(torch.cat([g.flatten() for g in by_name.values()]),
                           torch.cat([ref[net][n].flatten() for n in by_name]))
            for net, by_name in grads.items()}


def tensor_distances(grads: dict, ref: dict) -> dict:
    """Per net and param, ||g - g_ref|| / ||g_ref||; for a param whose
    exact gradient is 0 (ZERO_GRAD_SUFFIX: the k projections' biases, which
    add one constant to every score of a softmax row), over NEGLIGIBLE_GRAD
    times the net's ||g_ref|| where that is more, since both gradients are
    then rounding (the softmax's normalisation error) and their distance
    relative to either says nothing."""
    import torch

    out = {}
    for net, by_name in grads.items():
        floor = NEGLIGIBLE_GRAD * float(torch.cat([r.flatten() for r in ref[net].values()]).norm())
        out[net] = {n: _relative(g, ref[net][n], floor if n.endswith(ZERO_GRAD_SUFFIX) else 0.0)
                    for n, g in by_name.items()}
    return out


def drop_last_valid_key(mask):
    """`mask` [B, Lk] with the last valid key of every row masked out."""
    count = mask.long().sum(1, keepdim=True)
    return mask & (mask.long().cumsum(1) != count)


class perturbed_forward:
    """Within this context forward wrapper `name` of `fa` is wrong on
    purpose, a negative control of the gradient gate: "scaled", its output
    o times `scale`; "last_key_masked", its kernel run with the last valid
    key of every row masked out (the backward keeps the whole mask). The
    kernel itself still runs and counts its launches."""

    def __init__(self, fa, name: str, how: str, scale: float = Q1_SCALE):
        self.fa, self.name, self.how, self.scale = fa, name, how, scale

    def __enter__(self):
        kernel, how, scale = getattr(self.fa, self.name), self.how, self.scale

        def wrong(q, k, v, mask, *rest):
            if how == "last_key_masked":
                mask = drop_last_valid_key(mask)
            o, lse = kernel(q, k, v, mask, *rest)
            return (o * scale if how == "scaled" else o), lse

        self.saved = kernel
        setattr(self.fa, self.name, wrong)

    def __exit__(self, *exc):
        setattr(self.fa, self.name, self.saved)


def largest_ratio(run: dict, ref: dict, yardstick: dict) -> tuple:
    """(ratio, "net param") of the param whose gradient in `run` lies
    farthest from `ref`'s (`tensor_distances`) against its limit:
    PLAIN_LOOSE_FACTOR times `yardstick`'s distance from `ref`, or
    GRAD_GATE_FLOOR if more. A gate takes `run` where the ratio is <= 1."""
    limits = tensor_distances(yardstick, ref)
    return max((d / max(PLAIN_LOOSE_FACTOR * limits[net][n], GRAD_GATE_FLOOR), f"{net} {n}")
               for net, by_name in tensor_distances(run, ref).items()
               for n, d in by_name.items())


def grad_gate(fa, cfg, device, step_args, fwd: str) -> dict:
    """Phase 9 (b) / (d)'s gradient gate on `device` (the card; "cpu" in the
    tests): `fusion_grads` of `cfg` (dropout 0) at the step's starting
    params, with the cotangents the step's losses give each net's fusion
    on the CPU, computed with the kernels and with their plain versions
    (`plain_kernels`, the yardstick), both on `device`, and on the CPU.
    Each param's gradient may lie from the CPU's (`tensor_distances`) at
    most PLAIN_LOOSE_FACTOR times as far as the yardstick's, or
    GRAD_GATE_FLOOR if more. Then the negative controls: the gate run again
    with forward kernel `fwd` wrong on purpose (`perturbed_forward`,
    "scaled" and "last_key_masked") must reject each, some param beyond its
    limit. Raises otherwise. Returns per run the whole nets' distances
    (`grad_distances`) and the largest ratio of a param's distance to its
    limit, and the kernel run's launches."""
    g_params, d_params, batch, draws = step_args
    cot = fusion_cotangents(cfg, *step_args)

    def grads(on):
        return fusion_grads(cfg, on, g_params, d_params, batch, cot)

    cpu = grads("cpu")
    with plain_kernels(fa):
        plain = grads(device)
    fa.reset_launch_counts()
    runs = {"kernels": grads(device)}
    launches = {k: n for k, n in fa.launch_counts().items() if n}
    for how in ("scaled", "last_key_masked"):
        with perturbed_forward(fa, fwd, how):
            runs[how] = grads(device)
    summary = {"plain": grad_distances(plain, cpu)}
    worst = {}
    for label, run in runs.items():
        worst[label] = largest_ratio(run, cpu, plain)
        summary[label] = {**grad_distances(run, cpu),
                          "largest ratio to its limit": [round(worst[label][0], 4),
                                                         worst[label][1]]}
    summary["kernels_from_plain"] = grad_distances(runs["kernels"], plain)
    summary["launches"] = launches
    assert worst["kernels"][0] <= 1, ("the gate rejects the kernels", summary)
    for how in ("scaled", "last_key_masked"):
        assert worst[how][0] > 1, (f"the gate accepts the {how} control", summary)
    return summary


def bf16_step(fa, exp16, params, d_params, batch, label, n_attn=None) -> dict:
    """Phase 9 (b) / (d): the bf16 model's step on the card against the CPU,
    with the kernels' plain versions on the card (`plain_kernels`) as the
    yardstick. (1) `grad_gate` on the step's first gradients, with its
    negative controls on Q1 in the model's mode. (2) One dropout-free step:
    each net may miss PARAM_ATOL on at most `loose_limits` of the plain
    versions' step entries, each metric within `bf16_metric_tol` of the
    CPU step's with the plain versions' step as the yardstick; the launches
    are `step_launches` (`n_attn` kernel attentions per fusion forward, the
    model's by default); the same kernel step with cuBLAS's
    reduced-precision bf16 reductions off is printed beside it. Returns
    the kernel step's launches."""
    import torch

    cfg0 = train_cfg(exp16, dropout=0.0)
    mxu = exp16.model.fusion.flash_mxu_bf16
    fwd, bwd = (f"flash_fwd_ble_{'mxu' if mxu else 'bf16'}",
                f"flash_bwd_ble_{'mxu' if mxu else 'bf16'}")
    args = (params, d_params, batch, random_draws(cfg0, seed=9))
    gate = grad_gate(fa, cfg0, "cuda", args, fwd)
    assert gate["launches"].get(fwd) and gate["launches"].get(bwd), gate["launches"]
    print(f"    ({label}) bf16 gradient gate, mxu_bf16={mxu} (||g - g_cpu|| / ||g_cpu|| of "
          f"the fusion's params' gradients at the step's starting params, with the step's "
          f"cotangents at the fusion outputs from the CPU; per param at most "
          f"{PLAIN_LOOSE_FACTOR} x the plain versions' or {GRAD_GATE_FLOOR}; whole nets "
          f"printed): {json.dumps(gate)}; the controls scale {fwd}'s output by {Q1_SCALE} "
          f"or mask the last valid key of every row", flush=True)
    on_cpu = run_step(cfg0, "cpu", *args)
    with plain_kernels(fa):
        plain = step_diff(run_step(cfg0, "cuda", *args), on_cpu, {}, rtol=None)
    max_loose = loose_limits(plain)
    metric_tol = bf16_metric_tol(on_cpu[1], plain["metrics_test"])
    fa.reset_launch_counts()
    got = run_step(cfg0, "cuda", *args)
    torch.cuda.synchronize()
    launches = fa.launch_counts()
    cmp = step_diff(got, on_cpu, max_loose, metric_tol=metric_tol)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = not flag
    try:
        other = step_diff(run_step(cfg0, "cuda", *args), on_cpu, {}, rtol=None)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    n_fwd, n_bwd = step_launches(cfg0, n_attn)
    assert launches == {**dict.fromkeys(KERNELS, 0), fwd: n_fwd, bwd: n_bwd}, launches
    print(f"    ({label}) bf16 step at dropout 0, mxu_bf16={mxu}: the plain versions on the card "
          f"vs CPU {json.dumps(plain)}; the kernels vs CPU {json.dumps(cmp)} (metrics within "
          f"{json.dumps(metric_tol)} by bf16_metric_tol; params beyond atol {PARAM_ATOL} per "
          f"net at most {max_loose}); launches {launches}; the kernel step with "
          f"allow_bf16_reduced_precision_reduction={not flag} vs CPU (not gated): "
          f"{json.dumps(other)}", flush=True)
    return launches


def with_train(cfg, **train):
    """`cfg` with the given train fields."""
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def bhld_bf16_step(fa, exp16, params, d_params, batch, label) -> dict:
    """Phase 9 (e) / (h): one canonical step of the bf16 model with
    `flash_layout="bhld"` (its launches: the classic forward and the fused
    backward in the model's mode, no other kernel), then one dropout-free
    step against `use_pallas=False` on the card (`relative_step_gate`, as
    phase 7, in bf16). Returns the launches."""
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    cfg_ = train_cfg(exp16, flash_layout="bhld")
    mode = "mxu" if exp16.model.fusion.flash_mxu_bf16 else "bf16"
    engine = WGANGPEngine(cfg_, steps_per_epoch=1)
    state = engine.state_from_flax(params, d_params)
    fa.reset_launch_counts()
    state, metrics = engine.step(state, batch)
    torch.cuda.synchronize()
    launches = fa.launch_counts()
    metrics = floats(metrics)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    n_fwd, n_bwd = step_launches(cfg_)
    assert launches == {**dict.fromkeys(KERNELS, 0), f"flash_fwd_bhld_{mode}": n_fwd,
                        f"flash_bwd_bhld_fused_{mode}": n_bwd}, launches
    busy = device_busy(engine, state, batch)  # a second step, profiled
    busy_line = ("not measured (the profiler recorded no device time)" if busy is None else
                 f"{busy['device_ms']:.2f} ms of device time (torch.profiler, {busy['readings']} "
                 f"readings), attention kernels (name, calls, ms): {json.dumps(busy['flash'])}")
    print(f"    ({label}) {mode} flash_layout='bhld' step: {busy_line} on {card_line()}",
          flush=True)
    del engine, state
    cmp, plain, limits = relative_step_gate(
        fa, lambda **kw: train_cfg(exp16, dropout=0.0, flash_layout="bhld", **kw),
        ("cuda", params, d_params, batch, random_draws(cfg_, seed=11)), bf16=True)
    print(f"    ({label}) {mode} flash_layout='bhld' step: launches {launches}; metrics "
          f"{json.dumps(metrics)}; kernels vs use_pallas=False, both on the card, one step at "
          f"dropout 0: {json.dumps(cmp)}; the plain versions on the card vs the same: "
          f"{json.dumps(plain)} (limits {json.dumps(limits)}: metrics by bf16_metric_tol, "
          f"params beyond atol {PARAM_ATOL} per net)", flush=True)
    return launches


def whole_slide_bf16_serving(fa, cfg16, params, ws_batch, label) -> dict:
    """Phase 9 (f) / (h), 11 (d): `sample_all` of one whole-slide batch with
    the bf16 model (its launches: the forward of each kernel attention's
    route (`kernel_attentions`) in the model's mode, no other kernel: the
    classic one for the patch sequence), then one batch against `use_pallas=False`
    (the blocked reference), both on the card, within BF16_E2E_TOL of the
    output's largest entry. Returns the launches."""
    import torch

    from gemm_gan_tpu_torch.serving import GeneratorServer

    mode = "mxu" if cfg16.fusion.flash_mxu_bf16 else "bf16"
    server = GeneratorServer.from_flax(cfg16, params)
    server.sample_all([ws_batch], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.sample_all([ws_batch], 1, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()
    assert out["fake"].shape == (BATCH, cfg16.n_genes) and np.isfinite(out["fake"]).all()
    assert launches == {**dict.fromkeys(KERNELS, 0), **{
        f"flash_fwd_{route}_{mode}": n for route, n in kernel_attentions(
            cfg16, patches=WHOLE_SLIDE_PATCHES).items()}}, launches
    ref = dataclasses.replace(cfg16, fusion=dataclasses.replace(cfg16.fusion, use_pallas=False))
    z = torch.randn(BATCH, cfg16.latent_dim, generator=torch.Generator().manual_seed(4))
    with_kernels = server(z, ws_batch).cpu()
    with_reference = GeneratorServer.from_flax(ref, params)(z, ws_batch).cpu()
    scale = float(with_reference.abs().max())
    err = float((with_kernels - with_reference).abs().max())
    print(f"    ({label}) whole-slide {mode} serving, {WHOLE_SLIDE_PATCHES} patches x batch "
          f"{BATCH}: {BATCH / seconds:.1f} profiles/s ({seconds * 1e3:.1f} ms) on {card_line()}; "
          f"launches {launches}; kernels vs use_pallas=False (blocked reference), both on the "
          f"card: max|err|={err:.3e} (max|out|={scale:.3f}; within {BF16_E2E_TOL} x max|out|)",
          flush=True)
    assert err <= BF16_E2E_TOL * scale, (err, scale)
    return launches


def whole_slide_bf16_training(fa, exp16, params, d_params, ws_batch, label, f32_sps):
    """Phase 9 (g) / (h): WS_TRAIN_STEPS whole-slide steps of the bf16 model
    after a warm-up one (their launches: Q3, Q4, Q5 in the model's mode,
    16 / 12 / 12 per step, no other kernel), steps/s beside phase 6's f32
    `f32_sps`; then one dropout-free step against `use_pallas=False`, both
    on the card (`relative_step_gate`, as phase 6, in bf16). Returns (the
    launches, the peak memory of the timed steps in bytes, steps/s, a
    step's device ms or None)."""
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    cfg_ = train_cfg(exp16)
    mode = "mxu" if exp16.model.fusion.flash_mxu_bf16 else "bf16"
    engine = WGANGPEngine(cfg_, steps_per_epoch=1)
    state = engine.state_from_flax(params, d_params)
    torch.cuda.reset_peak_memory_stats()
    state, seconds, launches, metrics = run_steps(engine, state, [ws_batch], WS_TRAIN_STEPS, fa)
    peak = torch.cuda.max_memory_allocated()
    n_fwd, n_bwd = step_launches(cfg_)
    assert launches == {**dict.fromkeys(KERNELS, 0),
                        f"flash_fwd_bhld_{mode}": n_fwd * WS_TRAIN_STEPS,
                        f"flash_bwd_dq_{mode}": n_bwd * WS_TRAIN_STEPS,
                        f"flash_bwd_dkv_{mode}": n_bwd * WS_TRAIN_STEPS}, launches
    sps = WS_TRAIN_STEPS / seconds
    print(f"    ({label}) whole-slide {mode} training: {WS_TRAIN_STEPS} steps of batch {BATCH} x "
          f"{WHOLE_SLIDE_PATCHES} patches: {sps:.3f} steps/s ({seconds * 1e3 / WS_TRAIN_STEPS:.1f} "
          f"ms per step) against phase 6's f32 {f32_sps:.3f} steps/s ({sps / f32_sps:.3f}x) on "
          f"{card_line()}; peak memory {peak / 1e9:.3f} GB; launches {launches}; last metrics "
          f"{json.dumps(metrics)}", flush=True)
    device_ms = print_device_busy(f"({label}) whole-slide {mode} step", engine, state, ws_batch,
                                  seconds / WS_TRAIN_STEPS)
    del engine, state
    cmp, plain, limits = relative_step_gate(
        fa, lambda **kw: train_cfg(exp16, dropout=0.0, **kw),
        ("cuda", params, d_params, ws_batch, random_draws(cfg_, seed=12)), bf16=True)
    print(f"    ({label}) kernels vs use_pallas=False (blocked reference), both on the card, one "
          f"whole-slide {mode} step at dropout 0: {json.dumps(cmp)}; the plain versions on the "
          f"card vs the same: {json.dumps(plain)} (limits {json.dumps(limits)}: metrics by "
          f"bf16_metric_tol, params beyond atol {PARAM_ATOL} per net)", flush=True)
    return launches, peak, sps, device_ms


def print_device_busy(label, engine, state, batch, step_s):
    """More steps under torch.profiler (`device_busy`): a step's device
    time against `step_s` seconds per step by the host clock, and its top
    kernels. Returns the device ms (None when not measured)."""
    busy = device_busy(engine, state, batch)
    if busy is None:
        print(f"    {label}: device time not measured (the profiler saw no device time)",
              flush=True)
        return None
    print(f"    {label}: {busy['device_ms']:.1f} ms of device time (torch.profiler, "
          f"{busy['readings']} readings) against {step_s * 1e3:.1f} ms per step by the host "
          f"clock; {busy['aten_ops']} aten ops on the host; top kernels (name, calls, ms): "
          f"{json.dumps(busy['top'])}", flush=True)
    return busy["device_ms"]


def device_breakdown(server, batch) -> dict:
    """CUDA-event times (ms) of the serving path's parts for one batch: the
    conditioning's copy to the card, the condition embedding (fusion stack,
    run once per batch), one trunk evaluation (run once per repeat), and
    the copy of one repeat's profiles back to the host."""
    import torch

    with torch.inference_mode():
        cond = server.cond_tensors(batch)
        n = cond["tokens"].shape[0]
        cvec = server.gen.embed_cond(cond)
        z = torch.randn(n, server.cfg.latent_dim, device=server.device)
        fake = server.gen.score(z, cvec)
        return {"to_card": cuda_ms(lambda: server.cond_tensors(batch), iters=10),
                "embed_cond": cuda_ms(lambda: server.gen.embed_cond(cond), iters=10),
                "score": cuda_ms(lambda: server.gen.score(z, cvec), iters=10),
                "to_host": cuda_ms(lambda: fake.cpu(), iters=10)}


def flax_param_tree(m, seed: int, critic: bool = False) -> dict:
    """Random generator (or critic) params in the Flax layout, with the
    paths that `gemm_gan_tpu.models.gan.Generator.init` (`Critic.init`)
    gives them for model config `m`'s fusion kind (and, with
    `m.use_batchnorm`, each trunk block's BatchNorm `scale` and `bias`;
    `flax_batch_stats` gives its statistics)."""
    from gemm_gan_tpu_torch.fusion.modules import cond_dim_of

    rng = np.random.RandomState(seed)
    f = m.fusion
    E = f.cond_dim

    def arr(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.randn(*shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": arr(i, o, scale=i ** -0.5), "bias": arr(o, scale=0.01)}

    def norm(n):
        return {"scale": arr(n, scale=0.1, shift=1.0), "bias": arr(n, scale=0.1)}

    def mha():
        return {n: dense(E, E) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def layers():
        return {f"TransformerEncoderLayer_{i}": {
            "MaskedMultiHeadAttention_0": mha(), "LayerNorm_0": norm(E),
            "Dense_0": dense(E, f.ff_dim), "Dense_1": dense(f.ff_dim, E),
            "LayerNorm_1": norm(E)} for i in range(f.num_layers)}

    def patch_transformer(stack, encode_mlp=False):
        pt = {"patches_encoder": dense(f.patch_dim, E)}
        if encode_mlp:
            pt["LayerNorm_0"] = norm(E)
        return {**pt, "cls_token": arr(1, 1, E, scale=0.02), "patches_transformer": stack}

    def embed(n):
        return {"embedding": arr(n, f.label_embed_dim, scale=f.label_embed_dim ** -0.5)}

    fusion = None
    if f.kind == "film_xattn":  # the flagship's draws, in the order phases 3-10 take them
        stack = layers()
        fusion = {
            "film": {"film_proj": dense(f.text_dim, 2 * f.patch_dim)},
            "text_encoder": dense(f.text_dim, E),
            "_PatchTransformer_0": patch_transformer(stack),
            "patch2text_attention": mha(),
            "text2patch_attention": mha(),
        }
    elif f.kind == "xattn":
        fusion = {"text_encoder": dense(f.text_dim, E),
                  "_PatchTransformer_0": patch_transformer(layers()),
                  "patch2text_attention": mha(), "text2patch_attention": mha()}
    elif f.kind == "film":
        fusion = {"film": {"film_proj": dense(f.text_dim, 2 * f.patch_dim)},
                  "_PatchTransformer_0": patch_transformer(layers())}
    elif f.kind == "img_transformer":
        fusion = {"_PatchTransformer_0": patch_transformer(layers(), encode_mlp=True)}
    elif f.kind == "attention":
        fusion = {"text_encoder": dense(f.text_dim, E), "patches_encoder": dense(f.patch_dim, E),
                  "attention": mha(), "attn_norm": norm(E)}
    elif f.kind == "concat":
        fusion = {"encoder": dense(f.text_dim if f.condition_type == "text" else f.patch_dim, E)}
    elif f.kind == "labels":
        fusion = {"disease_embed": embed(f.n_disease_types),
                  "site_embed": embed(f.n_primary_sites)}
    C = cond_dim_of(f)
    if critic:
        dims, out = [m.n_genes + C, *m.disc_dims], 1
    else:
        dims, out = [m.latent_dim + C, *m.gen_dims], m.n_genes
    trunk = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        trunk[f"LinearBlock_{i}"] = {"Dense_0": dense(a, b)}
        if m.use_batchnorm:
            trunk[f"LinearBlock_{i}"]["BatchNorm_0"] = norm(b)
    trunk["Dense_0"] = dense(dims[-1], out)
    return {"trunk": trunk} if fusion is None else {"fusion": fusion, "trunk": trunk}


def flax_batch_stats(m, seed: int, critic: bool = False) -> dict:
    """Random BatchNorm statistics of a `use_batchnorm` trunk in Flax's
    `batch_stats` layout: each block's `mean` ~ 0.1 N(0, 1) and `var` in
    [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    dims = m.disc_dims if critic else m.gen_dims
    return {"trunk": {f"LinearBlock_{i}": {"BatchNorm_0": {
        "mean": (0.1 * rng.randn(h)).astype(np.float32),
        "var": (0.5 + rng.rand(h)).astype(np.float32)}} for i, h in enumerate(dims)}}


def train_cfg(cfg, **fusion):
    """`cfg` with the production step setting and the given fusion fields."""
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, fusion=dataclasses.replace(
            cfg.model.fusion, **fusion)),
        train=dataclasses.replace(cfg.train, cond_embed_reuse="per_update",
                                  batched_scores=True))


def attention_route(Lq: int, Lk: int) -> str:
    """Where `masked_mha` (ble layout) sends an attention of Lq queries over
    Lk keys: "ble" (Q1 / Q2), "bhld" (the classic kernels) or "plain" (the
    reference, for CLS-like queries)."""
    from gemm_gan_tpu_torch.kernels import flash_attention as fa

    if Lq < fa.MIN_PALLAS_LQ:
        return "plain"
    return "ble" if Lq <= fa.BLE_MAX_L and Lk <= fa.BLE_MAX_L else "bhld"


def kernel_attentions(cfg, patches: int = NUM_PATCHES, tokens: int = NUM_TOKENS) -> dict:
    """{route: count} of the attentions that one fusion forward of `cfg`'s
    kind sends to a kernel (`attention_route`), at `patches` patches and
    `tokens` text tokens: the patch transformer's self-attention, once per
    layer (img_transformer, film, xattn, film_xattn), and token
    cross-attention's two (xattn: the tokens over the patch sequence, then
    over the tokens). The CLS-query attentions (film_xattn's, the pooled
    attention's) and concat, labels and vanilla reach none."""
    f = cfg.model.fusion if hasattr(cfg, "model") else cfg.fusion
    calls = []
    if f.kind in ("img_transformer", "film", "xattn", "film_xattn"):
        calls += [attention_route(patches + 1, patches + 1)] * f.num_layers
    if f.kind == "xattn":
        calls += [attention_route(tokens, patches + 1), attention_route(tokens, tokens)]
    return {route: calls.count(route) for route in ("ble", "bhld") if route in calls}


def step_launches(cfg, n_attn: int = None) -> tuple:
    """Launches of one fused per_update step, from `train/wgan.py`: each
    fusion forward runs `n_attn` kernel attentions (by default those of
    `kernel_attentions` at the canonical shapes): the generator's embedding
    (1), each critic update's (n_critic, with grad), the generator update's
    critic embedding (1) and generator forward (1, with grad). With
    `train.grad_accum` = M the critic updates' embeddings and the
    generator's forward run once per microbatch (M times), the two
    embeddings without grad once at full batch. Returns (forwards,
    backwards)."""
    n = sum(kernel_attentions(cfg).values()) if n_attn is None else n_attn
    n_critic, M = cfg.train.n_critic, cfg.train.grad_accum
    return n * (2 + (n_critic + 1) * M), n * (n_critic + 1) * M


def random_draws(cfg, seed):
    rng = np.random.RandomState(seed)
    t, m = cfg.train, cfg.model
    return {"z": rng.randn(t.n_critic, BATCH, m.latent_dim).astype(np.float32),
            "alpha": rng.rand(t.n_critic, BATCH, 1).astype(np.float32),
            "z_gen": rng.randn(BATCH, m.latent_dim).astype(np.float32)}


def run_steps(engine, state, batches, n_steps, fa):
    """One warm-up step, then `n_steps` timed ones (host clock, ending in a
    synchronise). Returns (state, seconds, launch counts, last metrics)."""
    import torch

    state, _ = engine.step(state, batches[0])
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = engine.step(state, batches[(i + 1) % len(batches)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    return state, seconds, fa.launch_counts(), metrics


def run_step(cfg, device, g_params, d_params, batch, draws):
    """One step from the Flax-layout params with the given draws ->
    (state, metrics)."""
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device=device)
    state = engine.state_from_flax(g_params, d_params)
    state, metrics = engine.step(state, batch, draws=draws)
    return state, {k: float(v) for k, v in metrics.items()}


def step_diff(test, ref, max_loose=None, rtol=STEP_RTOL, atol=STEP_ATOL,
              metric_tol=None) -> dict:
    """Hold a step (state, metrics) against a reference one: metrics within
    rtol/atol (None: not held), or each within its `metric_tol[key]` when
    given; every param within RMSprop's bound; at most
    `max_loose` ({net: n}; {} counts without a limit; None: MAX_LOOSE over
    both nets) entries beyond PARAM_ATOL. Returns a summary dict."""
    import torch

    (got, m_got), (want, m_want) = test, ref
    loose_by_net, loose_clear, negligible, total = {}, 0, 0, 0
    max_err, beyond_bound = 0.0, False
    for net, opt_got, opt_want in (("G", got.g_opt, want.g_opt), ("D", got.d_opt, want.d_opt)):
        bound = 10 * opt_want.base_lr * opt_want.count
        rms = [nu.sqrt().cpu() for nu in opt_want.nu]
        net_rms = float(torch.cat([r.flatten() for r in rms]).square().mean().sqrt())
        loose_by_net[net] = 0
        for p_got, p_want, r in zip(opt_got.params, opt_want.params, rms):
            p_got, p_want = p_got.detach().cpu(), p_want.detach().cpu()
            diff = (p_got - p_want).abs()
            clear = r > NEGLIGIBLE_GRAD * net_rms
            loose_by_net[net] += int((diff > PARAM_ATOL).sum())
            loose_clear += int((diff[clear] > PARAM_ATOL).sum())
            negligible += int((~clear).sum())
            total += diff.numel()
            max_err = max(max_err, float(diff.max()))
            # two params that each moved the whole bound, the opposite
            # ways, differ by 2 x bound and the f32 roundings of their
            # updates (one each an update)
            slack = F32_EPS * opt_want.count * (p_got.abs() + p_want.abs())
            beyond_bound |= bool((diff > 2 * bound + slack).any())
    loose = sum(loose_by_net.values())
    summary = {"metrics_test": m_got, "metrics_ref": m_want, "params": total,
               "params_negligible_grad": negligible, "params_beyond_atol": loose,
               "beyond_atol_by_net": loose_by_net,
               "clear_grad_beyond_atol": loose_clear, "max_param_err": max_err}
    for key in m_want:
        tol = (metric_tol[key] if metric_tol is not None
               else None if rtol is None else atol + rtol * abs(m_want[key]))
        assert tol is None or abs(m_got[key] - m_want[key]) <= tol, (key, tol, summary)
    assert not beyond_bound, ("a param moved beyond RMSprop's bound", summary)
    if max_loose is None:
        assert loose <= MAX_LOOSE, summary
    else:
        assert all(loose_by_net[n] <= max_loose[n] for n in max_loose), (max_loose, summary)
    return summary


def relative_step_gate(fa, cfg_of, step_args, bf16: bool = False):
    """One step with the kernels against the same step with
    `use_pallas=False`, both on the card (`cfg_of(**fusion)` gives the
    config), gated by how far the kernels' own plain versions land from the
    same reference: per net at most PLAIN_LOOSE_FACTOR times their count of
    entries beyond PARAM_ATOL (or MAX_LOOSE, if more), besides the metrics
    and bound gates of `step_diff`. In bf16 (`bf16`) the plain versions'
    arithmetic (P and dS f32-exact) is not the reference's (P rounded to
    bf16 before P.V), and RMSprop carries any difference in rounding to
    the metrics: the plain versions' metrics are then not gated, and the
    kernels' are held by `bf16_metric_tol`. Returns (kernels' summary,
    plain versions' summary, the limits: params per net, and the metrics'
    in bf16)."""
    ref = run_step(cfg_of(use_pallas=False), *step_args)
    with plain_kernels(fa):
        plain = step_diff(run_step(cfg_of(), *step_args), ref, max_loose={},
                          rtol=None if bf16 else STEP_RTOL)
    max_loose = loose_limits(plain)
    metric_tol = bf16_metric_tol(ref[1], plain["metrics_test"]) if bf16 else None
    limits = max_loose if metric_tol is None else {"params": max_loose, "metrics": metric_tol}
    return (step_diff(run_step(cfg_of(), *step_args), ref, max_loose, metric_tol=metric_tol),
            plain, limits)


def bf16_metric_tol(ref: dict, yardstick: dict) -> dict:
    """How far each metric of a bf16 step may land from the reference
    step's `ref`: PLAIN_LOOSE_FACTOR times the yardstick step's distance,
    or BF16_STEP_RTOL of the metric's scale if more. bf16 rounding reaches
    the sign of most gradients, and RMSprop turns each sign into a +-10 lr
    move, so after n_critic updates the metrics scatter by a share of the
    critic's scores: the scale of d_loss, g_loss, d_real and d_fake (all in
    the critic's units) is the larger of |d_real| and |d_fake|, that of the
    penalty |gp|. (g_loss, small beside the scores, scattered by 21% of its
    own value in a whole-slide bf16 step on an NVIDIA H100 80GB HBM3 at
    700 W; 2% of the scores' scale.)"""
    scores = max(abs(ref["d_real"]), abs(ref["d_fake"]))
    return {k: max(BF16_STEP_RTOL * (abs(v) if k == "gp" else scores),
                   PLAIN_LOOSE_FACTOR * abs(yardstick[k] - v)) for k, v in ref.items()}


def loose_limits(yardstick: dict) -> dict:
    """Per net, PLAIN_LOOSE_FACTOR times the yardstick step's count of
    entries beyond PARAM_ATOL, or MAX_LOOSE if more."""
    return {net: max(MAX_LOOSE, PLAIN_LOOSE_FACTOR * n)
            for net, n in yardstick["beyond_atol_by_net"].items()}


class plain_kernels:
    """Within this context every kernel wrapper of `fa` runs its plain
    PyTorch version, also on CUDA tensors (a yardstick: the kernels' own
    contract in cuBLAS arithmetic, through the same dispatch)."""

    def __init__(self, fa):
        self.fa = fa
        self.saved = {k.__name__: k for k in fa.KERNELS}

    def __enter__(self):
        for name in self.saved:
            setattr(self.fa, name, getattr(self.fa, name + "_plain"))

    def __exit__(self, *exc):
        for name, kernel in self.saved.items():
            setattr(self.fa, name, kernel)


def agreed_profile(run, what: str):
    """torch.profiler over `run()` (`profiled`) until a whole reading
    records the same device work as the last whole one before it, key for
    key (each kernel, copy and memset as many times; `agreeing_reading`).
    Returns (that profile, its device records, the readings taken); raises
    after PROFILER_ATTEMPTS readings with none that agrees. Each reading
    runs `run` once more."""
    readings = []
    for n in range(1, PROFILER_ATTEMPTS + 1):
        prof, whole = profiled(run)
        records = device_records(prof)
        readings.append((whole, {e.key: e.count for e in records}))
        if agreeing_reading(readings) is not None:
            return prof, records, n
    raise RuntimeError(f"torch.profiler: no two whole readings of {what} agree in "
                       f"{PROFILER_ATTEMPTS} readings ({sum(w for w, _ in readings)} whole; "
                       f"last {len(records)} kinds of record)")


def device_busy(engine, state, batch) -> dict:
    """Device time of one step from `torch.profiler` (the sum of the device
    time of its kernels, copies and memsets; `agreed_profile`: steps are
    profiled until two in a row record the same work), the number of aten
    ops the host ran, the five kernels that took most, the attention kernels
    (`flash_*`) and the readings taken; None when the profiler records no
    device time."""
    from torch.autograd import DeviceType

    prof, records, readings = agreed_profile(lambda: engine.step(state, batch), "a step")
    events = [e for e in records if e.self_device_time_total > 0]
    if not events:
        return None
    events.sort(key=lambda e: -e.self_device_time_total)
    aten_ops = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "aten_ops": aten_ops, "readings": readings,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in events[:5]],
            "flash": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                      for e in events if "flash_" in e.key]}


def bank_data(cfg, n: int, seed: int, slots: int = BANK_SLOTS, min_valid: int = 64) -> dict:
    """A `DeviceCache` bank made on the card from `seed`: N(0, 1) genes
    [n, n_genes], patches [n, slots, patch_dim] with min_valid..slots valid
    slots per case, tokens [n, NUM_TOKENS, text_dim] with 16..NUM_TOKENS
    valid (the CLS token always), invalid entries zero."""
    import torch

    f = cfg.fusion
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ragged(L, lo):
        lens = torch.randint(lo, L + 1, (n,), generator=g, device="cuda")
        return torch.arange(L, device="cuda")[None, :] < lens[:, None]

    patch_mask, token_mask = ragged(slots, min_valid), ragged(NUM_TOKENS, 16)
    patches = torch.randn(n, slots, f.patch_dim, generator=g, device="cuda")
    tokens = torch.randn(n, NUM_TOKENS, f.text_dim, generator=g, device="cuda")
    return {"genes": torch.randn(n, cfg.n_genes, generator=g, device="cuda"),
            "patches": patches.mul_(patch_mask[..., None]), "patch_mask": patch_mask,
            "tokens": tokens.mul_(token_mask[..., None]), "token_mask": token_mask}


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def identical(a, b) -> bool:
    """Whether two (state, metrics) runs agree bit for bit."""
    import torch

    (sa, ma), (sb, mb) = a, b
    return (ma == mb and all(torch.equal(x, y) for net in ("gen", "critic") for x, y in
                             zip(getattr(sa, net).parameters(), getattr(sb, net).parameters())))


def replay_busy(engine, state, cache, epoch) -> dict:
    """torch.profiler over one `step_many_cached` epoch whose graph exists
    (replays only; `agreed_profile`: epochs are profiled until two in a row
    record the same work): device time of the kernels, copies and memsets
    per step, the host clock per step (ending in a synchronise), the count
    of device events per step, the five kernels that took most and the
    readings taken; None when the profiler records no device time."""
    import torch

    steps = cache.n_full_batches
    host_s = []

    def run():
        t0 = time.perf_counter()
        engine.step_many_cached(state, cache, epoch)
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)

    _, records, readings = agreed_profile(run, "an epoch of replays")
    events = [e for e in records if e.self_device_time_total > 0]
    if not events:
        return None
    events.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3 / steps,
            "host_ms": host_s[-1] * 1e3 / steps, "readings": readings,
            "device_events": sum(e.count for e in events) / steps,
            "top": [(e.key[:60], e.count / steps, e.self_device_time_total / 1e3 / steps)
                    for e in events[:5]],
            "by_name": {e.key: (e.count / steps, e.self_device_time_total / 1e3 / steps)
                        for e in events}}


def graph_pool_bytes():
    """Bytes the caching allocator holds in private pools (CUDA graphs'),
    from its segment snapshot; None when the snapshot does not say."""
    import torch

    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) != (0, 0))


def graphed_whole_slide_epochs(fa, cfg_, mode, bank, small, epoch_runs, fresh, eager) -> dict:
    """Phase 9 (j) in one bf16 mode (`mode`: "bf16" or "mxu"): a small
    whole-slide epoch through `step_many_cached` against the same steps run
    eagerly (`epoch_runs`: bitwise equality printed, `step_diff` gated),
    the replays' device time (`replay_busy`); then two epochs of the bank,
    the second of replays only, timed by the host clock: launches of Q3, Q4
    and Q5 in the mode equal to the replays (and the eager warm-up step)
    times `step_launches`, one replay records exactly `step_launches`, and
    no other kernel. Graphed steps/s printed beside 9 (g)'s / (h)'s eager
    ones (`eager`: steps/s, device ms). Returns the second epoch's launches."""
    import torch

    card = card_line()
    label = f"j, {mode}"
    runs = epoch_runs(cfg_, label, cache=small, paths=("step_many_cached",))
    g_engine, g_state, _ = runs["step_many_cached"]
    del runs
    busy = replay_busy(g_engine, g_state, small, 1)
    del g_engine, g_state
    n_fwd, n_bwd = step_launches(cfg_)
    names = (f"flash_fwd_bhld_{mode}", f"flash_bwd_dq_{mode}", f"flash_bwd_dkv_{mode}")
    per_step = dict(zip(names, (n_fwd, n_bwd, n_bwd)))
    engine, state = fresh(cfg_, bank)
    K = bank.n_full_batches
    epoch_s = []
    for e in (0, 1):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = engine.step_many_cached(state, bank, e)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        launches = fa.launch_counts()
        want = {**dict.fromkeys(KERNELS, 0), **{k: n * K for k, n in per_step.items()}}
        assert launches == want, (launches, want)
        metrics = floats(metrics)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    recorded = engine._cached_graphs[bank].recorded
    assert recorded == per_step, recorded
    pool = graph_pool_bytes()
    sps = K / epoch_s[1]
    eager_sps, eager_ms = eager
    eager_line = f"{eager_sps:.3f} steps/s" + ("" if eager_ms is None else
                                               f", {eager_ms:.1f} ms of device time a step")
    busy_line = ("not measured (the profiler saw no device time)" if busy is None else
                 f"{busy['device_ms']:.2f} ms of device time per step (torch.profiler, "
                 f"{busy['readings']} readings, {busy['device_events']:.0f} device events) / "
                 f"{busy['host_ms']:.2f} ms = busy {busy['device_ms'] / busy['host_ms']:.3f}; top "
                 f"kernels per step (name, calls, ms): {json.dumps(busy['top'])}")
    print(f"    ({label}) {K}-step whole-slide epochs through step_many_cached: epoch 0 (eager "
          f"warm-up step, capture, {K - 1} replays) {epoch_s[0]:.3f} s; epoch 1 ({K} replays) "
          f"{epoch_s[1]:.3f} s = {sps:.3f} steps/s ({epoch_s[1] * 1e3 / K:.1f} ms per step, host "
          f"clock) against 9 (g)/(h)'s eager {eager_line} ({sps / eager_sps:.2f}x) on {card}; "
          f"one replay launches {recorded}; launches per epoch {launches}; replayed steps of "
          f"the small epoch: {busy_line}; CUDA graph pools "
          f"{'not measured' if pool is None else f'{pool / 1e9:.3f} GB'}; last metrics "
          f"{json.dumps(metrics)}", flush=True)
    del engine, state
    return launches


def step_breakdown(engine, state, batch) -> dict:
    """CUDA-event times (ms) of one step's parts: the generator's condition
    embedding, one critic update, and the generator update."""
    import torch

    real, cond = engine._tensors(batch)
    state.gen.train()
    state.critic.train()
    g_cvec = engine.embed_generator(state, cond)
    z = torch.randn(BATCH, engine.cfg.model.latent_dim, device=engine.device)
    alpha = torch.rand(BATCH, 1, device=engine.device)
    return {"embed_generator": cuda_ms(lambda: engine.embed_generator(state, cond), iters=5),
            "critic_update": cuda_ms(lambda: engine.critic_update(
                state, real, cond, g_cvec, z, alpha), iters=5),
            "generator_update": cuda_ms(lambda: engine.generator_update(state, cond, z),
                                        iters=5)}


# phase 10, the product path: the cases of the TCGA layout it writes (split
# 64/16/20 by load_tcga), the product run's epochs and its flags
# (scripts/quality_experiment.py's settings through cli.train), and the
# cases of the resume check. Widths are the published ones:
# structured_dataset's 256 x 1024 patches and 300 x 768 tokens at 18,868
# genes; only the case count is cut.
PRODUCT_CASES, PRODUCT_EPOCHS, RESUME_CASES, PRODUCT_GENES = 768, 4, 128, 18868
PRODUCT_FLAGS = ("--variant", "film_cross_attention", "--freq_compute_test", "1",
                 "--checkpoint_every_eval", "--cond_embed_reuse", "per_update",
                 "--drift_epsilon", "1e-3", "--critic_scan", "--ema_decay", "0.999",
                 "--on_device_validation", "--validation_max_cases", "1024",
                 "--bank_dtype", "bfloat16", "--n_runs", "1")


def write_tcga_layout(root: str, data: dict, n: int, files_of: str = None) -> str:
    """The on-disk layout `load_tcga` reads (rna_seq.parquet, the text-CLS
    table, per-case patch and token npys, metainfos.pkl) for the first `n`
    cases of `data`; with `files_of` the per-case files are that layout's
    (linked, not copied)."""
    import pickle

    import pandas as pd

    d = os.path.join(root, f"tcga_{n}")
    os.makedirs(d)
    cases = [f"case-{i:04d}" for i in range(n)]
    pd.DataFrame(data["genes"][:n], index=pd.Index(cases, name="case_id"),
                 columns=[f"ENSG{i:05d}" for i in range(data["genes"].shape[1])]
                 ).to_parquet(os.path.join(d, "rna_seq.parquet"))
    pdir = os.path.join(d, "patch_embeddings_uni")
    tdir = os.path.join(d, "clinical_modernbert_embeddings")
    if files_of is not None:
        os.symlink(os.path.join(files_of, "patch_embeddings_uni"), pdir)
        os.symlink(os.path.join(files_of, "clinical_modernbert_embeddings"), tdir)
    else:
        os.makedirs(pdir)
        os.makedirs(tdir)
        for i, c in enumerate(cases):
            np.save(os.path.join(pdir, f"{c}.npy"), data["patches"][i])
            np.save(os.path.join(tdir, f"{c}.npy"), data["tokens"][i])
            np.save(os.path.join(tdir, f"{c}_attention_mask.npy"), data["token_mask"][i])
    # the text-CLS table the multi_patch schema reads: each case's first
    # (CLS) token
    cls = pd.DataFrame(data["tokens"][:n, 0], index=pd.Index(cases, name="case_id"))
    cls.columns = [str(c) for c in cls.columns]
    cls.to_parquet(os.path.join(d, "clinical_modernbert_embeddings.parquet"))
    metainfos = {c: {"disease_type": f"disease-{data['disease'][i]}",
                     "primary_site": f"site-{data['site'][i]}"} for i, c in enumerate(cases)}
    with open(os.path.join(d, "metainfos.pkl"), "wb") as f:
        pickle.dump(metainfos, f)
    return d


class PartTimer:
    """Seconds per part of the product path, by wrapping the functions that
    do each part (every timed call ends in a synchronise); `restore` puts
    the originals back."""

    def __init__(self):
        self.seconds = {}
        self._undo = []

    def wrap(self, owner, name, label, after=None):
        import torch

        orig = getattr(owner, name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            part = label(args) if callable(label) else label
            self.seconds.setdefault(part, []).append(round(time.perf_counter() - t0, 3))
            if after is not None:
                after(args, out)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


def all_finite(tree) -> bool:
    """Every number in a JSON-like tree is finite."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    return not isinstance(tree, float) or bool(np.isfinite(tree))


def checkpoint_tensors(payload, prefix=""):
    """(name, tensor) of every tensor in a checkpoint payload."""
    import torch

    if isinstance(payload, torch.Tensor):
        yield prefix, payload
    elif isinstance(payload, dict):
        for k, v in payload.items():
            yield from checkpoint_tensors(v, f"{prefix}/{k}")
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            yield from checkpoint_tensors(v, f"{prefix}/{i}")


def load_checkpoint(run_dir: str, which: str = "ckpt", step: int = None) -> dict:
    import torch

    from gemm_gan_tpu_torch.train.checkpoint import STATE_FILE, latest_step

    path = os.path.join(run_dir, which)
    step = latest_step(path) if step is None else step
    return torch.load(os.path.join(path, str(step), STATE_FILE), weights_only=True)


def product_launches(cfg, n_cases: int) -> dict:
    """Q1 / Q2 launches one product-run fit makes: `step_launches` per
    graphed step (every epoch's full batches) and the fusion's kernel
    attentions (`kernel_attentions`) in Q1 per generation batch (the
    generator embeds each batch once): each validation regenerates train
    and val, the test block train and test."""
    from gemm_gan_tpu_torch.data.splits import split_indices

    tr, va, te = (len(i) for i in split_indices(n_cases, seed=cfg.train.seed))
    B, ev, t = cfg.train.batch_size, cfg.eval, cfg.train
    batches = lambda n: -(-n // B)  # noqa: E731
    n_train_regen = min(batches(tr), max(1, (ev.validation_max_cases or tr) // B))
    validations = len([e for e in range(t.epochs - 1) if (e + 1) % t.freq_compute_test == 0])
    gen_batches = (validations * (n_train_regen + batches(va))
                   + ev.n_runs * (batches(tr) + batches(te)))
    steps = t.epochs * (tr // B)
    fwd, bwd = step_launches(cfg)
    per_batch = sum(kernel_attentions(cfg).values())
    return {"flash_fwd_ble": steps * fwd + gen_batches * per_batch,
            "flash_bwd_ble": steps * bwd, "steps": steps, "gen_batches": gen_batches,
            "per_batch": per_batch}


def product_path(fa, card, root: str) -> tuple:
    """Phase 10: the product path through `cli.train.main` at the published
    widths (see the module docstring), on a TCGA layout it writes under
    `root`. Returns (the launch counts of the product run's fit, the
    RESUME_CASES layout, which phase 11 (e) reads)."""
    import importlib.util

    import torch

    from gemm_gan_tpu_torch.cli import experiment as expmod
    from gemm_gan_tpu_torch.cli import train as cli_train
    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.data import tcga
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.eval import _sklearn_free as skf
    from gemm_gan_tpu_torch.eval import classifiers, detection
    from gemm_gan_tpu_torch.native import forest
    from gemm_gan_tpu_torch.train import checkpoint
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    have = {m: importlib.util.find_spec(m) is not None for m in ("sklearn", "matplotlib")}
    print(f"[10] the product path (cli.train): importable on this machine: {json.dumps(have)}",
          flush=True)
    t0 = time.perf_counter()
    data = structured_dataset(PRODUCT_CASES, n_genes=PRODUCT_GENES, seed=21)
    full = write_tcga_layout(root, data, PRODUCT_CASES)
    small = write_tcga_layout(root, data, RESUME_CASES, files_of=full)
    shapes = {k: data[k].shape[1:] for k in ("genes", "patches", "tokens")}
    del data
    print(f"    TCGA layout of {PRODUCT_CASES} cases written in "
          f"{time.perf_counter() - t0:.1f} s: {shapes} per case", flush=True)
    timer = PartTimer()
    saved, restored, epochs = [], [], []
    for owner, name, label in (
            (tcga, "load_tcga", "load"), (expmod.Experiment, "fit", "fit"),
            (expmod.Experiment, "_validation_eval", "validation"),
            (expmod.Experiment, "_test_block", "test block"),
            (expmod.Experiment, "evaluate", "evaluate"),
            (expmod.Experiment, "posthoc_utility", "posthoc utility"),
            (expmod.Experiment, "posthoc_privacy", "posthoc privacy"),
            (expmod, "gamma_coef", "gamma"), (expmod, "knn_detection", "kNN detection"),
            (expmod, "compute_prdc", "PRDC"), (detection, "compute_prdc", "PRDC"),
            (classifiers.MLPClassifier, "fit", lambda a: "MLP" if a[0].hidden else "LR"),
            (forest.HistForestClassifier, "fit", "RF"),
            (skf.LogisticRegression, "fit", "logistic regression (two-sample)"),
            (skf.PCA, "fit_transform", "PCA")):
        timer.wrap(owner, name, label)
    timer.wrap(expmod, "save_state", "checkpoint save", after=lambda a, step: saved.append(
        os.path.getsize(os.path.join(a[0], str(step), checkpoint.STATE_FILE))))
    for owner in (expmod, checkpoint):
        timer.wrap(owner, "restore_state", "checkpoint restore",
                   after=lambda a, state: restored.append((a[0], state.step)))
    timer.wrap(WGANGPEngine, "step_many_cached", "graphed epoch",
               after=lambda a, out: epochs.append(a[2].n_full_batches))
    try:
        out = os.path.join(root, "runs")
        run = os.path.join(out, "product")
        args = [*PRODUCT_FLAGS, "--data_dir", full, "--output_path", out,
                "--epochs", str(PRODUCT_EPOCHS)]
        fa.reset_launch_counts()
        results = cli_train.main([*args, "--run_name", "product"])
        counts = fa.launch_counts()
        fit_epochs = list(zip(epochs, timer.seconds["graphed epoch"]))
        cfg = load_config(os.path.join(run, "config.json"))
        want = product_launches(cfg, PRODUCT_CASES)
        print(f"    fit: launches {counts}; expected {json.dumps(want)} "
              f"({want['steps']} graphed steps x step_launches {step_launches(cfg)}, "
              f"{want['gen_batches']} generation batches x {cfg.model.fusion.num_layers} "
              f"layers)", flush=True)
        assert counts == {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble": want["flash_fwd_ble"],
                          "flash_bwd_ble": want["flash_bwd_ble"]}, (counts, want)
        with open(os.path.join(run, "product_metrics.jsonl")) as f:
            logged = [json.loads(r) for r in f]
        with open(os.path.join(run, "val_metrics.json")) as f:
            val = json.load(f)
        last = load_checkpoint(run)
        assert all_finite(logged) and all_finite(val) and all_finite(results), "non-finite"
        assert all(bool(torch.isfinite(t).all()) for _, t in checkpoint_tensors(last)
                   if t.is_floating_point()), "non-finite state"
        assert [r["epoch"] for r in val] == list(range(PRODUCT_EPOCHS - 1)), val
        steady = fit_epochs[1:]
        sps = sum(k for k, _ in steady) / sum(s for _, s in steady)
        print(f"    fit: {want['steps']} steps in {PRODUCT_EPOCHS} graphed epochs of "
              f"{fit_epochs[0][0]} (epoch seconds {[s for _, s in fit_epochs]}, the first "
              f"with the capture); graphed {sps:.2f} steps/s over epochs 1.. inside fit on "
              f"{card}; gamma {results['gamma_mean']:.4f}; validation (KNN accuracy, "
              f"precision, recall, coverage): "
              f"{[(r['detection']['KNN']['accuracy'], round(r['metrics']['precision'], 4), round(r['metrics']['recall'], 4), round(r['metrics']['coverage'], 4)) for r in val]}",
              flush=True)
        print(f"    test block (run 0): {json.dumps(results['runs'][0]['detection'])}; "
              f"checkpoint bytes {saved}", flush=True)
        print(f"    seconds per part of the product run (cli.train: load, fit, post-hoc "
              f"suites) on {card}: {json.dumps(timer.seconds)}", flush=True)
        timer.seconds.clear()

        with open(os.path.join(run, "best.json")) as f:
            best = json.load(f)
        assert os.path.exists(os.path.join(run, "ckpt_best", str(best["step"]),
                                           checkpoint.STATE_FILE)), best
        restored.clear()
        res_best = cli_train.main([*args, "--run_name", "product", "--evaluate_only",
                                   "--evaluate_which", "best"])
        assert [(os.path.basename(p), s) for p, s in restored] == [
            ("ckpt_best", best["step"])], (restored, best)
        assert all_finite(res_best)
        dumps = os.path.join(run, f"test_0_epoch_{PRODUCT_EPOCHS}")
        before = {f: np.load(os.path.join(dumps, f)) for f in sorted(os.listdir(dumps))}
        restored.clear()
        cli_train.main([*args, "--run_name", "product", "--evaluate_only"])
        assert [s for _, s in restored] == [want["steps"]], restored
        same = {f: bool(np.array_equal(a, np.load(os.path.join(dumps, f))))
                for f, a in before.items()}
        print(f"    best.json {json.dumps(best)}: evaluate('best') restored step "
              f"{best['step']} (gamma {res_best['gamma_mean']:.4f}); evaluate('last') "
              f"regenerated the test block's {len(same)} arrays bitwise equal: "
              f"{all(same.values())}", flush=True)
        assert all(same.values()), same
        print(f"    seconds per part of evaluate best, then last (cli.train "
              f"--evaluate_only) on {card}: {json.dumps(timer.seconds)}", flush=True)

        # resume: B stops after epoch 2 and resumes to PRODUCT_EPOCHS with
        # --resume; A runs straight through. Both validate every epoch, so
        # they validate at different epochs (A after 0, 1, 2; B after 0,
        # then 2)
        timer.seconds.clear()
        small_args = [*PRODUCT_FLAGS, "--data_dir", small, "--output_path", out]
        cli_train.main([*small_args, "--run_name", "straight", "--epochs",
                        str(PRODUCT_EPOCHS)])
        cli_train.main([*small_args, "--run_name", "resumed", "--epochs", "2"])
        cli_train.main([*small_args, "--run_name", "resumed", "--epochs",
                        str(PRODUCT_EPOCHS), "--resume"])
        with open(os.path.join(out, "resumed", "val_metrics.json")) as f:
            assert [r["epoch"] for r in json.load(f)] == [0, 2]
        pa, pb = (load_checkpoint(os.path.join(out, r)) for r in ("straight", "resumed"))
        a, b = dict(checkpoint_tensors(pa)), dict(checkpoint_tensors(pb))
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        counts_of = lambda p: (p["step"], p["g_opt"]["count"], p["d_opt"]["count"])  # noqa: E731
        if counts_of(pa) != counts_of(pb):
            differ.append(f"step and counts {counts_of(pa)} vs {counts_of(pb)}")
        print(f"    resume ({RESUME_CASES} cases): 2 epochs, then --resume to "
              f"{PRODUCT_EPOCHS}, against {PRODUCT_EPOCHS} straight: {len(a)} tensors of "
              f"the final checkpoints (params, optimizer moments and counts, EMA, step, "
              f"generators), {len(differ)} differ {differ[:4]}; seconds per part "
              f"{json.dumps(timer.seconds)}", flush=True)
        assert a.keys() == b.keys() and not differ, differ
    finally:
        timer.restore()
    return counts, small


# phase 11, the paper's other variants (the ablation of the reference's
# model files) at the published widths, in this order; the label oracle's
# tables are sized by structured_dataset's classes and sites, as cli.train
# sizes them from the data
VARIANTS = ("concat_text", "concat_image", "attention", "img_transformer", "film",
            "cross_attention", "benchmark")
LABEL_VOCAB = dict(n_disease_types=8, n_primary_sites=4)
# the cases of (c)'s bank: 32 graphed steps an epoch
VARIANT_BANK_CASES = 256
# (e): cli.train for these variants on phase 10's RESUME_CASES layout
VARIANT_CLI = ("cross_attention", "film")
VARIANT_CLI_EPOCHS = 2


def variant_data(n: int, seed: int, num_patches: int = NUM_PATCHES) -> dict:
    """structured_dataset at the published widths with every conditioning
    key: the text CLS vector (`text_emb`) is each case's first token, the
    token mask ragged (16..NUM_TOKENS valid, the CLS token always, padded
    tokens zero), so token cross-attention's second attention runs on
    ragged keys."""
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset

    d = structured_dataset(n=n, n_genes=PRODUCT_GENES, num_patches=num_patches, seed=seed,
                           n_classes=LABEL_VOCAB["n_disease_types"],
                           n_sites=LABEL_VOCAB["n_primary_sites"])
    lens = np.random.RandomState(seed).randint(16, NUM_TOKENS + 1, n)
    d["token_mask"] = np.arange(NUM_TOKENS)[None, :] < lens[:, None]
    d["tokens"] *= d["token_mask"][..., None]
    d["text_emb"] = d["tokens"][:, 0].copy()
    d["disease"], d["site"] = d["disease"].astype(np.int32), d["site"].astype(np.int32)
    return d


def variant_serving(fa, cfg, params, batches, label) -> dict:
    """11 (a): `sample_all` (REPEATS repeats) of the variant's generator on
    the card; its launches are Q1 once per kernel attention of the fusion
    (`kernel_attentions`) and batch, no other kernel; one batch card vs CPU
    within E2E_RTOL / E2E_ATOL, as phase 3. Returns the launches."""
    import torch

    from gemm_gan_tpu_torch.serving import GeneratorServer

    server = GeneratorServer.from_flax(cfg, params)
    server.sample_all(batches[:1], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.sample_all(batches, REPEATS, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()
    n = BATCH * len(batches) * REPEATS
    assert out["fake"].shape == (n, cfg.n_genes) and np.isfinite(out["fake"]).all()
    per_batch = kernel_attentions(cfg)
    assert launches == {**dict.fromkeys(KERNELS, 0), **{
        f"flash_fwd_{route}": k * len(batches) for route, k in per_batch.items()}}, launches
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    on_card = server(z, batches[0]).cpu()
    on_cpu = GeneratorServer.from_flax(cfg, params, device="cpu")(z, batches[0])
    err = float((on_card - on_cpu).abs().max())
    print(f"    ({label}) serving: {n / seconds:.1f} profiles/s ({seconds * 1e3:.1f} ms for {n}) "
          f"on {card_line()}; launches {launches}; one batch card vs CPU max|err|={err:.3e} "
          f"(max|out|={float(on_cpu.abs().max()):.3f}; rtol {E2E_RTOL}, atol {E2E_ATOL})",
          flush=True)
    torch.testing.assert_close(on_card, on_cpu, rtol=E2E_RTOL, atol=E2E_ATOL)
    return launches


def attention_gate(fa, cfg, device, g_params, d_params, batch) -> dict:
    """11 (b)'s gate, ahead of the ReLUs that make whole-net gradients jump:
    each kernel attention (Q1 / Q2) of both nets' fusions at the step's
    starting params (dropout 0), on the inputs that the CPU forward gives
    it (q, k, v, mask), under a fixed seeded cotangent of its output: the
    output and the gradients w.r.t. q, k and v computed by the kernels on
    `device` (the card; "cpu" in the tests), by the plain versions there
    (`plain_kernels`, the yardstick) and by the plain versions on the CPU. Each tensor may lie
    from the CPU's (||x - x_cpu|| / ||x_cpu||) at most PLAIN_LOOSE_FACTOR
    times as far as the yardstick's, or ATTN_GATE_FLOOR if more; the gate
    must reject two negative controls (`perturbed_forward`): Q1's output
    scaled by ATTN_CONTROL_SCALE, and the last valid key of every row
    masked out. Raises otherwise; returns the distances' largest ratios to
    their limits (the kernels', the controls'), the attentions gated and
    the kernels' launches."""
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device="cpu")
    state = engine.state_from_flax(g_params, d_params)
    _, cond = engine._tensors(batch)
    calls, kernel_call = [], fa.flash_mha_ble

    def record(q, k, v, kv_mask=None, scale=None, num_heads=4, mxu_bf16=False):
        calls.append((q.detach().clone(), k.detach().clone(), v.detach().clone(),
                      kv_mask, scale, num_heads, mxu_bf16))
        return kernel_call(q, k, v, kv_mask, scale=scale, num_heads=num_heads,
                           mxu_bf16=mxu_bf16)

    fa.flash_mha_ble = record
    try:
        with torch.no_grad():
            for net in (state.critic, state.gen):
                net.fusion(cond)
    finally:
        fa.flash_mha_ble = kernel_call
    assert calls, "no kernel attention in the fusions"
    g = torch.Generator().manual_seed(61)
    cots = [torch.randn(q.shape, generator=g) for q, *_ in calls]

    def run(device):
        out = []
        for (q, k, v, mask, scale, heads, mxu), cot in zip(calls, cots):
            q, k, v = (t.to(device).requires_grad_() for t in (q, k, v))
            o = fa.flash_mha_ble(q, k, v, None if mask is None else mask.to(device),
                                 scale=scale, num_heads=heads, mxu_bf16=mxu)
            grads = torch.autograd.grad(o, (q, k, v), cot.to(device))
            out.append({n: t.detach().double().cpu()
                        for n, t in zip(("o", "dq", "dk", "dv"), (o, *grads))})
        return out

    cpu = run("cpu")
    with plain_kernels(fa):
        plain = run(device)
    fa.reset_launch_counts()
    runs = {"kernels": run(device)}
    launches = {k: n for k, n in fa.launch_counts().items() if n}
    for how in ("scaled", "last_key_masked"):
        with perturbed_forward(fa, "flash_fwd_ble", how, ATTN_CONTROL_SCALE):
            runs[how] = run(device)
    summary = {"attentions": len(calls), "launches": launches,
               "plain_largest": max(_relative(p[n], c[n]) for p, c in zip(plain, cpu) for n in c)}
    for label, got in runs.items():
        summary[label] = max(
            (_relative(x[n], c[n]) / max(PLAIN_LOOSE_FACTOR * _relative(p[n], c[n]),
                                         ATTN_GATE_FLOOR), f"attention {i} {n}")
            for i, (x, p, c) in enumerate(zip(got, plain, cpu)) for n in c)
    assert summary["kernels"][0] <= 1, ("the attention gate rejects the kernels", summary)
    for how in ("scaled", "last_key_masked"):
        assert summary[how][0] > 1, (f"the attention gate accepts the {how} control", summary)
    return summary


def variant_step(fa, exp, params, d_params, batch, label) -> dict:
    """11 (b): one dropout-free f32 step on the card against the same step
    on the CPU: metrics within STEP_RTOL / STEP_ATOL and every param within
    RMSprop's bound, as phase 5, and its launches by `step_launches`.
    Printed beside it, not held: phase 5's count of params beyond
    PARAM_ATOL, the kernels' and the plain versions' on the card
    (`plain_kernels`), and the distances of their first gradients from the
    CPU's (phase 9 (b)'s fusion gradients). Over n_critic RMSprop updates
    f32 rounding turns into +-10 lr moves chaotically, so two right steps
    can miss PARAM_ATOL on a few hundred entries or on a hundred thousand;
    and an f32 ReLU whose input is within rounding of 0 flips one way or
    the other, moving the first gradients in a jump (PERF.md gives both).
    A variant with no kernel attention runs the same ops either way; one
    that has some is held by `attention_gate` at its kernel attentions'
    outputs and input gradients. Returns the launches."""
    import torch

    cfg0 = train_cfg(exp, dropout=0.0)
    args = (params, d_params, batch, random_draws(cfg0, seed=31))
    cot = fusion_cotangents(cfg0, *args)

    def grads(device):
        return fusion_grads(cfg0, device, params, d_params, batch, cot)

    on_cpu = run_step(cfg0, "cpu", *args)
    cpu_grads = grads("cpu")
    with plain_kernels(fa):
        plain = step_diff(run_step(cfg0, "cuda", *args), on_cpu, max_loose={})
        plain_grads = grad_distances(grads("cuda"), cpu_grads)
    fa.reset_launch_counts()
    got = run_step(cfg0, "cuda", *args)
    torch.cuda.synchronize()
    launches = fa.launch_counts()
    n_fwd, n_bwd = step_launches(cfg0)
    assert launches == {**dict.fromkeys(KERNELS, 0),
                        **({"flash_fwd_ble": n_fwd, "flash_bwd_ble": n_bwd} if n_fwd else {})}, \
        launches
    cmp = step_diff(got, on_cpu, max_loose={})
    print(f"    ({label}) one f32 step at dropout 0, card vs CPU: {json.dumps(cmp)} (metrics "
          f"rtol {STEP_RTOL}, atol {STEP_ATOL}); the plain versions' step on the card vs CPU: "
          f"params beyond atol {PARAM_ATOL} {plain['beyond_atol_by_net']}; the fusions' first "
          f"gradients' distances from the CPU's (not held): kernels "
          f"{json.dumps(grad_distances(grads('cuda'), cpu_grads))}, plain versions "
          f"{json.dumps(plain_grads)}; launches {launches}", flush=True)
    if n_fwd:
        gate = attention_gate(fa, cfg0, "cuda", params, d_params, batch)
        print(f"    ({label}) attention gate (each kernel attention's output and q / k / v "
              f"gradients under a fixed cotangent, card kernels vs CPU, at most "
              f"{PLAIN_LOOSE_FACTOR} x the plain versions' distance on the card or "
              f"{ATTN_GATE_FLOOR}; largest ratio to its limit): {json.dumps(gate)}; the "
              f"controls scale flash_fwd_ble's output by {ATTN_CONTROL_SCALE} or mask the last "
              f"valid key of every row", flush=True)
    return launches


def variant_epochs(fa, tcfg, params, d_params, arrays, label) -> dict:
    """11 (c): the graphed epoch of the variant (dropout 0.1), from a
    `DeviceCache` of `arrays` (what the variant reads, on the card; bf16
    store, NUM_PATCHES a step): a SMALL_CASES epoch through
    `step_many_cached` against the same steps run eagerly (bitwise equality
    printed, `step_diff` gated) and its replays' device time
    (`replay_busy`); then two epochs of the whole bank, the second of
    replays only, timed: launches equal the replays (and the warm-up step)
    times `step_launches`, and one replay records exactly that. Returns the
    second epoch's launches."""
    import torch

    from gemm_gan_tpu_torch.data.device_cache import DeviceCache
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    cache_kw = dict(batch_size=BATCH, num_patches=NUM_PATCHES, seed=0,
                    embedding_store_dtype=torch.bfloat16)
    bank = DeviceCache(arrays, **cache_kw)
    small = DeviceCache({k: v[:SMALL_CASES] for k, v in arrays.items()}, **cache_kw)

    def fresh(cache):
        engine = WGANGPEngine(tcfg, steps_per_epoch=cache.n_full_batches)
        return engine, engine.state_from_flax(params, d_params, seed=0)

    runs = {}
    for path in ("step_many_cached", "eager"):
        engine, state = fresh(small)
        torch.manual_seed(0)  # dropout
        if path == "eager":
            for b in small.epoch(0):
                state, m = engine.step(state, b)
        else:
            state, m = engine.step_many_cached(state, small, 0)
        torch.cuda.synchronize()
        runs[path] = (engine, state, floats(m))
    same = identical(runs["step_many_cached"][1:], runs["eager"][1:])
    cmp = step_diff(runs["step_many_cached"][1:], runs["eager"][1:])
    busy = replay_busy(*runs["step_many_cached"][:2], small, 1)
    del runs
    n_fwd, n_bwd = step_launches(tcfg)
    per_step = {"flash_fwd_ble": n_fwd, "flash_bwd_ble": n_bwd} if n_fwd else {}
    engine, state = fresh(bank)
    K = bank.n_full_batches
    epoch_s = []
    for e in (0, 1):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = engine.step_many_cached(state, bank, e)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        launches = fa.launch_counts()
        assert launches == {**dict.fromkeys(KERNELS, 0),
                            **{k: n * K for k, n in per_step.items()}}, launches
        metrics = floats(metrics)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    recorded = engine._cached_graphs[bank].recorded
    assert recorded == per_step, recorded
    busy_line = ("not measured (the profiler saw no device time)" if busy is None else
                 f"{busy['device_ms']:.2f} ms of device time per step ({busy['readings']} "
                 f"readings, {busy['device_events']:.0f} device events) / {busy['host_ms']:.2f} "
                 f"ms = busy {busy['device_ms'] / busy['host_ms']:.3f}; top kernels per step "
                 f"(name, calls, ms): {json.dumps(busy['top'])}")
    print(f"    ({label}) graphed epoch: {SMALL_CASES // BATCH} steps through step_many_cached "
          f"vs eager: bitwise equal {same}; {json.dumps(cmp)}; {K}-step epochs: epoch 0 (eager "
          f"warm-up step, capture, {K - 1} replays) {epoch_s[0]:.3f} s, epoch 1 ({K} replays) "
          f"{epoch_s[1]:.3f} s = {K / epoch_s[1]:.2f} steps/s ({epoch_s[1] * 1e3 / K:.2f} ms "
          f"per step, host clock) on {card_line()}; one replay launches {recorded}; replayed "
          f"steps: {busy_line}; last metrics {json.dumps(metrics)}", flush=True)
    del engine, state, bank, small
    return launches


def variant_bench(fa, exp, params, d_params, batches, ws_batch, label) -> dict:
    """11 (d), token cross-attention in the bench configuration: canonical
    serving (`bf16_serving`) and one step through phase 9 (b)'s gates
    (`bf16_step`) in bf16 and under mxu_bf16; then at WHOLE_SLIDE_PATCHES in
    bf16 one serving batch against `use_pallas=False` on the card
    (`whole_slide_bf16_serving`) and one step through `relative_step_gate`,
    its launches (Q3 / Q4 / Q5 for the patch sequence and the text queries
    over it, Q1 / Q2 for the text queries over the tokens) asserted.
    Returns {path: launches}."""
    import torch

    launches = {}
    exp16 = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                               compute_dtype="bfloat16"))
    for mode, e in (("bf16", exp16), ("mxu", train_cfg(exp16, flash_mxu_bf16=True))):
        launches[f"{label}_{mode}_serving"] = bf16_serving(
            fa, e.model, params, batches, f"{label}, {mode}", f"flash_fwd_ble_{mode}")
        launches[f"{label}_{mode}_step"] = bf16_step(fa, e, params, d_params, batches[0],
                                                     f"{label}, {mode}")
    launches[f"{label}_whole_slide_bf16_serving"] = whole_slide_bf16_serving(
        fa, exp16.model, params, ws_batch, f"{label}, whole slide")
    cfg_of = lambda **kw: train_cfg(exp16, dropout=0.0, **kw)  # noqa: E731
    fa.reset_launch_counts()
    cmp, plain, limits = relative_step_gate(
        fa, cfg_of, ("cuda", params, d_params, ws_batch, random_draws(cfg_of(), seed=33)),
        bf16=True)
    torch.cuda.synchronize()
    got = fa.launch_counts()  # the kernel step's: the other two launch nothing
    want = dict.fromkeys(KERNELS, 0)
    for route, n in kernel_attentions(exp16, patches=WHOLE_SLIDE_PATCHES).items():
        n_fwd, n_bwd = step_launches(cfg_of(), n)
        want[f"flash_fwd_{route}_bf16"] = n_fwd
        for bwd in (("flash_bwd_dq", "flash_bwd_dkv") if route == "bhld" else ("flash_bwd_ble",)):
            want[f"{bwd}_bf16"] = n_bwd
    assert got == want, (got, want)
    launches[f"{label}_whole_slide_bf16_step"] = got
    print(f"    ({label}) whole-slide bf16 step at dropout 0, kernels vs use_pallas=False, both "
          f"on the card: {json.dumps(cmp)}; the plain versions vs the same: {json.dumps(plain)} "
          f"(limits {json.dumps(limits)}); launches {got}", flush=True)
    return launches


def variant_cli(fa, variant, layout, out, card) -> dict:
    """11 (e): `cli.train` with phase 10's flags for `variant`,
    VARIANT_CLI_EPOCHS epochs on `layout` (phase 10's RESUME_CASES cases),
    one test run. Gates: finite logged, validation and test metrics,
    `best.json` and its checkpoint, and Q1 / Q2 launches over `fit` as
    `product_launches` counts them. Returns the launches."""
    from gemm_gan_tpu_torch.cli import train as cli_train
    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.train import checkpoint

    flags = list(PRODUCT_FLAGS)
    flags[flags.index("--variant") + 1] = variant
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    results = cli_train.main([*flags, "--data_dir", layout, "--output_path", out,
                              "--epochs", str(VARIANT_CLI_EPOCHS), "--run_name", variant])
    seconds = time.perf_counter() - t0
    counts = fa.launch_counts()
    run = os.path.join(out, variant)
    cfg = load_config(os.path.join(run, "config.json"))
    want = product_launches(cfg, RESUME_CASES)
    assert counts == {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble": want["flash_fwd_ble"],
                      "flash_bwd_ble": want["flash_bwd_ble"]}, (counts, want)
    with open(os.path.join(run, f"{variant}_metrics.jsonl")) as f:
        logged = [json.loads(r) for r in f]
    with open(os.path.join(run, "val_metrics.json")) as f:
        val = json.load(f)
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    assert all_finite(logged) and all_finite(val) and all_finite(results), "non-finite"
    assert os.path.exists(os.path.join(run, "ckpt_best", str(best["step"]),
                                       checkpoint.STATE_FILE)), best
    print(f"    (e) cli.train --variant {variant}, {VARIANT_CLI_EPOCHS} epochs on "
          f"{RESUME_CASES} cases: {seconds:.1f} s on {card}; launches {counts} = "
          f"{want['steps']} graphed steps x step_launches {step_launches(cfg)} + "
          f"{want['gen_batches']} generation batches x {want['per_batch']}; best.json "
          f"{json.dumps(best)}; gamma {results['gamma_mean']:.4f}; test block (run 0) "
          f"detection {json.dumps(results['runs'][0]['detection'])}", flush=True)
    return counts


def variants_phase(fa, card, ws_batch, layout, out) -> dict:
    """Phase 11: every variant of VARIANTS at the published widths (random
    Flax-layout weights from seeded numpy trees, carried over by
    `convert.py`): (a) serving, (b) one f32 step against the CPU, (c) the
    graphed epoch; (d) token cross-attention in the bench configuration;
    (e) `cli.train` for VARIANT_CLI on `layout`. Returns {path: launches}."""
    import torch

    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.serving import cond_keys_for

    t_phase = time.perf_counter()
    print(f"[11] the variants at the published widths: {', '.join(VARIANTS)}", flush=True)
    data = variant_data(BATCH * N_BATCHES, seed=40)
    # (c)'s bank, made on the card: phase 8's ragged patch slots and tokens,
    # the text CLS vector (the first token) and the labels
    bank = bank_data(variant_config("film_cross_attention").model, VARIANT_BANK_CASES, seed=41)
    g = torch.Generator(device="cuda").manual_seed(42)
    bank["text_emb"] = bank["tokens"][:, 0].clone()
    for key, n in (("disease", "n_disease_types"), ("site", "n_primary_sites")):
        bank[key] = torch.randint(0, LABEL_VOCAB[n], (VARIANT_BANK_CASES,), generator=g,
                                  device="cuda", dtype=torch.int32)
    launches, seconds = {}, {}
    for i, variant in enumerate(VARIANTS):
        t0 = time.perf_counter()
        exp = variant_config(variant, fusion_kw=LABEL_VOCAB)
        cfg = exp.model
        params = flax_param_tree(cfg, seed=50 + 2 * i)
        d_params = flax_param_tree(cfg, seed=51 + 2 * i, critic=True)
        keys = cond_keys_for(cfg.fusion)
        batches = [{k: data[k][j * BATCH:(j + 1) * BATCH] for k in (*keys, "genes")}
                   for j in range(N_BATCHES)]
        print(f"  {variant} (fusion {cfg.fusion.kind}, reads {list(keys)}; kernel attentions "
              f"per fusion forward {kernel_attentions(cfg)})", flush=True)
        launches[f"{variant}_serving"] = variant_serving(fa, cfg, params, batches,
                                                         f"{variant}, a")
        launches[f"{variant}_step"] = variant_step(fa, exp, params, d_params, batches[0],
                                                   f"{variant}, b")
        launches[f"{variant}_epoch"] = variant_epochs(
            fa, train_cfg(exp), params, d_params, {k: bank[k] for k in ("genes", *keys)},
            f"{variant}, c")
        if variant == "cross_attention":
            launches.update(variant_bench(fa, exp, params, d_params, batches,
                                          {k: ws_batch[k] for k in (*keys, "genes")},
                                          f"{variant}, d"))
        torch.cuda.empty_cache()
        seconds[variant] = round(time.perf_counter() - t0, 1)
    del bank
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for variant in VARIANT_CLI:
        launches[f"{variant}_cli"] = variant_cli(fa, variant, layout, out, card)
    seconds["cli.train"] = round(time.perf_counter() - t0, 1)
    print(f"    phase 11 took {time.perf_counter() - t_phase:.1f} s on {card}: seconds per "
          f"variant (a)-(d) {json.dumps(seconds)}", flush=True)
    return launches


# phase 12, the post-hoc evaluator over phase 10's product run: the
# float64 checks' tolerances (the exact optimal transport against scipy's
# assignment over an independently built cost; the f32 MMDs against numpy
# in float64)
OT_RTOL, POSTHOC_MMD_RTOL = 1e-9, 1e-4


def quiet(fn, *args):
    """`fn(*args)` with its standard output dropped (`cli.evaluate` prints
    its whole report, which the phases print in short)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def host_cost(x0, x1) -> np.ndarray:
    """Squared L2 distances [n, m] in float64 on the host, one row of x0 at
    a time (independent of `eval.distances.cost_matrix`)."""
    h1 = np.asarray(x1, np.float64)
    out = np.empty((len(x0), len(x1)))
    for i, row in enumerate(np.asarray(x0, np.float64)):
        d = row - h1
        out[i] = np.einsum("ij,ij->i", d, d)
    return out


def numpy_mmds(x, y) -> dict:
    """The linear and polynomial (d 2, alpha 1, c 2) linear-time MMDs in
    float64 over the first min(n, m) rows."""
    n = min(len(x), len(y))
    x, y = np.asarray(x[:n], np.float64), np.asarray(y[:n], np.float64)
    d = x - y

    def k(u, v):
        return np.mean((np.sum(u[:-1] * v[1:], axis=1) + 2.0) ** 2)

    return {"Linear_MMD": float(np.mean(np.sum(d[:-1] * d[1:], axis=1))),
            "Poly_MMD": float(k(x, x) + k(y, y) - k(x, y) - k(y, x))}


def posthoc_phase(fa, card, run: str) -> dict:
    """Phase 12: `cli.evaluate.main` over phase 10's product run directory
    (`--epoch auto`: best.json's epoch; the utility suites on). Gates:
    every number finite; each dump's exact 1- / 2-Wasserstein against
    scipy's `linear_sum_assignment` over a float64 cost built on the host
    (the dumps are square with uniform marginals, so the optima are the
    same) within OT_RTOL; Linear / Poly MMD within POSTHOC_MMD_RTOL of numpy
    in float64; DCR / NNDR equal `Experiment.posthoc_privacy`'s for the
    same directory and reference (the dump's data_real); `PrivacyEvaluator`
    over the run finite; `--plots` without matplotlib raises naming it.
    Prints the seconds of each part and Sinkhorn's 2-Wasserstein beside
    the exact one. Returns the launches (none: no kernel is on this path)."""
    from types import SimpleNamespace

    import torch
    from scipy.optimize import linear_sum_assignment

    from gemm_gan_tpu_torch.cli import evaluate as cli_evaluate
    from gemm_gan_tpu_torch.cli.experiment import Experiment
    from gemm_gan_tpu_torch.eval import distances, gamma, privacy, utility
    from gemm_gan_tpu_torch.viz import matplotlib_available

    t_phase = time.perf_counter()
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    print(f"[12] post-hoc evaluation (cli.evaluate --epoch auto) of phase 10's run: "
          f"best.json epoch {best['epoch']}", flush=True)
    timer = PartTimer()
    for owner, name, label in (
            (utility.UtilityEvaluator, "evaluate", "utility"), (gamma, "gamma_coef", "gamma"),
            (distances, "cost_matrix", "cost matrix"), (distances, "emd2", "OT"),
            (distances, "linear_mmd2", "MMD"), (distances, "poly_mmd2", "MMD"),
            (privacy, "dcr", "privacy"), (privacy, "nndr", "privacy")):
        timer.wrap(owner, name, label)
    try:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        report = quiet(cli_evaluate.main, ["--results_path", run, "--out",
                                           os.path.join(run, "posthoc.json")])
        seconds = time.perf_counter() - t0
        counts = fa.launch_counts()
    finally:
        timer.restore()
    assert all_finite(report), "non-finite post-hoc report"
    dirs = [r["dir"] for r in report["per_run"]]
    assert dirs == [f"test_0_epoch_{best['epoch']}"], dirs
    assert {"utility_disease", "utility_primary_site"} <= set(report), sorted(report)
    print(f"    cli.evaluate took {seconds:.1f} s on {card}; seconds per part "
          f"{json.dumps(timer.seconds)}; launches {sum(counts.values())}", flush=True)
    for rec in report["per_run"]:
        d = os.path.join(run, rec["dir"])
        test_real, test_gen = (np.load(os.path.join(d, f"{k}.npy"))
                               for k in ("test_real", "test_gen"))
        t0 = time.perf_counter()
        sq = host_cost(test_gen, test_real)
        dist = np.sqrt(sq)
        r, c = linear_sum_assignment(dist)
        w1 = float(dist[r, c].mean())
        r, c = linear_sum_assignment(sq)
        w2 = float(np.sqrt(sq[r, c].mean()))
        host_s = time.perf_counter() - t0
        rel = {"1-Wasserstein": abs(rec["1-Wasserstein"] - w1) / w1,
               "2-Wasserstein": abs(rec["2-Wasserstein"] - w2) / w2}
        ref = numpy_mmds(test_gen, test_real)
        rel.update({k: abs(rec[k] - v) / abs(v) for k, v in ref.items()})
        print(f"    {rec['dir']} ({test_gen.shape[0]} x {test_real.shape[0]} cases x "
              f"{test_real.shape[1]} genes): {json.dumps(rec)}; relative distance from "
              f"scipy's assignment / numpy float64 ({host_s:.1f} s on the host): "
              f"{json.dumps(rel)}", flush=True)
        assert test_gen.shape == test_real.shape, "the exact check needs square dumps"
        assert max(rel["1-Wasserstein"], rel["2-Wasserstein"]) <= OT_RTOL, rel
        assert max(rel["Linear_MMD"], rel["Poly_MMD"]) <= POSTHOC_MMD_RTOL, rel
        # the same directory and reference through the GAN experiment's suite
        holder = SimpleNamespace(
            out_dir=run, device=torch.device("cuda", torch.cuda.current_device()),
            splits={"train": {"genes": np.load(os.path.join(d, "data_real.npy"))}})
        pp = Experiment.posthoc_privacy(holder, epoch=best["epoch"])
        assert (pp["dcr"][0], pp["nndr"][0]) == (rec["dcr"], rec["nndr"]), (pp, rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sinkhorn = distances.wasserstein(test_gen, test_real, method="sinkhorn", power=2)
        torch.cuda.synchronize()
        print(f"    {rec['dir']}: DCR / NNDR equal Experiment.posthoc_privacy's "
              f"({pp['dcr'][0]}, {pp['nndr'][0]}); Sinkhorn (reg 0.05, 500 iterations, "
              f"f32) 2-Wasserstein {sinkhorn:.6f} in {time.perf_counter() - t0:.3f} s beside "
              f"the exact {rec['2-Wasserstein']:.6f}", flush=True)
    t0 = time.perf_counter()
    scores = privacy.PrivacyEvaluator(run).evaluate()
    assert scores and all_finite(scores), scores
    print(f"    PrivacyEvaluator over {run.rsplit(os.sep, 1)[-1]}'s dump dirs in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(scores)}", flush=True)
    if matplotlib_available():
        figs = quiet(cli_evaluate.main, ["--results_path", run, "--skip_utility", "--plots"])
        assert all(os.path.isdir(r["figures"]) for r in figs["per_run"])
        print("    --plots: matplotlib is installed, the figures were written", flush=True)
    else:
        try:
            quiet(cli_evaluate.main, ["--results_path", run, "--skip_utility", "--plots"])
        except ImportError as e:
            assert "matplotlib" in str(e), e
            print(f"    --plots without matplotlib raised: {e}", flush=True)
        else:
            raise AssertionError("--plots without matplotlib did not raise")
    print(f"    phase 12 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return counts


# phase 13, the VAE family at the published widths of variant_config (18,868
# genes, encoder and decoder (256, 256), latent 64; the CVAE's label tables
# sized as phase 10's layout sizes them, LABEL_VOCAB): the steps of the
# graphed epoch timed, the profiles sampled per timing, the gates of (a)
# (the ELBO, recon and KL of one step card vs CPU, and each parameter's
# first gradient), and cli.train's epochs on phase 10's RESUME_CASES layout
VAE_VARIANTS = ("vae", "cvae")
VAE_EPOCH_STEPS, VAE_EAGER_STEPS, VAE_PROFILE_STEPS, VAE_SAMPLES = 128, 32, 32, 4096
VAE_METRIC_RTOL, VAE_GRAD_RTOL = 1e-4, 1e-4
VAE_CLI_EPOCHS = 2


def vae_param_tree(m, conditional: bool, seed: int) -> dict:
    """Random VAE / CVAE params in the Flax layout of
    `gemm_gan_tpu.models.vae` for model config `m`."""
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": (rng.randn(i, o) * i ** -0.5).astype(np.float32),
                "bias": (0.01 * rng.randn(o)).astype(np.float32)}

    f = m.fusion
    extra = 2 * f.label_embed_dim if conditional else 0
    enc, dec, latent = m.vae_encoder_dims, m.vae_decoder_dims, m.vae_latent_dim
    tree = {
        "encoder": {f"Dense_{i}": dense(a, b) for i, (a, b) in
                    enumerate(zip([m.n_genes + extra, *enc[:-1]], enc))},
        "mu_head": dense(enc[-1], latent), "logvar_head": dense(enc[-1], latent),
        "decoder": {f"Dense_{i}": dense(a, b) for i, (a, b) in
                    enumerate(zip([latent + extra, *dec[:-1]], dec))},
        "out_head": dense(dec[-1], m.n_genes),
    }
    if m.vae_recon == "gaussian_nll":
        tree["out_logvar"] = dense(dec[-1], m.n_genes)
    if conditional:
        for name, n in (("disease_embed", f.n_disease_types), ("site_embed", f.n_primary_sites)):
            tree[name] = {"embedding": (rng.randn(n, f.label_embed_dim)
                                        * f.label_embed_dim ** -0.5).astype(np.float32)}
    return tree


def vae_batches(m, conditional: bool, n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"genes": rng.randn(BATCH, m.n_genes).astype(np.float32)}
        if conditional:
            b["disease"] = rng.randint(0, m.fusion.n_disease_types, BATCH)
            b["site"] = rng.randint(0, m.fusion.n_primary_sites, BATCH)
        out.append(b)
    return out


def vae_first_grads(engine, state, batch, eps, scale: float = None) -> dict:
    """{param: the ELBO's gradient} at `state`'s params with noise `eps`,
    before any optimizer move; `scale` multiplies the decoder's output (the
    gate's negative control)."""
    import torch

    model = state.model
    hook = (None if scale is None else model.out_head.register_forward_hook(
        lambda mod, inputs, out: out * scale))
    try:
        loss, _, _ = engine._losses(model, engine._tensors(batch),
                                    torch.tensor(eps, device=engine.device))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        if hook is not None:
            hook.remove()
    return {n: g.detach().cpu().double() for n, g in zip(names, grads)}


def grad_gate_ratio(grads: dict, ref: dict) -> tuple:
    """(the largest ||g - g_ref|| / ||g_ref|| over the params, its param)."""
    import torch

    rel = {n: float(torch.linalg.norm(g - ref[n]) / torch.linalg.norm(ref[n]))
           for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def vae_engine_checks(variant: str, card) -> dict:
    """13 (a)-(c) for one variant at the published widths; returns its
    numbers."""
    import torch

    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.train.vae import VAEEngine

    exp = variant_config(variant, fusion_kw=LABEL_VOCAB)
    m, conditional = exp.model, variant == "cvae"
    tree = vae_param_tree(m, conditional, seed=60 + VAE_VARIANTS.index(variant))
    batches = vae_batches(m, conditional, VAE_EPOCH_STEPS, seed=61)
    eps = np.random.RandomState(62).randn(BATCH, m.vae_latent_dim).astype(np.float32)
    out = {}

    # (a) one step, card vs CPU, with the same eps
    engines = {dev: VAEEngine(exp, steps_per_epoch=VAE_EPOCH_STEPS, device=dev)
               for dev in ("cuda", "cpu")}
    states = {dev: e.state_from_flax(tree, seed=7) for dev, e in engines.items()}
    grads = {dev: vae_first_grads(engines[dev], states[dev], batches[0], eps)
             for dev in engines}
    ratio, worst = grad_gate_ratio(grads["cuda"], grads["cpu"])
    control, cworst = grad_gate_ratio(vae_first_grads(
        engines["cuda"], states["cuda"], batches[0], eps, scale=1 + 2 ** -5), grads["cpu"])
    metrics = {dev: floats(engines[dev].step(states[dev], batches[0], eps=eps)[1])
               for dev in engines}
    rel = {k: abs(metrics["cuda"][k] - v) / abs(v) for k, v in metrics["cpu"].items()}
    print(f"  {variant} (a) one step card vs CPU (same eps): metrics {json.dumps(metrics)}, "
          f"relative {json.dumps(rel)}; first gradients: largest ||g - g_cpu|| / ||g_cpu|| "
          f"{ratio:.3e} ({worst}) against {VAE_GRAD_RTOL}; the decoder's output scaled by "
          f"1 + 2^-5 (the control): {control:.3e} ({cworst})", flush=True)
    assert max(rel.values()) <= VAE_METRIC_RTOL, rel
    assert ratio <= VAE_GRAD_RTOL, (ratio, worst)
    assert control > VAE_GRAD_RTOL, ("the control passed", control)
    out["step_rel"] = max(rel.values())
    out["grad_ratio"] = ratio
    del engines, states, grads

    # (b) a 4-step graphed epoch against 4 eager steps, bitwise; steps/s
    def stack(bs):
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

    eager_eng, graph_eng = (VAEEngine(exp, steps_per_epoch=VAE_EPOCH_STEPS) for _ in range(2))
    sa, sb = (e.state_from_flax(tree, seed=8) for e in (eager_eng, graph_eng))
    for b in batches[:4]:
        sa, ma = eager_eng.step(sa, b)
    sb, mb = graph_eng.step_many(sb, stack(batches[:4]))
    same = (floats(ma) == floats(mb)
            and all(torch.equal(x, y) for x, y in zip(sa.model.parameters(),
                                                       sb.model.parameters()))
            and all(torch.equal(x, y) for x, y in zip(sa.opt.nu + sa.opt.mu,
                                                       sb.opt.nu + sb.opt.mu)))
    print(f"  {variant} (b) 4 graphed steps against 4 eager ones: bitwise equal {same}",
          flush=True)
    assert same, (floats(ma), floats(mb))
    epoch = stack(batches)
    graph_eng.step_many(sb, epoch)  # captures the K-step layout's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sb, m_last = graph_eng.step_many(sb, epoch)
    torch.cuda.synchronize()
    graphed_sps = VAE_EPOCH_STEPS / (time.perf_counter() - t0)
    assert all(np.isfinite(v) for v in floats(m_last).values()), m_last
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:VAE_EAGER_STEPS]:
        sa, _ = eager_eng.step(sa, b)
    torch.cuda.synchronize()
    eager_sps = VAE_EAGER_STEPS / (time.perf_counter() - t0)
    part = stack(batches[:VAE_PROFILE_STEPS])
    _, records, readings = agreed_profile(lambda: graph_eng.step_many(sb, part),
                                          f"a {variant} epoch of replays")
    events = sorted((e for e in records if e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    replay_ms = sum(e.self_device_time_total for e in events) / 1e3 / VAE_PROFILE_STEPS
    print(f"  {variant} (b) batch {BATCH}: graphed {graphed_sps:.2f} steps/s "
          f"({VAE_EPOCH_STEPS}-step epoch, host clock, the stack's copy in), eager "
          f"{eager_sps:.2f} steps/s on {card}; device time {replay_ms:.4f} ms a step "
          f"({sum(e.count for e in events) / VAE_PROFILE_STEPS:.1f} device events, the "
          f"stack's copy in; {readings} readings); top "
          f"{[(e.key[:50], e.count, round(e.self_device_time_total / 1e3, 4)) for e in events[:4]]}",
          flush=True)
    out.update(graphed_sps=graphed_sps, eager_sps=eager_sps, replay_ms=replay_ms)

    # (c) profiles/s decoded from the prior
    gen = torch.Generator(device="cuda").manual_seed(9)
    labels = {}
    if conditional:
        labels = {k: torch.randint(0, getattr(m.fusion, n), (VAE_SAMPLES,), generator=gen,
                                   device="cuda")
                  for k, n in (("disease", "n_disease_types"), ("site", "n_primary_sites"))}
    kw = labels if conditional else {"num": VAE_SAMPLES}
    graph_eng.sample(sb, gen, device_out=True, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fake = graph_eng.sample(sb, gen, device_out=True, **kw)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    assert fake.shape == (VAE_SAMPLES, m.n_genes) and bool(torch.isfinite(fake).all())
    out["profiles_per_s"] = VAE_SAMPLES / sample_s
    print(f"  {variant} (c) sample: {VAE_SAMPLES} profiles in {sample_s * 1e3:.2f} ms = "
          f"{out['profiles_per_s']:.0f} profiles/s on the card (device tensors) on {card}",
          flush=True)
    return out


def vae_cli(variant: str, layout: str, out: str, card) -> str:
    """13 (d): `cli.train --variant V` for VAE_CLI_EPOCHS epochs on `layout`,
    validating each epoch, then `--evaluate_only --evaluate_which best` and
    `cli.evaluate` over the run dir. Returns the run dir."""
    from gemm_gan_tpu_torch.cli import evaluate as cli_evaluate
    from gemm_gan_tpu_torch.cli import train as cli_train
    from gemm_gan_tpu_torch.data.splits import split_indices
    from gemm_gan_tpu_torch.train import checkpoint

    args = ["--variant", variant, "--data_dir", layout, "--output_path", out,
            "--run_name", variant, "--n_runs", "1", "--freq_compute_test", "1"]
    t0 = time.perf_counter()
    results = cli_train.main([*args, "--epochs", str(VAE_CLI_EPOCHS)])
    fit_s = time.perf_counter() - t0
    run = os.path.join(out, variant)
    with open(os.path.join(run, f"{variant}_metrics.jsonl")) as f:
        logged = [json.loads(r) for r in f]
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    assert all_finite(logged) and all_finite(results), "non-finite"
    assert os.path.exists(os.path.join(run, "ckpt_best", str(best["step"]),
                                       checkpoint.STATE_FILE)), best
    tr, _, te = (len(i) for i in split_indices(RESUME_CASES, seed=42))
    dumps = os.path.join(run, f"test_0_epoch_{VAE_CLI_EPOCHS}")
    shapes = {f[:-4]: np.load(os.path.join(dumps, f)).shape for f in sorted(os.listdir(dumps))}
    want = {"data_real": (tr, PRODUCT_GENES), "data_gen": (tr, PRODUCT_GENES),
            "test_real": (te, PRODUCT_GENES), "test_gen": (te, PRODUCT_GENES)}
    if variant == "cvae":
        for side, n in (("train", tr), ("test", te)):
            for kind in ("", "primary_site_"):
                for who in ("real", "gen"):
                    want[f"{side}_labels_{kind}{who}"] = (n,)
    assert shapes == want, (shapes, want)
    t0 = time.perf_counter()
    best_res = cli_train.main([*args, "--epochs", str(VAE_CLI_EPOCHS), "--evaluate_only",
                               "--evaluate_which", "best"])
    eval_s = time.perf_counter() - t0
    assert all_finite(best_res)
    t0 = time.perf_counter()
    report = quiet(cli_evaluate.main, ["--results_path", run]
                   + (["--skip_utility"] if variant == "vae" else []))
    posthoc_s = time.perf_counter() - t0
    assert all_finite(report), "non-finite"
    assert [r["dir"] for r in report["per_run"]] == [f"test_0_epoch_{best['epoch']}"], report
    assert ("utility_disease" in report) == (variant == "cvae")
    print(f"  {variant} (d) cli.train {VAE_CLI_EPOCHS} epochs on {RESUME_CASES} cases "
          f"{fit_s:.1f} s, evaluate best {eval_s:.1f} s, cli.evaluate {posthoc_s:.1f} s on "
          f"{card}: last logged {json.dumps(logged[-1])}; best.json {json.dumps(best)}; "
          f"gamma {results['gamma_mean']:.4f}; dumps {json.dumps(shapes)}; post-hoc "
          f"{json.dumps({k: v for k, v in report['per_run'][0].items() if k != 'dir'})}",
          flush=True)
    return run


def vae_phase(fa, card, layout: str, out: str) -> dict:
    """Phase 13: the VAE family at the published widths: per variant (a)
    one step card vs CPU with the same eps (the ELBO, recon and KL within
    VAE_METRIC_RTOL; each parameter's first gradient within VAE_GRAD_RTOL
    of the CPU's, the gate rejecting the decoder's output scaled by
    1 + 2^-5), (b) a 4-step graphed epoch bitwise equal to 4 eager steps,
    graphed and eager steps/s and a replay's device time (`agreed_profile`),
    (c) sampled profiles/s; (d) `cli.train` for each on `layout` (phase
    10's RESUME_CASES cases), evaluate best, `cli.evaluate`; (e) the VAE for
    1 epoch, then `--resume` to VAE_CLI_EPOCHS: the final checkpoint
    bitwise equal to (d)'s straight run. No kernel launches over the phase.
    Returns the launches."""
    import torch

    from gemm_gan_tpu_torch.cli import train as cli_train

    t_phase = time.perf_counter()
    print(f"[13] the VAE family at the published widths ({', '.join(VAE_VARIANTS)}; "
          f"{PRODUCT_GENES} genes, encoder and decoder (256, 256), latent 64, batch "
          f"{BATCH}; CVAE tables {json.dumps(LABEL_VOCAB)})", flush=True)
    fa.reset_launch_counts()
    numbers = {v: vae_engine_checks(v, card) for v in VAE_VARIANTS}
    torch.cuda.empty_cache()
    runs = {v: vae_cli(v, layout, out, card) for v in VAE_VARIANTS}
    t0 = time.perf_counter()
    args = ["--variant", "vae", "--data_dir", layout, "--output_path", out,
            "--run_name", "vae_resumed", "--n_runs", "1", "--freq_compute_test", "1"]
    cli_train.main([*args, "--epochs", "1"])
    cli_train.main([*args, "--epochs", str(VAE_CLI_EPOCHS), "--resume"])
    pa, pb = (load_checkpoint(p) for p in (runs["vae"], os.path.join(out, "vae_resumed")))
    a, b = dict(checkpoint_tensors(pa)), dict(checkpoint_tensors(pb))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if (pa["step"], pa["opt"]["count"]) != (pb["step"], pb["opt"]["count"]):
        differ.append(f"step and count {(pa['step'], pa['opt']['count'])} vs "
                      f"{(pb['step'], pb['opt']['count'])}")
    print(f"  vae (e) 1 epoch, then --resume to {VAE_CLI_EPOCHS}, against (d)'s "
          f"{VAE_CLI_EPOCHS} straight: {len(a)} tensors of the final checkpoints (params, "
          f"Adam moments and counts, generator), {len(differ)} differ {differ[:4]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    assert a.keys() == b.keys() and not differ, differ
    counts = fa.launch_counts()
    assert not any(counts.values()), counts
    print(f"    phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}: "
          f"{json.dumps(numbers)}; kernel launches over the phase: none", flush=True)
    return counts


def nonzero(counts: dict) -> dict:
    """The kernels of a launch count that ran."""
    return {k: n for k, n in counts.items() if n}


# phase 14: the serving artifact of phase 10's product run, served at these
# batch sizes and patch counts; profiles drawn per cli.sample call
ARTIFACT_BATCHES, ARTIFACT_PATCHES = (8, 3), (NUM_PATCHES, 1024)


def artifact_phase(fa, card, root: str) -> dict:
    """Phase 14: `cli.export --which best --use_ema` of phase 10's product
    run on the card; the artifact loaded and served at ARTIFACT_BATCHES x
    ARTIFACT_PATCHES against `GeneratorServer` of the restored EMA
    generator on the same z (E2E_RTOL / E2E_ATOL; bitwise printed), its
    launches per call (Q1 at 256 patches, Q3 at 1,024: `kernel_attentions`)
    and its ms per call beside the server's; the CVAE decoder of phase 13's
    run exported and held against `VAEEngine.sample`; `cli.sample --which
    best --balanced --host_dtype float16` with and without `--scan`, bitwise
    equal, profiles/s. Returns the launches per path."""
    import torch

    from gemm_gan_tpu_torch.cli import export as cli_export
    from gemm_gan_tpu_torch.cli import sample as cli_sample
    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.serving import GeneratorArtifact, GeneratorServer
    from gemm_gan_tpu_torch.train.checkpoint import resolve_ckpt_dir, restore_state
    from gemm_gan_tpu_torch.train.vae import VAEEngine
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    t_phase = time.perf_counter()
    run = os.path.join(root, "runs", "product")
    art_dir = os.path.join(root, "artifacts", "product")
    t0 = time.perf_counter()
    cli_export.main(["--ckpt_dir", os.path.join(run, "ckpt"), "--which", "best", "--use_ema",
                     "--out", art_dir])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = GeneratorArtifact.load(art_dir)
    load_s = time.perf_counter() - t0
    cfg = load_config(os.path.join(run, "config.json"))
    ops = sum(str(n.target) == "gemm_gan_tpu_torch.masked_mha.default"
              for n in art.program.graph.nodes)
    print(f"[14] serving artifact of phase 10's run (cli.export --which best --use_ema): "
          f"exported in {export_s:.1f} s, loaded in {load_s:.1f} s; "
          f"{ops} attention ops in the program; manifest {json.dumps(art.manifest)}", flush=True)
    assert ops == cfg.model.fusion.num_layers + 2 and art.manifest["platforms"] == ["cuda"]
    assert art.manifest["ema"] is True and art.manifest["batch"] == "dynamic"
    engine = WGANGPEngine(cfg)
    ckpt, step = resolve_ckpt_dir(os.path.join(run, "ckpt"), "best")
    state = restore_state(ckpt, engine.init_state(0, cli_export._example_batch(cfg)), step)
    server = GeneratorServer.for_module(state.g_ema)
    launches, errs, same = {}, {}, {}
    for P in ARTIFACT_PATCHES:
        data = structured_dataset(n=max(ARTIFACT_BATCHES), n_genes=cfg.model.n_genes,
                                  num_patches=P, seed=P)
        want_counts = kernel_attentions(cfg, patches=P)
        for B in ARTIFACT_BATCHES:
            cond = {k: data[k][:B] for k in server.keys}
            z = torch.randn(B, cfg.model.latent_dim, generator=torch.Generator().manual_seed(B))
            art(z, cond)  # warm-up
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            got = art(z, cond)
            torch.cuda.synchronize()
            label = f"artifact_{P}_b{B}"
            launches[label] = fa.launch_counts()
            want = server(z, cond)
            errs[label] = float((got - want).abs().max())
            same[label] = bool(torch.equal(got, want))
            assert got.shape == (B, cfg.model.n_genes) and bool(torch.isfinite(got).all())
            kernel = {"ble": "flash_fwd_ble", "bhld": "flash_fwd_bhld"}
            assert launches[label] == {**dict.fromkeys(KERNELS, 0), **{
                kernel[r]: n for r, n in want_counts.items()}}, (label, launches[label])
            torch.testing.assert_close(got, want, rtol=E2E_RTOL, atol=E2E_ATOL)
        cond = {k: data[k][:BATCH] for k in server.keys}
        z = torch.randn(BATCH, cfg.model.latent_dim, generator=torch.Generator().manual_seed(0))
        print(f"    {P} patches: artifact {cuda_ms(lambda: art(z, cond), iters=10):.3f} ms "
              f"against GeneratorServer {cuda_ms(lambda: server(z, cond), iters=10):.3f} ms a "
              f"call of batch {BATCH} (host data, CUDA events) on {card}", flush=True)
    print(f"    artifact vs GeneratorServer on the same z (rtol {E2E_RTOL}, atol {E2E_ATOL}): "
          f"max|err| {json.dumps(errs)}; bitwise {json.dumps(same)}; launches per call "
          f"{json.dumps({k: nonzero(v) for k, v in launches.items()})}", flush=True)

    # the CVAE decoder of phase 13's run
    cvae_run = os.path.join(root, "runs", "cvae")
    cvae_dir = os.path.join(root, "artifacts", "cvae")
    cli_export.main(["--ckpt_dir", os.path.join(cvae_run, "ckpt"), "--which", "best",
                     "--out", cvae_dir])
    dec = GeneratorArtifact.load(cvae_dir)
    vcfg = load_config(os.path.join(cvae_run, "config.json"))
    veng = VAEEngine(vcfg)
    ckpt, step = resolve_ckpt_dir(os.path.join(cvae_run, "ckpt"), "best")
    vstate = restore_state(ckpt, veng.init_state(0, cli_export._example_batch(vcfg)), step)
    rng = np.random.RandomState(1)
    labels = {"disease": rng.randint(0, vcfg.model.fusion.n_disease_types, 64),
              "site": rng.randint(0, vcfg.model.fusion.n_primary_sites, 64)}
    z = rng.randn(64, vcfg.model.vae_latent_dim).astype(np.float32)
    got = dec(z, labels).cpu()
    want = torch.from_numpy(veng.sample(vstate, None, z=z, **labels))
    print(f"    CVAE decoder of phase 13's run (cli.export --which best): max|err| against "
          f"VAEEngine.sample {float((got - want).abs().max()):.3e}, bitwise "
          f"{bool(torch.equal(got, want))}; manifest cond_spec "
          f"{json.dumps(dec.manifest['cond_spec'])}", flush=True)
    torch.testing.assert_close(got, want, rtol=E2E_RTOL, atol=E2E_ATOL)

    # cli.sample over phase 10's layout and run
    layout = os.path.join(root, f"tcga_{PRODUCT_CASES}")
    outs, seconds = {}, {}
    for label, extra in (("per-call", []), ("scan", ["--scan"])):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        outs[label] = quiet(cli_sample.main, [
            "--data_dir", layout, "--ckpt_dir", os.path.join(run, "ckpt"), "--which", "best",
            "--balanced", "--host_dtype", "float16", "--out",
            os.path.join(root, f"sample_{label}.npy"), *extra])
        seconds[label] = time.perf_counter() - t0
        launches[f"cli_sample_{label}"] = fa.launch_counts()
    a, b = outs["per-call"], outs["scan"]
    n = len(a["fake"])
    counts = np.bincount(a["disease"]).tolist()
    print(f"    cli.sample --which best --balanced --host_dtype float16: {a['fake'].shape} "
          f"{a['fake'].dtype}, disease counts {counts}; --scan bitwise equal to the per-call "
          f"path: {bool(np.array_equal(a['fake'], b['fake']))}; seconds (load, restore, "
          f"generate, save) per-call {seconds['per-call']:.1f}, scan {seconds['scan']:.1f} "
          f"= {n / seconds['per-call']:.1f} and {n / seconds['scan']:.1f} profiles/s on {card}; "
          f"launches {json.dumps({k: nonzero(launches[f'cli_sample_{k}']) for k in outs})}",
          flush=True)
    assert a["fake"].dtype == np.float16 and np.isfinite(a["fake"]).all()
    assert min(counts) == max(counts), counts
    assert np.array_equal(a["fake"], b["fake"]) and np.array_equal(a["disease"], b["disease"])
    print(f"    phase 14 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


# phase 15: the encoders at the published widths (UNI ViT-L/16 at 256-pixel
# tiles, the ingest default; ModernBERT-base over 300 tokens), timed at
# these batches; LayerScale gammas of the random ViT set to VIT_GAMMA so the
# blocks move the output (UNI's init, 1e-5, would leave it the embedding's)
VIT_TILE, VIT_BATCH, BERT_LEN, BERT_BATCH, VIT_GAMMA = 256, 64, 300, 32, 0.1
# card (cuBLAS, f32 with TF32 off) vs CPU through 24 / 22 layers of random
# weights: each output entry within ENCODER_TOL of the output's largest
ENCODER_TOL = 1e-3
INGEST_CASES, INGEST_TILES = 8, 24


def vit_flops(p, img: int) -> float:
    """Multiply-adds x 2 of one ViT forward over an img x img tile, as the
    port computes it (every product, the attention's full L x L)."""
    g = img // p.patch_size
    L, E, M = g * g + 1, p.hidden_size, int(p.hidden_size * p.mlp_ratio)
    layer = 2 * L * E * (3 * E + E + 2 * M) + 4 * L * L * E
    return 2 * (g * g) * 3 * p.patch_size ** 2 * E + p.num_layers * layer


def bert_flops(p, L: int) -> float:
    """The same for one ModernBERT sequence of L tokens."""
    E, inter = p.hidden_size, p.intermediate_size
    return p.num_layers * (2 * L * E * (3 * E + E + 3 * inter) + 4 * L * L * E)


def top_device_kernels(fn, n: int = 6) -> dict:
    """{kernel: device ms} of the `n` kernels that one `fn()` spends the
    most device time in (one `profiled` window, printed as read, not
    gated)."""
    import torch

    with torch.inference_mode():
        prof, whole = profiled(fn)
    events = sorted(device_records(prof), key=lambda e: -e.self_device_time_total)
    top = {e.key[:70]: round(e.self_device_time_total / 1e3, 3) for e in events[:n]}
    return {"whole": whole, "total_ms": round(sum(e.self_device_time_total
                                                   for e in events) / 1e3, 3), "top": top}


def encoder_rates(model, inputs, n: int, flops: float) -> dict:
    """Items/s of `model(*inputs)` (n items a call) by CUDA events, and the
    bound's items/s at the f32 and bf16 data-sheet peaks."""
    import torch

    with torch.inference_mode():
        ms = cuda_ms(lambda: model(*inputs), iters=3, warmup=1)
    return {"per_s": n / ms * 1e3, "ms": ms,
            "bound_per_s": (PEAK_BF16_FLOPS if model.dtype == torch.bfloat16
                            else PEAK_F32_FLOPS) / flops}


def encoders_phase(fa, card, root: str) -> dict:
    """Phase 15: UNI ViT-L/16 and ModernBERT-base on seeded random weights
    at the published widths: card against CPU on two inputs in f32 (each
    entry within ENCODER_TOL of the output's largest), bf16 against f32 by
    cosine (> 0.99), tiles/s at VIT_BATCH and sequences/s at BERT_BATCH x
    BERT_LEN in f32 and bf16 beside their bounds, the bf16 batch's top
    device kernels (`top_device_kernels`, printed); `IngestPipeline` over
    synthetic tiles of INGEST_CASES cases (the ViT through `cli.ingest`'s
    `uni_embedder`), the text caches (random ids through `cli.preprocess`'s
    `encode_caches`) and the contrastive caches, read back by `load_tcga`.
    No kernel launches. Returns the launches."""
    import copy
    import pickle

    import pandas as pd
    import torch

    from gemm_gan_tpu_torch.cli.ingest import uni_embedder
    from gemm_gan_tpu_torch.cli.preprocess import contrastive, encode_caches
    from gemm_gan_tpu_torch.data.ingest import IngestPipeline
    from gemm_gan_tpu_torch.data.tcga import load_tcga
    from gemm_gan_tpu_torch.encoders.modernbert import ModernBert, ModernBertParams
    from gemm_gan_tpu_torch.encoders.vit import ViT, ViTParams, preprocess_tiles

    t_phase = time.perf_counter()
    fa.reset_launch_counts()
    vp, bp = ViTParams(), ModernBertParams()
    print(f"[15] the encoders at the published widths: UNI ViT-L/16 at {VIT_TILE}-pixel tiles "
          f"({vit_flops(vp, VIT_TILE) / 1e9:.1f} GFLOP a tile), ModernBERT-base at "
          f"{BERT_LEN} tokens ({bert_flops(bp, BERT_LEN) / 1e9:.1f} GFLOP a sequence); "
          f"seeded random weights", flush=True)
    t0 = time.perf_counter()
    vit_cpu = ViT(vp, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for block in vit_cpu.blocks:
            block.ls1.gamma.fill_(VIT_GAMMA)
            block.ls2.gamma.fill_(VIT_GAMMA)
    bert_cpu = ModernBert(bp, device="cpu", generator=torch.Generator().manual_seed(1))
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    tiles = torch.from_numpy(preprocess_tiles(
        rng.randint(0, 256, (2, VIT_TILE, VIT_TILE, 3)).astype(np.uint8)))
    ids = torch.from_numpy(rng.randint(0, bp.vocab_size, (2, BERT_LEN)))
    mask = torch.from_numpy(np.arange(BERT_LEN)[None] < np.array([BERT_LEN, 120])[:, None])
    numbers = {"init_s": init_s}
    for name, cpu_model, inputs, n_items, flops, batch_inputs in (
            ("vit", vit_cpu, (tiles,), VIT_BATCH, vit_flops(vp, VIT_TILE),
             lambda: (torch.from_numpy(preprocess_tiles(rng.randint(
                 0, 256, (VIT_BATCH, VIT_TILE, VIT_TILE, 3)).astype(np.uint8))).cuda(),)),
            ("modernbert", bert_cpu, (ids, mask), BERT_BATCH, bert_flops(bp, BERT_LEN),
             lambda: (torch.from_numpy(rng.randint(0, bp.vocab_size, (BERT_BATCH, BERT_LEN))
                                       ).cuda(),
                      torch.ones(BERT_BATCH, BERT_LEN, dtype=torch.bool, device="cuda")))):
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = cpu_model(*inputs)
        cpu_s = time.perf_counter() - t0
        card_model = copy.deepcopy(cpu_model).cuda()
        with torch.inference_mode():
            got = card_model(*(x.cuda() for x in inputs)).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        card_model.dtype = torch.bfloat16
        with torch.inference_mode():
            half = card_model(*(x.cuda() for x in inputs)).cpu()
        cos = torch.nn.functional.cosine_similarity(half.flatten(0, -2), want.flatten(0, -2),
                                                    dim=-1)
        big = batch_inputs()
        rates = {}
        for dtype in (torch.float32, torch.bfloat16):
            card_model.dtype = dtype
            rates[str(dtype).replace("torch.", "")] = encoder_rates(card_model, big, n_items,
                                                                    flops)
        card_model.dtype = torch.bfloat16
        top = top_device_kernels(lambda: card_model(*big))
        numbers[name] = {"card_vs_cpu": err, "bf16_cos_min": float(cos.min()),
                         "cpu_s_two_inputs": cpu_s, "rates": rates, "bf16_top_kernels": top}
        unit = "tiles" if name == "vit" else "sequences"
        print(f"    {name}: card vs CPU (f32, two inputs) max|err| / max|out| = {err:.3e} "
              f"(tolerance {ENCODER_TOL}); bf16 vs f32 cosine min {float(cos.min()):.6f}; "
              + "; ".join(f"{d} {r['per_s']:.1f} {unit}/s ({r['ms']:.2f} ms a batch of "
                          f"{n_items}; bound {r['bound_per_s']:.1f}, share "
                          f"{r['per_s'] / r['bound_per_s']:.3f})" for d, r in rates.items())
              + f" on {card}; bf16 batch's top kernels (torch.profiler, device ms) "
              f"{json.dumps(top)}", flush=True)
        assert err <= ENCODER_TOL and bool(torch.isfinite(got).all()), (name, err)
        assert float(cos.min()) > 0.99, (name, float(cos.min()))
        card_model.dtype = torch.float32
        if name == "vit":
            vit_sd = card_model.state_dict()
        else:
            bert_card = card_model
        del big
    del vit_cpu, bert_cpu
    torch.cuda.empty_cache()

    # ingest: IngestPipeline over synthetic tiles, then the text and
    # contrastive caches, read back by load_tcga
    t0 = time.perf_counter()
    d = os.path.join(root, "ingest")
    os.makedirs(d)
    cases = [f"case-{i:02d}" for i in range(INGEST_CASES)]
    pd.DataFrame(rng.rand(INGEST_CASES, 64) * 8, index=pd.Index(cases, name="case_id"),
                 columns=[f"ENSG{i:05d}" for i in range(64)]
                 ).to_parquet(os.path.join(d, "rna_seq.parquet"))
    with open(os.path.join(d, "metainfos.pkl"), "wb") as f:
        pickle.dump({c: {"disease_type": "AB"[i % 2], "primary_site": "XY"[i % 2]}
                     for i, c in enumerate(cases)}, f)
    n_tiles = {c: INGEST_TILES - 2 * i for i, c in enumerate(cases)}
    embed = uni_embedder(vit_sd, batch_size=VIT_BATCH)
    pipe = IngestPipeline(
        lambda c: c, lambda c, path: preprocess_tiles(np.random.RandomState(len(c) + n_tiles[c])
                                                      .randint(0, 256, (n_tiles[c], VIT_TILE,
                                                                        VIT_TILE, 3))
                                                      .astype(np.uint8)),
        embed, os.path.join(d, "patch_embeddings_uni"), delete_after_embed=False)
    results = pipe.run(cases)
    assert [r.status for r in results] == ["ok"] * INGEST_CASES, results
    ids_by_case = {c: rng.randint(5, bp.vocab_size, BERT_LEN).astype(np.int32) for c in cases}
    mask_by_case = {c: np.arange(BERT_LEN) < 40 + 30 * i for i, c in enumerate(cases)}
    tok_dir = encode_caches(bert_card, ids_by_case, mask_by_case, d, BERT_BATCH)
    pairs = contrastive(d, tok_dir, emb_dim=128, epochs=3)
    splits = load_tcga(d, schema="multi_token", num_patches=NUM_PATCHES, max_tokens=BERT_LEN)
    shapes = {k: list(splits["train"][k].shape[1:]) for k in ("genes", "patches", "tokens")}
    n = sum(len(splits[s]["genes"]) for s in ("train", "val", "test"))
    img = pd.read_parquet(os.path.join(d, "embeddings_contrastive.parquet"))
    print(f"    ingest of {INGEST_CASES} cases ({sum(n_tiles.values())} tiles) on {card}: "
          f"{time.perf_counter() - t0:.1f} s; {pairs}; load_tcga(multi_token) read {n} "
          f"cases, shapes {json.dumps(shapes)}; contrastive table {list(img.shape)}", flush=True)
    assert n == INGEST_CASES and shapes["patches"] == [NUM_PATCHES, vp.hidden_size]
    assert shapes["tokens"] == [BERT_LEN, bp.hidden_size] and list(img.shape) == [
        INGEST_CASES, 128]
    counts = fa.launch_counts()
    assert not any(counts.values()), counts
    print(f"    phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}: "
          f"{json.dumps(numbers)}; kernel launches over the phase: none", flush=True)
    return counts


# phase 16: the rest of the single-device port (t-SNE on the card, BatchNorm
# trunks, hoist_fakes, the torch step measurement). (a): TSNE_CLUSTERS
# seeded Gaussian clusters of TSNE_PER points at the gene width, the
# 10-NN label agreement of the embedding at least TSNE_MIN_AGREEMENT, and
# TSNE_SUBSET of the points on the card and on the CPU with final exact
# KLs within TSNE_KL_RTOL of each other (two float32 runs of the same
# schedule, other summation orders)
TSNE_CLUSTERS, TSNE_PER, TSNE_SUBSET, TSNE_NEIGHBORS = 8, 256, 512, 10
TSNE_MIN_AGREEMENT, TSNE_KL_RTOL = 0.9, 0.05
# (b): card vs CPU, the eval forward in f32 within BN_EVAL_TOL of the
# output's largest entry (phase 3's serving gate), in bf16 within
# BF16_E2E_TOL (phase 9's); one train=True forward, its output and its
# updated running buffers each within BN_TRAIN_TOL of their largest entry
BN_EVAL_TOL, BN_TRAIN_TOL = 1e-4, 1e-5
# (c): the hoist A/B on a bank of HOIST_BANK_CASES (64 graphed steps an
# epoch), HOIST_TURNS epochs each way in turns
HOIST_BANK_CASES, HOIST_TURNS = 512, 3
# (d): the bench function's calls
BENCH_SCAN_LEN, BENCH_CALLS = 100, 4


def label_agreement(y, labels, k: int = TSNE_NEIGHBORS) -> float:
    """The share of each point's k nearest neighbours in the embedding `y`
    [n, 2] that carry its label, averaged over the points."""
    y = np.asarray(y, np.float64)
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    labels = np.asarray(labels)
    return float((labels[np.argsort(d, 1)[:, :k]] == labels[:, None]).mean())


def tsne_phase(card) -> dict:
    """16 (a): `viz.tsne_2d` on the card (`utils.tsne`): TSNE_CLUSTERS x
    TSNE_PER points of PRODUCT_GENES dims (seeded Gaussian clusters, centers
    N(0, 1), points N(0, 1) around them), perplexity 30; seconds, the final
    exact KL, the iterations and the 10-NN label agreement (gated at
    TSNE_MIN_AGREEMENT); then TSNE_SUBSET of the points (every cluster
    alike) on the card and on the CPU, their final exact KLs within
    TSNE_KL_RTOL. Returns the launches (none)."""
    import torch

    from gemm_gan_tpu_torch import viz
    from gemm_gan_tpu_torch.kernels import flash_attention as fa
    from gemm_gan_tpu_torch.utils import tsne as tsne_lib

    rng = np.random.RandomState(16)
    centers = rng.randn(TSNE_CLUSTERS, PRODUCT_GENES).astype(np.float32)
    x = np.concatenate([c + rng.randn(TSNE_PER, PRODUCT_GENES).astype(np.float32)
                        for c in centers])
    labels = np.repeat(np.arange(TSNE_CLUSTERS), TSNE_PER)
    fa.reset_launch_counts()
    viz.tsne_2d(x[:64])  # warm-up: cuSOLVER, cuBLAS in float64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tsne_lib.tsne(x, 30.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()
    agreement = label_agreement(res.embedding, labels)
    assert res.embedding.shape == (len(x), 2) and np.isfinite(res.embedding).all()
    print(f"[16] (a) t-SNE on the card: {len(x)} points x {PRODUCT_GENES} dims "
          f"({TSNE_CLUSTERS} clusters), perplexity 30: {seconds:.3f} s on {card}; final exact KL "
          f"{res.kl_divergence:.6f} after {res.n_iter + 1} iterations; {TSNE_NEIGHBORS}-NN label "
          f"agreement {agreement:.4f} (at least {TSNE_MIN_AGREEMENT})", flush=True)
    assert agreement >= TSNE_MIN_AGREEMENT, agreement
    sub = x.reshape(TSNE_CLUSTERS, TSNE_PER, -1)[:, :TSNE_SUBSET // TSNE_CLUSTERS].reshape(
        TSNE_SUBSET, -1)
    kls, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        kls[device] = tsne_lib.tsne(sub, 30.0, device=device).kl_divergence
        secs[device] = round(time.perf_counter() - t0, 3)
    rel = abs(kls["cuda"] - kls["cpu"]) / kls["cpu"]
    print(f"    (a) {TSNE_SUBSET} of the points, card vs CPU: final exact KL {kls['cuda']:.6f} / "
          f"{kls['cpu']:.6f} (relative {rel:.2e}, at most {TSNE_KL_RTOL}); seconds {secs}",
          flush=True)
    assert rel <= TSNE_KL_RTOL, kls
    assert not any(launches.values()), launches
    return launches


def batchnorm_phase(fa, card, exp, batch) -> dict:
    """16 (b): the flagship generator with `use_batchnorm=True` at the
    published widths, from seeded Flax-layout trees (`flax_param_tree`,
    `flax_batch_stats`) through `convert.py`: its eval forward served by
    `GeneratorServer` card vs CPU in f32 (BN_EVAL_TOL) and bf16
    (BF16_E2E_TOL) of the output's largest entry, with Q1 launched
    `kernel_attentions` times a forward; one `train=True` forward card vs
    CPU, its output and its updated running buffers within BN_TRAIN_TOL of
    their largest entry. Returns the f32 eval forward's launches."""
    import torch

    from gemm_gan_tpu_torch.convert import flax_to_state_dict
    from gemm_gan_tpu_torch.models.gan import Generator
    from gemm_gan_tpu_torch.serving import GeneratorServer, cond_keys_for, to_device

    cfg = dataclasses.replace(exp.model, use_batchnorm=True)
    sd = flax_to_state_dict(flax_param_tree(cfg, seed=60), flax_batch_stats(cfg, seed=61))
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(62))
    n_q1 = kernel_attentions(cfg)["ble"]
    out = {}
    for dtype, kernel, tol in (("float32", "flash_fwd_ble", BN_EVAL_TOL),
                               ("bfloat16", "flash_fwd_ble_bf16", BF16_E2E_TOL)):
        cfg_ = dataclasses.replace(cfg, compute_dtype=dtype)
        server = GeneratorServer(cfg_, sd)
        server(z, batch)  # warm-up
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        on_card = server(z, batch).cpu()
        torch.cuda.synchronize()
        launches = fa.launch_counts()
        on_cpu = GeneratorServer(cfg_, sd, device="cpu")(z, batch)
        err, scale = float((on_card - on_cpu).abs().max()), float(on_cpu.abs().max())
        print(f"    (b) BatchNorm generator, eval forward in {dtype}, card vs CPU: max|err| "
              f"{err:.3e} (max|out| {scale:.3f}; at most {tol} x max|out|); launches "
              f"{nonzero(launches)}", flush=True)
        assert np.isfinite(on_card.numpy()).all() and err <= tol * scale, (dtype, err, scale)
        assert launches == {**dict.fromkeys(KERNELS, 0), kernel: n_q1}, launches
        out[dtype] = launches
    nets = {}
    for device in ("cuda", "cpu"):
        gen = Generator(cfg, device=device)
        gen.load_state_dict(sd)
        gen.eval()  # dropout off; the trunk's BatchNorm follows `train`
        cond = {k: to_device(batch[k], torch.device(device)) for k in cond_keys_for(cfg.fusion)}
        with torch.no_grad():
            y = gen(z.to(device), cond, train=True).cpu()
        nets[device] = (y, {k: b.cpu() for k, b in gen.named_buffers()})
    errs = {}
    for name, got, want in (("output", nets["cuda"][0], nets["cpu"][0]),
                            *((k, nets["cuda"][1][k], b) for k, b in nets["cpu"][1].items())):
        errs[name] = float((got - want).abs().max()) / float(want.abs().max())
        assert errs[name] <= BN_TRAIN_TOL, (name, errs)
    moved = any(not torch.equal(b, sd[k]) for k, b in nets["cpu"][1].items())
    print(f"    (b) one train=True forward (batch statistics, running buffers updated), card "
          f"vs CPU, max|err| / max|ref| (at most {BN_TRAIN_TOL}): {json.dumps(errs)}; the "
          f"buffers moved: {moved}", flush=True)
    assert moved
    return out["float32"]


def hoist_phase(fa, card, exp, params, d_params, batch) -> dict:
    """16 (c): `train.hoist_fakes=True`. The hoisted fakes (one generator
    trunk forward over [n_critic * B] rows) against the per-update ones on
    the card and against the CPU's, within E2E_RTOL / E2E_ATOL. One
    dropout-free f32 step with the hoist card vs CPU under phase 5's gates
    with phase 5's draws (`step_diff`: metrics, RMSprop's bound, at most
    MAX_LOOSE params beyond PARAM_ATOL), the same step without the hoist
    printed beside it; and the step with the hoist against without it on
    the card (metrics within STEP_RTOL / STEP_ATOL, counts printed). Then phase 9
    (c)'s graphed bf16 flagship (dropout 0.1) on a bank of
    HOIST_BANK_CASES, without and with the hoist in HOIST_TURNS turns each:
    steps/s (host clock), a replay's device ms and events (`replay_busy`
    over a SMALL_CASES cache) and Q1 / Q2 launches a replay, gated
    unchanged at `step_launches`. Returns the hoisted bank epochs'
    launches."""
    import torch

    from gemm_gan_tpu_torch.data.device_cache import DeviceCache
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    cfg0 = with_train(train_cfg(exp, dropout=0.0), hoist_fakes=True)
    cfg_u = with_train(cfg0, hoist_fakes=False)
    draws = random_draws(cfg0, seed=5)  # phase 5's
    fakes = {}
    for device in ("cuda", "cpu"):
        engine = WGANGPEngine(cfg0, device=device)
        state = engine.state_from_flax(params, d_params)
        _, cond = engine._tensors(batch)
        z = torch.as_tensor(draws["z"], device=device)
        with torch.no_grad():
            g_cvec = engine.embed_generator(state, cond)
            fakes[device] = (engine.hoisted_fakes(state, g_cvec, z).cpu(),
                             torch.stack([state.gen.score(zi, g_cvec) for zi in z]).cpu())
        del engine, state
    errs = {"card: hoisted vs per-update": float((fakes["cuda"][0] - fakes["cuda"][1]).abs().max()),
            "hoisted: card vs CPU": float((fakes["cuda"][0] - fakes["cpu"][0]).abs().max())}
    print(f"    (c) hoist_fakes' fakes [{cfg0.train.n_critic}, {BATCH}, {exp.model.n_genes}], "
          f"max|err| (rtol {E2E_RTOL}, atol {E2E_ATOL}; max|fake| "
          f"{float(fakes['cpu'][1].abs().max()):.3f}): {json.dumps(errs)}", flush=True)
    torch.testing.assert_close(fakes["cuda"][0], fakes["cuda"][1], rtol=E2E_RTOL, atol=E2E_ATOL)
    torch.testing.assert_close(fakes["cuda"][0], fakes["cpu"][0], rtol=E2E_RTOL, atol=E2E_ATOL)
    args = (params, d_params, batch, draws)
    unhoisted = run_step(cfg_u, "cuda", *args)
    base = step_diff(unhoisted, run_step(cfg_u, "cpu", *args), max_loose={})
    fa.reset_launch_counts()
    hoisted = run_step(cfg0, "cuda", *args)
    step_launch = fa.launch_counts()
    cmp = step_diff(hoisted, run_step(cfg0, "cpu", *args))
    print(f"    (c) hoist_fakes, one f32 step at dropout 0 with phase 5's draws, card vs CPU: "
          f"{json.dumps(cmp)} (metrics rtol {STEP_RTOL}, atol {STEP_ATOL}; at most {MAX_LOOSE} "
          f"params beyond atol {PARAM_ATOL}; the same step without the hoist, card vs CPU, "
          f"misses it on {base['beyond_atol_by_net']}); launches {nonzero(step_launch)}",
          flush=True)
    n_fwd, n_bwd = step_launches(cfg0)
    assert step_launch == {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble": n_fwd,
                           "flash_bwd_ble": n_bwd}, step_launch
    cmp = step_diff(hoisted, unhoisted, max_loose={})
    print(f"    (c) the same step with the hoist vs without, both on the card: {json.dumps(cmp)} "
          f"(metrics rtol {STEP_RTOL}, atol {STEP_ATOL})", flush=True)

    exp16 = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                               compute_dtype="bfloat16"))
    data = bank_data(exp.model, HOIST_BANK_CASES, seed=64)
    cache_kw = dict(batch_size=BATCH, num_patches=NUM_PATCHES, seed=0,
                    embedding_store_dtype=torch.bfloat16)
    bank = DeviceCache(data, **cache_kw)
    small = DeviceCache({k: v[:SMALL_CASES] for k, v in data.items()}, **cache_kw)
    del data
    K = bank.n_full_batches
    n_fwd, n_bwd = step_launches(train_cfg(exp16))
    want = {"flash_fwd_ble_bf16": n_fwd, "flash_bwd_ble_bf16": n_bwd}
    runs = {}
    for hoist in (False, True):
        cfg_ = with_train(train_cfg(exp16), hoist_fakes=hoist)
        engine = WGANGPEngine(cfg_, steps_per_epoch=K)
        state = engine.state_from_flax(params, d_params, seed=0)
        assert engine.hoist is hoist
        engine.step_many_cached(state, bank, 0)  # warm-up step and capture
        engine.step_many_cached(state, small, 0)
        busy = replay_busy(engine, state, small, 1)
        recorded = engine._cached_graphs[bank].recorded
        assert recorded == want, (hoist, recorded)
        runs[hoist] = {"engine": engine, "state": state, "sps": [], "busy": busy,
                       "recorded": recorded}
    launches = None
    for turn in range(HOIST_TURNS):
        for hoist in (False, True):
            r = runs[hoist]
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            _, metrics = r["engine"].step_many_cached(r["state"], bank, 1 + turn)
            torch.cuda.synchronize()
            r["sps"].append(K / (time.perf_counter() - t0))
            got = fa.launch_counts()
            assert all(np.isfinite(v) for v in floats(metrics).values()), metrics
            assert got == {**dict.fromkeys(KERNELS, 0),
                           **{k: n * K for k, n in want.items()}}, got
            if hoist:
                launches = got
    for hoist in (False, True):
        r = runs[hoist]
        busy = r["busy"] or {}
        print(f"    (c) graphed bf16 flagship, hoist_fakes={hoist}: steps/s per turn "
              f"{[round(v, 2) for v in r['sps']]} ({K}-step epochs, host clock) on {card}; a "
              f"replay: {busy.get('device_ms', 'not measured')} ms of device time, "
              f"{busy.get('device_events', 'not measured')} device events "
              f"({busy.get('readings')} readings); launches a replay {r['recorded']}",
              flush=True)
    gain = np.median(runs[True]["sps"]) / np.median(runs[False]["sps"])
    print(f"    (c) hoisted / not, median steps/s: {gain:.4f} on {card}", flush=True)
    del runs, bank, small
    torch.cuda.empty_cache()
    return launches


def bench_phase(fa, card) -> dict:
    """16 (d): `gemm_gan_tpu_torch.bench.measure` in bf16 and f32 at
    BENCH_SCAN_LEN rows, BENCH_CALLS calls: its JSON line (prefixed),
    launches of Q1 / Q2 equal every step's `step_launches`. Returns
    {"bench_bf16": launches, "bench_f32": launches}."""
    import torch

    from gemm_gan_tpu_torch import bench

    out = {}
    for dtype, label, mode in (("bfloat16", "bench_bf16", "_bf16"), ("float32", "bench_f32", "")):
        fa.reset_launch_counts()
        record = bench.measure(dtype, BENCH_SCAN_LEN, BENCH_CALLS)
        torch.cuda.synchronize()
        out[label] = fa.launch_counts()
        print(f"    (d) gemm_gan_tpu_torch.bench {dtype}: {json.dumps(record)}", flush=True)
        assert np.isfinite(record["value"]) and record["value"] > 0, record
        n_fwd, n_bwd = step_launches(bench.bench_config(dtype))
        steps = BENCH_SCAN_LEN * BENCH_CALLS
        assert out[label] == {**dict.fromkeys(KERNELS, 0), f"flash_fwd_ble{mode}": n_fwd * steps,
                              f"flash_bwd_ble{mode}": n_bwd * steps}, out[label]
        torch.cuda.empty_cache()
    return out


# phase 17, multi-device at world size 1: the bank of (c)'s graphed epochs,
# and the turns of its steps/s
MESH_BANK_CASES, MESH_TURNS = 256, 4


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _net_tensors(state) -> dict:
    """Every parameter and buffer of a GAN state, the optimizers' moments
    and counts, detached copies."""
    out = {}
    for net in ("gen", "critic"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v.detach().clone()
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        out[f"{name}.count_t"] = opt.count_t.clone()
        for i, t in enumerate(opt.nu):
            out[f"{name}.nu.{i}"] = t.clone()
    return out


def mesh_phase(fa, card, exp, params, d_params, batch, runs: str, layout: str) -> dict:
    """Phase 17: the mesh paths at world size 1 on the card. (a)
    `distributed_init` over NCCL (a one-rank group on a free localhost port)
    and `make_mesh(1, 1)`; (b) the flagship f32 per_update + batched_scores
    step (dropout 0) on the mesh against the unmeshed step from the same
    params and draws: params, moments and metrics bitwise equal (a one-rank
    all-reduce and one-rank shards change no value; two unmeshed steps are
    held bitwise first, the control), Q1 / Q2 launches equal; (c) the graphed
    bf16 `step_many_cached` (phase 9 (c)'s setting) on the mesh and off it
    over a MESH_BANK_CASES bank: median steps/s of MESH_TURNS epochs each,
    in turns, a replay's device ms and events (`replay_busy`) and their
    difference by kernel, launches a replay equal (the NCCL all-reduces are
    captured in the graph); (d) `Experiment` with `data.shard_bank=True` on
    the mesh (a `ShardedDeviceCache` with S = 1) for one epoch of phase 10's
    RESUME_CASES layout with the product run's config, then
    `evaluate("last")`; (e) the process group destroyed. Returns the mesh
    paths' launches."""
    import torch
    import torch.distributed as dist

    from gemm_gan_tpu_torch.cli.experiment import Experiment
    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.data.device_cache import DeviceCache, ShardedDeviceCache
    from gemm_gan_tpu_torch.data.tcga import load_tcga
    from gemm_gan_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    t_phase = time.perf_counter()
    launches = {}
    # (a)
    port = _free_port()
    assert distributed_init(f"127.0.0.1:{port}", 1, 0)
    backend = dist.get_backend()
    assert backend == "nccl", backend
    mesh = make_mesh(1, 1)
    print(f"[17] multi-device at world size 1: (a) process group {backend} (tcp://127.0.0.1:"
          f"{port}, world {dist.get_world_size()}), mesh {mesh.shape} on {mesh.device}",
          flush=True)
    try:
        # (b)
        cfg0 = with_train(train_cfg(exp, dropout=0.0), batch_size=BATCH)
        draws = random_draws(cfg0, seed=17)
        steps = {}
        for label, m in (("plain", None), ("plain again", None), ("mesh", mesh)):
            engine = WGANGPEngine(cfg0, steps_per_epoch=1, mesh=m)
            state = engine.state_from_flax(params, d_params)
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            state, metrics = engine.step(state, batch, draws=draws)
            torch.cuda.synchronize()
            steps[label] = (_net_tensors(state), floats(metrics), fa.launch_counts())
            del engine, state
        n_fwd, n_bwd = step_launches(cfg0)
        want = {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble": n_fwd, "flash_bwd_ble": n_bwd}
        for label in ("plain again", "mesh"):
            tensors, metrics, counts = steps[label]
            differ = [k for k, v in tensors.items() if not torch.equal(v, steps["plain"][0][k])]
            assert not differ, (label, differ[:5])
            assert metrics == steps["plain"][1], (label, metrics, steps["plain"][1])
            assert counts == want, (label, counts, want)
        launches["mesh_step"] = steps["mesh"][2]
        print(f"    (b) one f32 flagship step (per_update, batched_scores, dropout 0) on the 1x1 "
              f"mesh vs unmeshed from the same params and draws: {len(steps['mesh'][0])} "
              f"tensors (params, buffers, moments, counts) and the metrics bitwise equal (two "
              f"unmeshed steps bitwise equal too); launches {nonzero(steps['mesh'][2])} both "
              f"ways = step_launches {(n_fwd, n_bwd)}; metrics {json.dumps(steps['mesh'][1])}",
              flush=True)
        del steps

        # (c)
        exp16 = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                                   compute_dtype="bfloat16"))
        tcfg16 = train_cfg(exp16)
        data = bank_data(exp.model, MESH_BANK_CASES, seed=71)
        cache_kw = dict(batch_size=BATCH, num_patches=NUM_PATCHES, seed=0,
                        embedding_store_dtype=torch.bfloat16)
        bank = DeviceCache(data, **cache_kw)
        small = DeviceCache({k: v[:SMALL_CASES] for k, v in data.items()}, **cache_kw)
        del data
        K = bank.n_full_batches
        n_fwd, n_bwd = step_launches(tcfg16)
        want = {"flash_fwd_ble_bf16": n_fwd, "flash_bwd_ble_bf16": n_bwd}
        runs_c = {}
        for label, m in (("unmeshed", None), ("mesh", mesh)):
            engine = WGANGPEngine(tcfg16, steps_per_epoch=K, mesh=m)
            state = engine.state_from_flax(params, d_params, seed=0)
            torch.manual_seed(0)
            engine.step_many_cached(state, bank, 0)  # warm-up step and capture
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            _, metrics = engine.step_many_cached(state, bank, 1)
            torch.cuda.synchronize()
            got = fa.launch_counts()
            recorded = engine._cached_graphs[bank].recorded
            assert recorded == want, (label, recorded)
            assert got == {**dict.fromkeys(KERNELS, 0), **{k: n * K for k, n in want.items()}}, got
            metrics = floats(metrics)
            assert all(np.isfinite(v) for v in metrics.values()), metrics
            engine.step_many_cached(state, small, 0)
            busy = replay_busy(engine, state, small, 1) or {}
            runs_c[label] = {"engine": engine, "state": state, "sps": [], "busy": busy,
                             "metrics": metrics}
            if m is not None:
                launches["mesh_bf16_epoch_loop"] = got
        # steps/s in turns (unmeshed, mesh, mesh, unmeshed, ...): the host
        # clock of one call moves by several % between epochs
        for turn in range(MESH_TURNS):
            order = ("unmeshed", "mesh") if turn % 2 == 0 else ("mesh", "unmeshed")
            for label in order:
                r = runs_c[label]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r["engine"].step_many_cached(r["state"], bank, 2 + turn)
                torch.cuda.synchronize()
                r["sps"].append(K / (time.perf_counter() - t0))
        for r in runs_c.values():
            r["sps"] = float(np.median(r["sps"])), [round(v, 2) for v in r["sps"]]
            del r["engine"], r["state"]
        for label, r in runs_c.items():
            print(f"    (c) graphed bf16 flagship {label}: median {r['sps'][0]:.2f} steps/s of "
                  f"{MESH_TURNS} {K}-step epochs of replays in turns {r['sps'][1]} (host "
                  f"clock) on {card}; a replay: "
                  f"{r['busy'].get('device_ms', 'not measured')} ms of device time, "
                  f"{r['busy'].get('device_events', 'not measured')} device events "
                  f"({r['busy'].get('readings')} readings); launches a replay {want}; top "
                  f"kernels a step (name, calls, ms) {json.dumps(r['busy'].get('top'))}; "
                  f"metrics {json.dumps(r['metrics'])}", flush=True)
        extra_ms = (runs_c["mesh"]["busy"].get("device_ms", float("nan"))
                    - runs_c["unmeshed"]["busy"].get("device_ms", float("nan")))
        print(f"    (c) mesh / unmeshed median steps/s: "
              f"{runs_c['mesh']['sps'][0] / runs_c['unmeshed']['sps'][0]:.4f}; device time a "
              f"replay {extra_ms:+.4f} ms on the mesh, on {card}", flush=True)
        names = (runs_c["mesh"]["busy"].get("by_name"), runs_c["unmeshed"]["busy"].get("by_name"))
        if all(names):
            diff = {k: (names[0].get(k, (0, 0))[0] - names[1].get(k, (0, 0))[0],
                        names[0].get(k, (0, 0))[1] - names[1].get(k, (0, 0))[1])
                    for k in set(names[0]) | set(names[1])}
            grown = sorted(diff.items(), key=lambda kv: -abs(kv[1][1]))[:8]
            print(f"    (c) mesh minus unmeshed a replay, by kernel (name, calls, ms): "
                  f"{json.dumps([(k[:90], round(c, 2), round(ms, 4)) for k, (c, ms) in grown])}",
                  flush=True)
        del bank, small, runs_c
        torch.cuda.empty_cache()

        # (d)
        cfg = load_config(os.path.join(runs, "product", "config.json"))
        cfg = dataclasses.replace(
            cfg, output_dir=runs, run_name="mesh",
            train=dataclasses.replace(cfg.train, epochs=1),
            data=dataclasses.replace(cfg.data, data_dir=layout, shard_bank=True))
        splits = load_tcga(layout, schema="multi_token", num_patches=cfg.data.num_patches,
                           normalization=cfg.data.normalization, seed=cfg.data.seed,
                           patch_bank=True)
        t0 = time.perf_counter()
        experiment = Experiment(cfg, splits, mesh=mesh)
        assert isinstance(experiment.loaders["train"], ShardedDeviceCache)
        fa.reset_launch_counts()
        fit = experiment.fit()
        launches["mesh_experiment"] = fa.launch_counts()
        fit_s = time.perf_counter() - t0
        ev = experiment.evaluate("last")
        assert np.isfinite(fit["gamma_mean"]) and np.isfinite(ev["gamma_mean"]), (fit, ev)
        dumps = sorted(os.listdir(os.path.join(runs, "mesh", "test_0_epoch_1")))
        assert "data_gen.npy" in dumps and "test_gen.npy" in dumps, dumps
        print(f"    (d) Experiment on the 1x1 mesh with data.shard_bank (a ShardedDeviceCache, "
              f"S = 1, {len(experiment.loaders['train'])} steps an epoch) over phase 10's "
              f"{RESUME_CASES}-case layout: fit (1 epoch, the test block) {fit_s:.1f} s, "
              f"gamma_mean {fit['gamma_mean']:.4f}; evaluate('last') gamma_mean "
              f"{ev['gamma_mean']:.4f}; launches {nonzero(launches['mesh_experiment'])}; dumps "
              f"{dumps} on {card}", flush=True)
        del experiment, splits
    finally:
        # (e)
        dist.destroy_process_group()
    print(f"    (e) process group destroyed; phase 17 took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}", flush=True)
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch / CUDA port.")
    ap.add_argument("--through", type=int, default=None, metavar="PHASE",
                    help="stop after this phase, printing no result (to check the build "
                         "and the kernels alone: --through 2)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gemm_gan_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(gemm_gan_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.data.device_cache import DeviceCache
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.kernels import build
    from gemm_gan_tpu_torch.kernels import flash_attention as fa
    from gemm_gan_tpu_torch.serving import GeneratorServer
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 off for "
          f"matmul and cuDNN", flush=True)

    # ---- 1. build
    _, build_s, log = build.build()
    build.load()
    print(f"[1] built kernels in {build_s:.1f} s", flush=True)
    for line in ptxas_report(log):  # ptxas -v, one entry per template instantiation
        print(line)
    check_tiles(log)
    print(f"    tiles (bf16 modes on bf16 refs): {json.dumps(TILES)}", flush=True)
    for name in build.TENSOR_CORE_KERNELS:  # dynamic shared memory
        for D in fa.HEAD_DIMS:
            smem, blocks = build.occupancy(name, D)
            print(f"    {name} D={D}: {smem} bytes of dynamic shared memory per block, "
                  f"{blocks} blocks per SM", flush=True)

    # ---- 2. kernels against their plain versions
    print(f"[2] kernels vs plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})", flush=True)
    errs = {name: 0.0 for name in KERNELS}
    cases = [("ble", 8, 4, 257, 257, 64), ("ble", 2, 2, 130, 260, 64),
             ("ble", 2, 2, 136, 260, 8), ("ble", 2, 2, 136, 260, 128),
             ("bhld", 8, 4, 4097, 4097, 64), ("bhld", 2, 2, 130, 260, 64),
             ("bhld", 2, 2, 136, 600, 64), ("bhld", 2, 2, 136, 600, 8),
             ("bhld", 2, 2, 136, 600, 128),
             ("ble", *XATTN_TOKENS_SHAPE), ("bhld", *XATTN_WHOLE_SLIDE_SHAPE)]
    for i, case in enumerate(cases):
        name = "flash_fwd_" + case[0]
        errs[name] = max(errs[name], check_kernel(fa, *case, True, seed=i)[0])
    bwd_cases = [("flash_bwd_ble", ("ble", 8, 4, 257, 257, 64)),
                 ("flash_bwd_ble", ("ble", 2, 2, 130, 260, 64)),
                 ("flash_bwd_bhld_fused", ("bhld", 8, 4, 257, 257, 64)),
                 ("flash_bwd_bhld_fused", ("bhld", 2, 2, 130, 260, 64))]
    bwd_cases += [("flash_bwd_bhld_fused", ("bhld", 2, 2, 136, 260, D)) for D in (8, 128)]
    bwd_cases += [(name, ("bhld", 8, 4, 4097, 4097, 64))
                  for name in ("flash_bwd_dq", "flash_bwd_dkv")]
    bwd_cases += [(name, ("bhld", 2, 2, 136, 600, D))
                  for name in ("flash_bwd_dq", "flash_bwd_dkv") for D in (8, 64, 128)]
    bwd_cases += [("flash_bwd_ble", ("ble", 2, 2, 136, 260, D)) for D in (8, 128)]
    bwd_cases += [("flash_bwd_ble", ("ble", *XATTN_TOKENS_SHAPE))]
    bwd_cases += [(name, ("bhld", *XATTN_WHOLE_SLIDE_SHAPE))
                  for name in ("flash_bwd_dq", "flash_bwd_dkv")]
    for i, (name, case) in enumerate(bwd_cases):
        errs[name] = max(errs[name], check_bwd_kernel(fa, name, *case, True, seed=20 + i)[0])
    # the main paths' shapes with all-valid masks (structured data): checked and timed
    timed = {}
    for name, case in (("flash_fwd_ble", ("ble", 8, 4, 257, 257, 64)),
                       ("flash_fwd_bhld", ("bhld", 8, 4, 4097, 4097, 64))):
        err, (q, k, v, mask) = check_kernel(fa, *case, False, seed=100)
        errs[name] = max(errs[name], err)
        layout, _, H, Lq, _, D = case
        timed[name] = time_kernel(fa, layout, H, Lq, D, q, k, v, mask)
        print(f"  {name}: {json.dumps(timed[name])}", flush=True)
        del q, k, v, mask
    for name, case in (("flash_bwd_ble", ("ble", 8, 4, 257, 257, 64)),
                       ("flash_bwd_bhld_fused", ("bhld", 8, 4, 257, 257, 64)),
                       ("flash_bwd_dq", ("bhld", 8, 4, 4097, 4097, 64)),
                       ("flash_bwd_dkv", ("bhld", 8, 4, 4097, 4097, 64))):
        err, args = check_bwd_kernel(fa, name, *case, False, seed=200)
        errs[name] = max(errs[name], err)
        timed[name] = time_bwd_kernel(fa, name, case[0], case[2], args)
        print(f"  {name}: {json.dumps(timed[name])}", flush=True)
        del args
    check_bf16_modes(fa, errs, timed)
    torch.cuda.empty_cache()
    print(f"  torch.profiler: {PROFILER_READINGS['readings']} readings for "
          f"{PROFILER_READINGS['times']} device times (two each when no record is missed)",
          flush=True)
    if opts.through == 2:
        print("stopped after phase 2 (--through 2): no result", flush=True)
        return 0

    # ---- 3. serving, the main path at full width
    exp = variant_config("film_cross_attention")
    cfg = exp.model
    params = flax_param_tree(cfg, seed=0)
    server = GeneratorServer.from_flax(cfg, params)
    keys = server.keys
    data = structured_dataset(n=BATCH * N_BATCHES, n_genes=cfg.n_genes)
    batches = [{k: data[k][i * BATCH:(i + 1) * BATCH] for k in (*keys, "genes")}
               for i in range(N_BATCHES)]
    server.sample_all(batches[:1], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.sample_all(batches, REPEATS, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"serving": fa.launch_counts()}
    n_profiles = BATCH * N_BATCHES * REPEATS
    print(f"[3] serving: {N_BATCHES} batches x {BATCH} x {REPEATS} repeats -> "
          f"{out['fake'].shape}; launches {launches['serving']}", flush=True)
    assert out["fake"].shape == (n_profiles, cfg.n_genes), out["fake"].shape
    assert np.isfinite(out["fake"]).all(), "non-finite profiles"
    assert launches["serving"] == {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble":
                                   cfg.fusion.num_layers * N_BATCHES}, launches
    print(f"    {n_profiles / main_s:.1f} profiles/s ({main_s * 1e3:.1f} ms for "
          f"{n_profiles} profiles, host data to host profiles) on {card}", flush=True)
    print(f"    device ms per batch of {BATCH}: {json.dumps(device_breakdown(server, batches[0]))}",
          flush=True)

    cpu_server = GeneratorServer.from_flax(cfg, params, device="cpu")
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    on_card = server(z, batches[0]).cpu()
    on_cpu = cpu_server(z, batches[0])
    e2e_err = float((on_card - on_cpu).abs().max())
    print(f"    card vs CPU on one batch: max|err|={e2e_err:.3e} "
          f"(max|out|={float(on_cpu.abs().max()):.3f}; rtol {E2E_RTOL}, "
          f"atol {E2E_ATOL})", flush=True)
    torch.testing.assert_close(on_card, on_cpu, rtol=E2E_RTOL, atol=E2E_ATOL)
    del cpu_server

    # ---- 4. whole-slide serving
    ws = structured_dataset(n=BATCH, n_genes=cfg.n_genes, num_patches=WHOLE_SLIDE_PATCHES)
    ws_batch = {k: ws[k] for k in (*keys, "genes")}
    server.sample_all([ws_batch], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ws_out = server.sample_all([ws_batch], 1, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    ws_s = time.perf_counter() - t0
    launches["whole_slide_serving"] = fa.launch_counts()
    print(f"[4] whole-slide serving: {WHOLE_SLIDE_PATCHES} patches x batch {BATCH} -> "
          f"{ws_out['fake'].shape}; launches {launches['whole_slide_serving']}; "
          f"{BATCH / ws_s:.1f} profiles/s ({ws_s * 1e3:.1f} ms) on {card}", flush=True)
    assert ws_out["fake"].shape == (BATCH, cfg.n_genes)
    assert np.isfinite(ws_out["fake"]).all(), "non-finite whole-slide profiles"
    assert launches["whole_slide_serving"] == {
        **dict.fromkeys(KERNELS, 0), "flash_fwd_bhld": cfg.fusion.num_layers}, launches
    ref_cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, use_pallas=False))
    ref_server = GeneratorServer.from_flax(ref_cfg, params)
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(4))
    with_kernels = server(z, ws_batch).cpu()
    with_reference = ref_server(z, ws_batch).cpu()
    ws_err = float((with_kernels - with_reference).abs().max())
    print(f"    kernels vs use_pallas=False (blocked reference), both on the card, one "
          f"whole-slide batch: max|err|={ws_err:.3e} (max|out|="
          f"{float(with_reference.abs().max()):.3f}; rtol {E2E_RTOL}, atol {E2E_ATOL})",
          flush=True)
    torch.testing.assert_close(with_kernels, with_reference, rtol=E2E_RTOL, atol=E2E_ATOL)
    del server, ref_server

    # ---- 5. training, the main path at full width
    tcfg = train_cfg(exp)
    d_params = flax_param_tree(cfg, seed=1, critic=True)
    engine = WGANGPEngine(tcfg, steps_per_epoch=len(batches))
    state = engine.state_from_flax(params, d_params)
    before = [p.detach().clone() for p in (state.gen.trunk.head.weight,
                                           state.critic.trunk.head.weight)]
    state, train_s, launches["training"], metrics = run_steps(
        engine, state, batches, TRAIN_STEPS, fa)
    n_fwd, n_bwd = step_launches(tcfg)
    print(f"[5] training: {TRAIN_STEPS} steps of batch {BATCH}, n_critic "
          f"{tcfg.train.n_critic}, per_update + batched_scores; launches "
          f"{launches['training']}; last metrics {json.dumps(metrics)}", flush=True)
    assert launches["training"] == {**dict.fromkeys(KERNELS, 0),
                                    "flash_fwd_ble": n_fwd * TRAIN_STEPS,
                                    "flash_bwd_ble": n_bwd * TRAIN_STEPS}, launches
    for old, new in zip(before, (state.gen.trunk.head.weight, state.critic.trunk.head.weight)):
        assert not torch.equal(old, new.detach()), "params did not move"
    print(f"    {TRAIN_STEPS / train_s:.2f} steps/s ({train_s * 1e3 / TRAIN_STEPS:.1f} ms "
          f"per step, host clock) on {card}", flush=True)
    busy = device_busy(engine, state, batches[0])
    eager_busy_ms = "not measured" if busy is None else f"{busy['device_ms']:.2f}"
    if busy is None:
        print("    device busy share: not measured (the profiler saw no device time)")
    else:
        step_ms = train_s * 1e3 / TRAIN_STEPS
        print(f"    device busy share: {busy['device_ms']:.2f} ms of device time per step "
              f"(torch.profiler, {busy['readings']} readings) / {step_ms:.1f} ms per step = "
              f"{busy['device_ms'] / step_ms:.3f}; {busy['aten_ops']} aten ops on the "
              f"host (nested ones included); top kernels (name, calls, ms): "
              f"{json.dumps(busy['top'])}", flush=True)
    print(f"    device ms of one step's parts: "
          f"{json.dumps(step_breakdown(engine, state, batches[0]))}", flush=True)
    del engine, state
    step_args = (params, d_params, batches[0], random_draws(tcfg, seed=5))
    on_cpu = run_step(train_cfg(exp, dropout=0.0), "cpu", *step_args)
    plain = step_diff(run_step(train_cfg(exp, dropout=0.0, use_pallas=False), "cuda",
                               *step_args), on_cpu, max_loose={})
    print(f"    use_pallas=False on the card vs CPU, one step at dropout 0 (count not gated): "
          f"{json.dumps(plain)}", flush=True)
    cmp = step_diff(run_step(train_cfg(exp, dropout=0.0), "cuda", *step_args), on_cpu)
    print(f"    card vs CPU, one step at dropout 0: {json.dumps(cmp)} (metrics rtol "
          f"{STEP_RTOL}, atol {STEP_ATOL}; at most {MAX_LOOSE} params beyond atol "
          f"{PARAM_ATOL})", flush=True)
    gate = grad_gate(fa, train_cfg(exp, dropout=0.0), "cuda", step_args, "flash_fwd_ble")
    assert gate["launches"].get("flash_fwd_ble") and gate["launches"].get("flash_bwd_ble"), gate
    print(f"    f32 gradient gate at the same step's starting params (||g - g_cpu|| / ||g_cpu|| "
          f"of the fusions' params' gradients under the CPU step's cotangents; per param at "
          f"most {PLAIN_LOOSE_FACTOR} x the plain versions' on the card or {GRAD_GATE_FLOOR}; "
          f"whole nets and the largest ratio to its limit printed, the controls' too): "
          f"{json.dumps(gate)}; the controls scale flash_fwd_ble's output by {Q1_SCALE} or mask "
          f"the last valid key of every row", flush=True)

    # ---- 6. whole-slide training
    engine = WGANGPEngine(tcfg, steps_per_epoch=1)
    state = engine.state_from_flax(params, d_params)
    state, ws_train_s, launches["whole_slide_training"], metrics = run_steps(
        engine, state, [ws_batch], WS_TRAIN_STEPS, fa)
    print(f"[6] whole-slide training: {WS_TRAIN_STEPS} steps, {WHOLE_SLIDE_PATCHES} "
          f"patches x batch {BATCH}; launches {launches['whole_slide_training']}; "
          f"{WS_TRAIN_STEPS / ws_train_s:.3f} steps/s "
          f"({ws_train_s * 1e3 / WS_TRAIN_STEPS:.1f} ms per step) on {card}", flush=True)
    assert launches["whole_slide_training"] == {
        **dict.fromkeys(KERNELS, 0), "flash_fwd_bhld": n_fwd * WS_TRAIN_STEPS,
        "flash_bwd_dq": n_bwd * WS_TRAIN_STEPS,
        "flash_bwd_dkv": n_bwd * WS_TRAIN_STEPS}, launches
    print_device_busy("whole-slide f32 step", engine, state, ws_batch,
                      ws_train_s / WS_TRAIN_STEPS)
    del engine, state
    cmp, plain, max_loose = relative_step_gate(
        fa, lambda **kw: train_cfg(exp, dropout=0.0, **kw),
        ("cuda", params, d_params, ws_batch, random_draws(tcfg, seed=6)))
    print(f"    kernels vs use_pallas=False (blocked reference), both on the card, one "
          f"whole-slide step at dropout 0: {json.dumps(cmp)}; the plain versions on the "
          f"card vs the same: {json.dumps(plain)} (metrics rtol {STEP_RTOL}, atol "
          f"{STEP_ATOL}; params beyond atol {PARAM_ATOL} per net at most {max_loose})",
          flush=True)
    torch.cuda.empty_cache()

    # ---- 7. canonical training in the classic layout
    bcfg = train_cfg(exp, flash_layout="bhld")
    engine = WGANGPEngine(bcfg, steps_per_epoch=len(batches))
    state = engine.state_from_flax(params, d_params)
    fa.reset_launch_counts()
    state, metrics = engine.step(state, batches[0])
    torch.cuda.synchronize()
    launches["bhld_training"] = fa.launch_counts()
    print(f"[7] bhld training: one step; launches {launches['bhld_training']}; "
          f"metrics {json.dumps({k: float(v) for k, v in metrics.items()})}", flush=True)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert launches["bhld_training"] == {
        **dict.fromkeys(KERNELS, 0), "flash_fwd_bhld": n_fwd,
        "flash_bwd_bhld_fused": n_bwd}, launches
    del engine, state
    cmp, plain, max_loose = relative_step_gate(
        fa, lambda **kw: train_cfg(exp, dropout=0.0, flash_layout="bhld", **kw),
        ("cuda", params, d_params, batches[0], random_draws(bcfg, seed=7)))
    print(f"    kernels vs use_pallas=False (plain reference), both on the card, one bhld "
          f"step at dropout 0: {json.dumps(cmp)}; the plain versions on the card vs the "
          f"same: {json.dumps(plain)} (metrics rtol {STEP_RTOL}, atol {STEP_ATOL}; params "
          f"beyond atol {PARAM_ATOL} per net at most {max_loose})", flush=True)
    torch.cuda.empty_cache()

    # ---- 8. the epoch loop: DeviceCache + step_many_cached / step_many as CUDA graphs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = bank_data(cfg, BANK_CASES, seed=8)
    cache_kw = dict(batch_size=BATCH, num_patches=NUM_PATCHES, seed=0,
                    embedding_store_dtype=torch.bfloat16)
    bank = DeviceCache(data, **cache_kw)
    small = DeviceCache({k: v[:SMALL_CASES] for k, v in data.items()}, **cache_kw)
    del data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bank_gb = sum(t.numel() * t.element_size() for t in bank.arrays.values()) / 1e9
    print(f"[8] epoch loop: bank of {BANK_CASES} cases ({BANK_SLOTS} patch slots, "
          f"{NUM_TOKENS} tokens, bf16 store) = {bank_gb:.3f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f} s; {NUM_PATCHES} patches subsampled per "
          f"step", flush=True)

    def fresh(cfg_, cache):
        engine_ = WGANGPEngine(cfg_, steps_per_epoch=cache.n_full_batches)
        return engine_, engine_.state_from_flax(params, d_params, seed=0)

    def epoch_runs(cfg_, label, cache=small, paths=("step_many_cached", "step_many")):
        """(a) and (d): one epoch of the small cache through each of `paths`
        (step_many_cached, step_many on the stacked epoch) and eager steps,
        each from the same state and seeds. Returns {path: (engine, state,
        metrics)}."""
        runs = {}
        for path in (*paths, "eager"):
            engine_, state_ = fresh(cfg_, cache)
            torch.manual_seed(0)  # dropout
            if path == "step_many_cached":
                state_, m = engine_.step_many_cached(state_, cache, 0)
            elif path == "step_many":
                state_, m = engine_.step_many(state_, cache.stacked_epoch(0))
            else:
                for b in cache.epoch(0):
                    state_, m = engine_.step(state_, b)
            torch.cuda.synchronize()
            runs[path] = (engine_, state_, floats(m))
        eager = runs["eager"][1:]
        for path in paths:
            got = runs[path][1:]
            cmp = step_diff(got, eager)
            print(f"    ({label}) {path} vs eager steps, {cache.n_full_batches}-step epoch "
                  f"of {SMALL_CASES} cases: bitwise equal {identical(got, eager)}; "
                  f"{json.dumps(cmp)} (metrics rtol {STEP_RTOL}, atol {STEP_ATOL}; at most "
                  f"{MAX_LOOSE} params beyond atol {PARAM_ATOL})", flush=True)
        return runs

    runs = epoch_runs(tcfg, "a, d")
    g_engine, g_state, _ = runs["step_many_cached"]
    del runs

    # (b), (c): two full epochs on the bank, the second replays only
    engine, state = fresh(tcfg, bank)
    K = bank.n_full_batches
    before = [p.detach().clone() for p in (state.gen.trunk.head.weight,
                                           state.critic.trunk.head.weight)]
    want = {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble": n_fwd * K, "flash_bwd_ble": n_bwd * K}
    epoch_s = []
    for e in (0, 1):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = engine.step_many_cached(state, bank, e)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        launches[f"epoch_loop_{e}"] = fa.launch_counts()
        assert launches[f"epoch_loop_{e}"] == want, (launches, want)
        metrics = floats(metrics)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    recorded = engine._cached_graphs[bank].recorded
    assert recorded == {"flash_fwd_ble": n_fwd, "flash_bwd_ble": n_bwd}, recorded
    for old, new in zip(before, (state.gen.trunk.head.weight, state.critic.trunk.head.weight)):
        assert not torch.equal(old, new.detach()), "params did not move"
    pool = graph_pool_bytes()
    graphed_sps, eager_sps = K / epoch_s[1], TRAIN_STEPS / train_s
    print(f"    (b) {K}-step epochs through step_many_cached: epoch 0 (eager warm-up step, "
          f"capture, {K - 1} replays) {epoch_s[0]:.3f} s; epoch 1 ({K} replays) "
          f"{epoch_s[1]:.3f} s = {graphed_sps:.2f} steps/s ({epoch_s[1] * 1e3 / K:.2f} ms "
          f"per step, host clock) against phase 5's eager {eager_sps:.2f} steps/s "
          f"({graphed_sps / eager_sps:.2f}x) on {card}; last metrics {json.dumps(metrics)}",
          flush=True)
    print(f"    (c) launches per epoch {launches['epoch_loop_1']} = {K} steps x "
          f"step_launches {step_launches(tcfg)}; one replay records {recorded}", flush=True)
    busy = replay_busy(g_engine, g_state, small, 1)
    if busy is None:
        print(f"    device busy share of replayed steps: not measured (the profiler saw no "
              f"device time); one eager step's device time is {eager_busy_ms} ms against "
              f"{epoch_s[1] * 1e3 / K:.2f} ms per replayed step on {card}", flush=True)
    else:
        print(f"    device busy share of replayed steps: {busy['device_ms']:.2f} ms of device "
              f"time per step (torch.profiler, {busy['readings']} readings, "
              f"{busy['device_events']:.0f} device events) / "
              f"{busy['host_ms']:.2f} ms per step = {busy['device_ms'] / busy['host_ms']:.3f} "
              f"(eager, phase 5: {eager_busy_ms} ms of device time per step) on {card}; "
              f"top kernels per step (name, calls, ms): {json.dumps(busy['top'])}",
              flush=True)
    print(f"    memory: bank {bank_gb:.3f} GB; CUDA graph pools "
          f"{'not measured' if pool is None else f'{pool / 1e9:.3f} GB'}; peak allocated "
          f"over the phase {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}",
          flush=True)
    del engine, state, g_engine, g_state

    # a remat_layers=True epoch (dropout 0.1), the same three ways
    epoch_runs(train_cfg(exp, remat_layers=True), "remat")

    # ---- 9. the bench configuration: compute_dtype="bfloat16"
    exp16 = dataclasses.replace(exp, model=dataclasses.replace(cfg, compute_dtype="bfloat16"))
    cfg16 = exp16.model
    print(f"[9] bench configuration: compute_dtype=bfloat16; torch.backends.cuda.matmul."
          f"allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}", flush=True)
    launches["bf16_serving"] = bf16_serving(fa, cfg16, params, batches, "a", "flash_fwd_ble_bf16")
    launches["bf16_training_step"] = bf16_step(fa, exp16, params, d_params, batches[0], "b")

    # (c) graphed epochs in bf16: the small one against eager steps, then the bank
    tcfg16 = train_cfg(exp16)
    runs = epoch_runs(tcfg16, "c, bf16")
    g_engine, g_state, _ = runs["step_many_cached"]
    del runs
    engine, state = fresh(tcfg16, bank)
    want = {**dict.fromkeys(KERNELS, 0), "flash_fwd_ble_bf16": n_fwd * K,
            "flash_bwd_ble_bf16": n_bwd * K}
    epoch16_s = []
    for e in (0, 1):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = engine.step_many_cached(state, bank, e)
        torch.cuda.synchronize()
        epoch16_s.append(time.perf_counter() - t0)
        launches[f"bf16_epoch_loop_{e}"] = fa.launch_counts()
        assert launches[f"bf16_epoch_loop_{e}"] == want, (launches, want)
        metrics = floats(metrics)
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    recorded = engine._cached_graphs[bank].recorded
    assert recorded == {"flash_fwd_ble_bf16": n_fwd, "flash_bwd_ble_bf16": n_bwd}, recorded
    graphed16_sps = K / epoch16_s[1]
    print(f"    (c) bf16, {K}-step epochs through step_many_cached: epoch 0 {epoch16_s[0]:.3f} s; "
          f"epoch 1 ({K} replays) {epoch16_s[1]:.3f} s = {graphed16_sps:.2f} steps/s "
          f"({epoch16_s[1] * 1e3 / K:.2f} ms per step, host clock) against f32's "
          f"{graphed_sps:.2f} steps/s in phase 8 ({graphed16_sps / graphed_sps:.3f}x) on {card}; "
          f"launches per epoch {launches['bf16_epoch_loop_1']}: {K} steps x {n_fwd} "
          f"flash_fwd_ble_bf16 and {n_bwd} flash_bwd_ble_bf16; last metrics "
          f"{json.dumps(metrics)}", flush=True)
    busy16 = replay_busy(g_engine, g_state, small, 1)
    if busy16 is None or busy is None:
        print("    bf16 replay busy share: not measured (the profiler saw no device time)",
              flush=True)
    else:
        print(f"    bf16 replayed steps: {busy16['device_ms']:.2f} ms of device time per step "
              f"({busy16['readings']} readings, {busy16['device_events']:.0f} device events) / "
              f"{busy16['host_ms']:.2f} ms = busy "
              f"{busy16['device_ms'] / busy16['host_ms']:.3f}, against f32 (phase 8) "
              f"{busy['device_ms']:.2f} ms, {busy['device_events']:.0f} events, busy "
              f"{busy['device_ms'] / busy['host_ms']:.3f} on {card}; bf16 top kernels per step "
              f"(name, calls, ms): {json.dumps(busy16['top'])}", flush=True)
    del engine, state, g_engine, g_state, bank
    torch.cuda.empty_cache()

    # (d) mxu_bf16 on the bf16 refs: serving and one step against the CPU
    exp16m = dataclasses.replace(exp16, model=dataclasses.replace(
        cfg16, fusion=dataclasses.replace(cfg16.fusion, flash_mxu_bf16=True)))
    launches["mxu_serving"] = bf16_serving(fa, exp16m.model, params, batches, "d",
                                           "flash_fwd_ble_mxu")
    launches["mxu_training_step"] = bf16_step(fa, exp16m, params, d_params, batches[0], "d")

    # (e) the classic layout in bf16: a canonical flash_layout="bhld" step
    launches["bf16_bhld_training"] = bhld_bf16_step(fa, exp16, params, d_params, batches[0], "e")

    # (f), (g) whole-slide bf16 serving and training
    ws_sps = WS_TRAIN_STEPS / ws_train_s
    launches["bf16_whole_slide_serving"] = whole_slide_bf16_serving(fa, cfg16, params, ws_batch,
                                                                    "f")
    launches["bf16_whole_slide_training"], ws_peak, sps16, ms16 = whole_slide_bf16_training(
        fa, exp16, params, d_params, ws_batch, "g", ws_sps)
    torch.cuda.empty_cache()

    # (h) the same with mxu_bf16, and a bhld mxu step (Q6's mxu mode)
    launches["mxu_whole_slide_serving"] = whole_slide_bf16_serving(fa, exp16m.model, params,
                                                                   ws_batch, "h")
    launches["mxu_whole_slide_training"], _, sps_m, ms_m = whole_slide_bf16_training(
        fa, exp16m, params, d_params, ws_batch, "h", ws_sps)
    eager_ws = {"bf16": (sps16, ms16), "mxu": (sps_m, ms_m)}
    launches["mxu_bhld_training"] = bhld_bf16_step(fa, exp16m, params, d_params, batches[0], "h")
    torch.cuda.empty_cache()

    # (i) train.grad_accum: a whole-slide bf16 step at batch 16 in 2 microbatches
    ws16 = structured_dataset(n=2 * BATCH, n_genes=cfg.n_genes, num_patches=WHOLE_SLIDE_PATCHES)
    ws16_batch = {k: ws16[k] for k in (*keys, "genes")}
    acfg16 = with_train(train_cfg(exp16), grad_accum=2)
    engine = WGANGPEngine(acfg16, steps_per_epoch=1)
    state = engine.state_from_flax(params, d_params)
    before = [p.detach().clone() for p in (state.gen.trunk.head.weight,
                                           state.critic.trunk.head.weight)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = engine.step(state, ws16_batch)
    torch.cuda.synchronize()
    accum_s = time.perf_counter() - t0
    accum_peak = torch.cuda.max_memory_allocated()
    launches["bf16_whole_slide_accum"] = fa.launch_counts()
    metrics = floats(metrics)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    for old, new in zip(before, (state.gen.trunk.head.weight, state.critic.trunk.head.weight)):
        assert not torch.equal(old, new.detach()), "params did not move"
    a_fwd, a_bwd = step_launches(acfg16)
    assert launches["bf16_whole_slide_accum"] == {
        **dict.fromkeys(KERNELS, 0), "flash_fwd_bhld_bf16": a_fwd, "flash_bwd_dq_bf16": a_bwd,
        "flash_bwd_dkv_bf16": a_bwd}, launches
    print(f"    (i) grad_accum=2: one whole-slide bf16 step of batch {2 * BATCH} x "
          f"{WHOLE_SLIDE_PATCHES} patches in 2 microbatches of {BATCH}: {accum_s * 1e3:.1f} ms "
          f"(the first of its engine) on {card}; peak memory {accum_peak / 1e9:.3f} GB beside "
          f"(g)'s batch of {BATCH}: {ws_peak / 1e9:.3f} GB; launches "
          f"{launches['bf16_whole_slide_accum']} = step_launches {(a_fwd, a_bwd)}; metrics "
          f"{json.dumps(metrics)}", flush=True)
    del engine, state, ws16, ws16_batch
    torch.cuda.empty_cache()
    step_args = (params, d_params, batches[0], random_draws(tcfg, seed=13))
    full = run_step(with_train(train_cfg(exp, dropout=0.0), grad_accum=1), "cuda", *step_args)
    cmp = step_diff(run_step(with_train(train_cfg(exp, dropout=0.0), grad_accum=2), "cuda",
                             *step_args), full)
    print(f"    (i) grad_accum=2 vs grad_accum=1, one canonical f32 step at dropout 0 on the card: "
          f"{json.dumps(cmp)} (metrics rtol {STEP_RTOL}, atol {STEP_ATOL}; at most {MAX_LOOSE} "
          f"params beyond atol {PARAM_ATOL})", flush=True)
    epoch_runs(with_train(tcfg, grad_accum=2), "i, grad_accum=2")
    del small
    torch.cuda.empty_cache()

    # (j) the graphed whole-slide epoch: a bank of whole slides on the card
    # through step_many_cached in bf16 and under mxu_bf16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = bank_data(cfg, WS_BANK_CASES, seed=14, slots=WS_BANK_SLOTS, min_valid=WS_MIN_VALID)
    ws_kw = dict(cache_kw, num_patches=WHOLE_SLIDE_PATCHES)
    ws_bank = DeviceCache(data, **ws_kw)
    ws_small = DeviceCache({k: v[:SMALL_CASES] for k, v in data.items()}, **ws_kw)
    del data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ws_bank_gb = sum(t.numel() * t.element_size() for t in ws_bank.arrays.values()) / 1e9
    print(f"    (j) whole-slide bank of {WS_BANK_CASES} cases ({WS_BANK_SLOTS} patch slots, "
          f"{WS_MIN_VALID}..{WS_BANK_SLOTS} valid; {NUM_TOKENS} tokens; bf16 store) = "
          f"{ws_bank_gb:.3f} GB on the card, made in {time.perf_counter() - t0:.1f} s; "
          f"{WHOLE_SLIDE_PATCHES} patches subsampled per step", flush=True)
    for exp_, mode in ((exp16, "bf16"), (exp16m, "mxu")):
        launches[f"{mode}_whole_slide_epoch_loop"] = graphed_whole_slide_epochs(
            fa, train_cfg(exp_), mode, ws_bank, ws_small, epoch_runs, fresh, eager_ws[mode])
        torch.cuda.empty_cache()
    print(f"    (j) memory: whole-slide bank {ws_bank_gb:.3f} GB; peak allocated over (j) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}", flush=True)
    del ws_bank, ws_small
    torch.cuda.empty_cache()

    # ---- 10. the product path: cli.train fit, evaluate best and last, resume
    # ---- 11. the variants; (e) trains on phase 10's layout
    # ---- 12. the post-hoc evaluator over phase 10's run
    # ---- 13. the VAE family; (d), (e) train on phase 10's layout
    # the layout and the runs stay until phase 17 has read them
    with tempfile.TemporaryDirectory() as root:
        runs = os.path.join(root, "runs")
        launches["product_fit"], layout = product_path(fa, card, root)
        torch.cuda.empty_cache()
        launches.update(variants_phase(fa, card, ws_batch, layout, runs))
        torch.cuda.empty_cache()
        launches["posthoc"] = posthoc_phase(fa, card, os.path.join(runs, "product"))
        launches["vae"] = vae_phase(fa, card, layout, runs)
        torch.cuda.empty_cache()
        # ---- 14. the serving artifact and cli.sample over phase 10's run
        launches.update(artifact_phase(fa, card, root))
        torch.cuda.empty_cache()
        # ---- 15. the encoders and the ingest path
        launches["encoders"] = encoders_phase(fa, card, root)
        torch.cuda.empty_cache()

        # ---- 16. t-SNE on the card, BatchNorm trunks, hoist_fakes, the bench
        t0 = time.perf_counter()
        launches["tsne"] = tsne_phase(card)
        launches["batchnorm_serving"] = batchnorm_phase(fa, card, exp, batches[0])
        launches["hoist_epoch_loop"] = hoist_phase(fa, card, exp, params, d_params, batches[0])
        launches.update(bench_phase(fa, card))
        print(f"    phase 16 took {time.perf_counter() - t0:.1f} s on {card}", flush=True)
        torch.cuda.empty_cache()

        # ---- 17. multi-device at world size 1 (NCCL), over phase 10's layout
        launches.update(mesh_phase(fa, card, exp, params, d_params, batches[0], runs, layout))
    torch.cuda.empty_cache()

    # ---- 18. report
    paths = {"flash_fwd_ble": "serving", "flash_fwd_bhld": "whole_slide_serving",
             "flash_bwd_ble": "training", "flash_bwd_dq": "whole_slide_training",
             "flash_bwd_dkv": "whole_slide_training",
             "flash_bwd_bhld_fused": "bhld_training",
             "flash_fwd_ble_bf16": "bf16_epoch_loop_1", "flash_bwd_ble_bf16": "bf16_epoch_loop_1",
             "flash_fwd_ble_mxu": "mxu_training_step", "flash_bwd_ble_mxu": "mxu_training_step",
             "flash_fwd_bhld_bf16": "bf16_whole_slide_epoch_loop",
             "flash_bwd_dq_bf16": "bf16_whole_slide_epoch_loop",
             "flash_bwd_dkv_bf16": "bf16_whole_slide_epoch_loop",
             "flash_bwd_bhld_fused_bf16": "bf16_bhld_training",
             "flash_fwd_bhld_mxu": "mxu_whole_slide_epoch_loop",
             "flash_bwd_dq_mxu": "mxu_whole_slide_epoch_loop",
             "flash_bwd_dkv_mxu": "mxu_whole_slide_epoch_loop",
             "flash_bwd_bhld_fused_mxu": "mxu_bhld_training"}
    print(f"[18] torch.profiler over the run: at most {PROFILER_READINGS['most_sentinels_lost']} "
          f"sentinel records lost at a window's start; lead-in now "
          f"{PROFILER_LEAD_IN['n']} sentinels", flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "tile": TILES[name], "path": paths[name],
                        "launches": launches[paths[name]][name],
                        "launches_by_path": {p: c[name] for p, c in launches.items()},
                        "max_abs_err": errs[name], **timed[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
