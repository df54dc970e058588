"""How far one bf16 training step's metrics move on the card under changes of
rounding alone, against the same step on the CPU.

    python3 scripts/torch_bf16_step_scatter.py [--mxu]

Needs one CUDA card and nvcc (the port's kernels are built at first use).
The step is `chip_smoke.py` phase 9 (b)'s (the flagship at its published
widths in the bench configuration, `compute_dtype="bfloat16"`, one
dropout-free per_update step of batch 8 from seeded Flax-layout params,
the same draws; `--mxu`: phase 9 (d)'s, `fusion.flash_mxu_bf16=True`). It
runs that step on the CPU (the reference), then on the card:

* with the kernels (what phase 9 (b) gates);
* with every kernel's plain PyTorch version (`chip_smoke.plain_kernels`);
* with `fusion.use_pallas=False` (phase 9 (b)'s yardstick);
* with the kernels but one of the step's kernels swapped for its plain
  version, for each kernel the step launches.

Each line prints the run's metrics minus the CPU step's, and the count of
params beyond chip_smoke's PARAM_ATOL. The last line gives, per metric, the
spread (largest minus smallest) over the card runs, beside the tolerance
that phase 9 (b) allows. A measuring tool: nothing here is gated.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mxu", action="store_true", help="the mxu_bf16 step (phase 9 (d))")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_step_scatter: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.kernels import flash_attention as fa
    from gemm_gan_tpu_torch.serving import GeneratorServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    exp = variant_config("film_cross_attention")
    cfg = dataclasses.replace(exp.model, compute_dtype="bfloat16")
    if args.mxu:
        cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, flash_mxu_bf16=True))
    exp16 = dataclasses.replace(exp, model=cfg)
    params = cs.flax_param_tree(cfg, seed=0)
    d_params = cs.flax_param_tree(cfg, seed=1, critic=True)
    keys = GeneratorServer.from_flax(cfg, params, device="cpu").keys
    data = structured_dataset(n=cs.BATCH * cs.N_BATCHES, n_genes=cfg.n_genes)
    batch = {k: data[k][:cs.BATCH] for k in (*keys, "genes")}  # phase 3's batches[0]

    def cfg_of(**kw):
        return cs.train_cfg(exp16, dropout=0.0, **kw)

    draws = cs.random_draws(cfg_of(), seed=9)
    ref = cs.run_step(cfg_of(), "cpu", params, d_params, batch, draws)
    print(f"CPU step metrics: {json.dumps(ref[1])}", flush=True)
    mode = "mxu" if args.mxu else "bf16"

    fa.reset_launch_counts()
    cs.run_step(cfg_of(), "cuda", params, d_params, batch, draws)
    launched = [k for k, n in fa.launch_counts().items() if n]
    runs = {"kernels": lambda: cs.run_step(cfg_of(), "cuda", params, d_params, batch, draws),
            "use_pallas=False": lambda: cs.run_step(cfg_of(use_pallas=False), "cuda", params,
                                                    d_params, batch, draws)}

    def plain_run(names):
        def run():
            saved = {n: getattr(fa, n) for n in names}
            try:
                for n in names:
                    setattr(fa, n, getattr(fa, n + "_plain"))
                return cs.run_step(cfg_of(), "cuda", params, d_params, batch, draws)
            finally:
                for n, k in saved.items():
                    setattr(fa, n, k)
        return run

    runs["every kernel plain"] = plain_run([k.__name__ for k in fa.KERNELS])
    for name in launched:
        runs[f"{name} plain"] = plain_run([name])
    moved = {}
    for label, run in runs.items():
        got = run()
        summary = cs.step_diff(got, ref, {}, rtol=None)
        moved[label] = {k: got[1][k] - ref[1][k] for k in ref[1]}
        print(f"{mode} step, {label}: metrics minus CPU {json.dumps(moved[label])}; params "
              f"beyond atol {cs.PARAM_ATOL}: {summary['beyond_atol_by_net']}", flush=True)
    plain = moved["use_pallas=False"]
    tol = {k: max(cs.BF16_STEP_RTOL * abs(v), cs.PLAIN_LOOSE_FACTOR * abs(plain[k]))
           for k, v in ref[1].items()}
    spread = {k: max(m[k] for m in moved.values()) - min(m[k] for m in moved.values())
              for k in ref[1]}
    print(f"{mode} step: spread of each metric over the {len(moved)} card runs "
          f"{json.dumps(spread)}; phase 9's tolerance (its own value's "
          f"{cs.BF16_STEP_RTOL} or {cs.PLAIN_LOOSE_FACTOR} x use_pallas=False's distance) "
          f"{json.dumps(tol)}; bf16_metric_tol (the scores' scale) "
          f"{json.dumps(cs.bf16_metric_tol(ref[1], {k: ref[1][k] + plain[k] for k in plain}))}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
