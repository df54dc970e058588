"""How far one bf16 training step moves on the card under changes of
rounding alone, against the same step on the CPU: its first gradients
(phase 9 (b)'s gradient gate) and its metrics after the step.

    python3 scripts/torch_bf16_step_scatter.py [--mxu]

Needs one CUDA card and nvcc (the port's kernels are built at first use,
and Q1's mma.sync tile as `scripts/torch_kernel_variants.py`'s variant
`fwd_ble_{bf16,mxu}_mma_sync`). The step is `chip_smoke.py` phase 9 (b)'s
(the flagship at its published widths in the bench configuration,
`compute_dtype="bfloat16"`, one dropout-free per_update step of batch 8
from seeded Flax-layout params, the same draws; `--mxu`: phase 9 (d)'s,
`fusion.flash_mxu_bf16=True`). It runs that step on the CPU (the
reference), then on the card:

* with the kernels (Q1's bf16-ref mode on its wgmma tile);
* with Q1 on its mma.sync tile (the variant's library, the other kernels
  as shipped);
* with every kernel's plain PyTorch version (`chip_smoke.plain_kernels`,
  the gates' yardstick);
* with `fusion.use_pallas=False`;
* with the kernels but one of the step's kernels swapped for its plain
  version, for each kernel the step launches;
* with each of the gradient gate's negative controls on either Q1 tile
  (gradients only).

For each it prints the gradient gate's distances (per net ||g - g_cpu|| /
||g_cpu|| of the fusion's params' gradients with the step's cotangents,
`chip_smoke.fusion_grads`; the gate holds each param's, `largest_ratio`),
the same distances of the whole nets' first gradients
(`net_grads`, which the gate leaves out: the trunks' ReLU
patterns flip with rounding), and whether the gate's limits (from the
plain versions' distances) take them; then the step's metrics minus the
CPU step's, and the count of params beyond chip_smoke's PARAM_ATOL. The last line gives, per metric, the
spread (largest minus smallest) over the card runs, beside
`bf16_metric_tol`. A measuring tool: it exits non-zero only if the gate
rejects a tile or accepts a control.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def net_grads(cfg, device, g_params, d_params, batch, draws) -> dict:
    """The whole nets' first gradients of the step at its starting params
    and with its draws ({net: {param name: gradient}}, float64 on the
    host): the first critic update's loss (Wasserstein loss + gp_weight x
    gp) w.r.t. the critic's params ("D"), the generator loss w.r.t. the
    generator's ("G"), from the engine's own `critic_update` and
    `generator_update`; the optimizers' `update` records instead of
    moving. Dropout is `cfg`'s (0 here)."""
    import numpy as np
    import torch

    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device=device)
    state = engine.state_from_flax(g_params, d_params)
    real, cond = engine._tensors(batch)
    d = {k: torch.as_tensor(np.asarray(draws[k]), device=engine.device)
         for k in ("z", "alpha", "z_gen")}
    grads = {}
    for net, module, opt in (("D", state.critic, state.d_opt), ("G", state.gen, state.g_opt)):
        names = [n for n, _ in module.named_parameters()]
        opt.update = lambda gs, net=net, names=names: grads.__setitem__(
            net, {n: g.detach().double().cpu() for n, g in zip(names, gs)})
    state.gen.train()
    state.critic.train()
    engine.critic_update(state, real, cond, engine.embed_generator(state, cond), d["z"][0],
                         d["alpha"][0])
    engine.generator_update(state, cond, d["z_gen"])
    return grads


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mxu", action="store_true", help="the mxu_bf16 step (phase 9 (d))")
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_step_scatter: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.kernels import build
    from gemm_gan_tpu_torch.kernels import flash_attention as fa
    from gemm_gan_tpu_torch.serving import GeneratorServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    exp = variant_config("film_cross_attention")
    cfg = dataclasses.replace(exp.model, compute_dtype="bfloat16")
    if args_.mxu:
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
    args = (params, d_params, batch, draws)
    mode = "mxu" if args_.mxu else "bf16"
    fwd = f"flash_fwd_ble_{mode}"

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants", os.path.join(HERE, "scripts", "torch_kernel_variants.py"))
    tkv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tkv)
    variant = f"fwd_ble_{mode}_mma_sync"
    mma_sync = tkv.build([variant], {"new": tkv.CSRC}, cs.ptxas_entry, cs.ptxas_records)[variant][0]
    launch = build.launch

    @contextlib.contextmanager
    def q1_mma_sync():
        """Q1's launches go to the mma.sync tile's library."""
        def routed(name, *a):
            if name != fwd:
                return launch(name, *a)
            err = mma_sync(*a)
            if err:
                raise RuntimeError(f"{variant} failed to launch: error {err}")
        build.launch = routed
        try:
            yield
        finally:
            build.launch = launch

    @contextlib.contextmanager
    def plain(names):
        saved = {n: getattr(fa, n) for n in names}
        try:
            for n in names:
                setattr(fa, n, getattr(fa, n + "_plain"))
            yield
        finally:
            for n, k in saved.items():
                setattr(fa, n, k)

    fa.reset_launch_counts()
    cs.run_step(cfg_of(), "cuda", *args)
    launched = [k for k, n in fa.launch_counts().items() if n]
    runs = {"kernels (Q1 wgmma)": (cfg_of(), contextlib.nullcontext),
            "Q1 mma.sync": (cfg_of(), q1_mma_sync),
            "every kernel plain": (cfg_of(), lambda: plain([k.__name__ for k in fa.KERNELS])),
            "use_pallas=False": (cfg_of(use_pallas=False), contextlib.nullcontext)}
    for name in launched:
        runs[f"{name} plain"] = (cfg_of(), lambda name=name: plain([name]))

    cot = cs.fusion_cotangents(cfg_of(), *args)

    def gate_grads(cfg, device):
        return cs.fusion_grads(cfg, device, params, d_params, batch, cot)

    cpu_grads, cpu_net = gate_grads(cfg_of(), "cpu"), net_grads(cfg_of(), "cpu", *args)
    ref = cs.run_step(cfg_of(), "cpu", *args)
    print(f"CPU step metrics: {json.dumps(ref[1])}", flush=True)
    dist, moved, grads = {}, {}, {}
    for label, (cfg, context) in runs.items():
        with context():
            grads[label] = gate_grads(cfg, "cuda")
            dist[label] = cs.grad_distances(grads[label], cpu_grads)
            whole = cs.grad_distances(net_grads(cfg, "cuda", *args), cpu_net)
            got = cs.run_step(cfg, "cuda", *args)
        summary = cs.step_diff(got, ref, {}, rtol=None)
        moved[label] = {k: got[1][k] - ref[1][k] for k in ref[1]}
        print(f"{mode} step, {label}: the gate's distances {json.dumps(dist[label])}; the whole "
              f"nets' first gradients' {json.dumps(whole)}; metrics minus CPU "
              f"{json.dumps(moved[label])}; params beyond atol {cs.PARAM_ATOL}: "
              f"{summary['beyond_atol_by_net']}", flush=True)
    yardstick = grads["every kernel plain"]
    failed = []
    for label in ("kernels (Q1 wgmma)", "Q1 mma.sync"):
        ratio = cs.largest_ratio(grads[label], cpu_grads, yardstick)
        print(f"{mode} gradient gate, {label}: {'passes' if ratio[0] <= 1 else 'REJECTED'} "
              f"(the largest ratio of a param's distance to its limit {ratio})", flush=True)
        failed += [] if ratio[0] <= 1 else [label]
        for how in ("scaled", "last_key_masked"):
            with runs[label][1](), cs.perturbed_forward(fa, fwd, how):
                g = gate_grads(cfg_of(), "cuda")
                whole = cs.grad_distances(net_grads(cfg_of(), "cuda", *args), cpu_net)
            ratio = cs.largest_ratio(g, cpu_grads, yardstick)
            print(f"{mode} gradient gate, {label} with Q1 {how}: "
                  f"{json.dumps(cs.grad_distances(g, cpu_grads))}, the largest ratio {ratio}: "
                  f"{'rejected' if ratio[0] > 1 else 'ACCEPTED'}; the whole nets' first "
                  f"gradients' distances {json.dumps(whole)}", flush=True)
            failed += [] if ratio[0] > 1 else [f"{label} {how}"]
    tol = cs.bf16_metric_tol(ref[1], {k: ref[1][k] + v for k, v in
                                      moved["every kernel plain"].items()})
    spread = {k: max(m[k] for m in moved.values()) - min(m[k] for m in moved.values())
              for k in ref[1]}
    print(f"{mode} step: spread of each metric over the {len(moved)} card runs "
          f"{json.dumps(spread)}; bf16_metric_tol with the plain versions as the yardstick "
          f"{json.dumps(tol)}; the gate's misses: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
