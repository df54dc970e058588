"""Where one f32 training step on the card leaves the CPU's, update by
update: which gradients, which ReLU inputs and which params part first.

    python3 scripts/torch_f32_step_scatter.py [--seeds 5 63] [--hoist] [--sweep N]

Needs one CUDA card and nvcc (the port's kernels are built at first use).
The step is `chip_smoke.py` phase 5's (the flagship at its published
widths in f32, one dropout-free per_update step of batch 8 from seeded
Flax-layout params, phase 3's first batch) with the draws of each seed
(`chip_smoke.random_draws`; phase 5 takes seed 5); `--hoist`:
`train.hoist_fakes=True`. It runs that step on the CPU (the reference),
then on the card with the kernels, with every kernel's plain PyTorch
version (`chip_smoke.plain_kernels`) and with each launched kernel alone
swapped for its plain version, with every plain version taking its
products as the kernels do (3xTF32, emulated: `products`), and once more
on the CPU from params one float32 ulp off (every entry, up or down at
random): changes of rounding alone. Each run records every optimizer update's
gradients (n_critic critic updates, then the generator's) and, between
two updates, the input of every (leaky) ReLU: each trunk block's Linear
output and each encoder layer's `linear1` output.

For each card run and update it prints the nets' relative gradient
distance from the CPU's, the count of gradient entries whose sign differs
from the CPU's (RMSprop's first move is 10 lr times that sign) and the
params that hold most of them, and the ReLU inputs whose sign differs from
the CPU's: how many, and the first few with the CPU's and the card's value
beside the largest entry of that tensor. At the end, per net, the params
beyond chip_smoke's PARAM_ATOL and, for the param with the most, the rows
and columns that hold them. `--sweep N` then takes the draws of seeds 0
to N-1 and prints, per seed, only the counts beyond PARAM_ATOL of the
kernels, of the plain versions (f32, 3xTF32 and one-pass TF32
products) and of the CPU from params one ulp off, each against the CPU's
step, and how many steps of each pass MAX_LOOSE. A
measuring tool: it exits 0 when it ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOWN_FLIPS = 4


def _host(t):
    """A float32 copy on the host (a copy also of a CPU tensor, which the
    step may change in place)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def recorded_step(cfg, device, g_params, d_params, batch, draws, record=True) -> dict:
    """One step from the Flax-layout params with `draws`, recording on the
    host (with `record`) every optimizer update's net and gradients and the
    ReLU inputs computed since the update before (in call order). Returns
    {"updates": [(net, {name: grad}, [(label, tensor)])], "params":
    {net: {name: tensor}}}."""
    from gemm_gan_tpu_torch.ops.attention import TransformerEncoderLayer
    from gemm_gan_tpu_torch.ops.mlp import LinearBlock
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    engine = WGANGPEngine(cfg, steps_per_epoch=1, device=device)
    state = engine.state_from_flax(g_params, d_params)
    rec = {"updates": [], "acts": []}
    hooks = []
    for net, module in (("G", state.gen), ("D", state.critic)) if record else ():
        for name, mod in module.named_modules():
            target = (mod.linear if isinstance(mod, LinearBlock) else
                      mod.linear1 if isinstance(mod, TransformerEncoderLayer) else None)
            if target is not None:
                label = f"{net} {name}"
                hooks.append(target.register_forward_hook(
                    lambda m, i, o, label=label: rec["acts"].append((label, _host(o)))))
    for net, module, opt in ((("D", state.critic, state.d_opt), ("G", state.gen, state.g_opt))
                             if record else ()):
        names = [n for n, _ in module.named_parameters()]
        update = opt.update

        def recording(gs, net=net, names=names, update=update):
            rec["updates"].append((net, {n: _host(g) for n, g in zip(names, gs)}, rec["acts"]))
            rec["acts"] = []
            return update(gs)
        opt.update = recording
    try:
        engine.step(state, batch, draws=draws)
    finally:
        for h in hooks:
            h.remove()
    params = {net: {n: _host(p) for n, p in module.named_parameters()}
              for net, module in (("G", state.gen), ("D", state.critic))}
    return {"updates": rec["updates"], "params": params}


def compare(label, run, ref, param_atol, zero_suffix) -> dict:
    """Print `run` against the CPU's `ref`, update by update (the params
    whose name ends in `zero_suffix`, of exact gradient 0, counted apart),
    then its params beyond `param_atol`; return the final counts per net."""
    for u, ((net, grads, acts), (_, want, want_acts)) in enumerate(zip(run["updates"],
                                                                       ref["updates"])):
        g = torch.cat([t.flatten() for t in grads.values()]).double()
        w = torch.cat([t.flatten() for t in want.values()]).double()
        dist = float((g - w).norm() / w.norm())
        signs = {n: int(((grads[n] * want[n]) < 0).sum()) for n in want}
        zero = sum(c for n, c in signs.items() if n.endswith(zero_suffix))
        signs = {n: c for n, c in signs.items() if not n.endswith(zero_suffix)}
        top = sorted(((c, n) for n, c in signs.items() if c), reverse=True)[:3]
        flips, shown = {}, []
        assert [a for a, _ in acts] == [a for a, _ in want_acts], "the ReLU calls differ"
        for i, ((name, x), (_, y)) in enumerate(zip(acts, want_acts)):
            differs = (x > 0) != (y > 0)
            n = int(differs.sum())
            if n:
                flips[f"{name} #{i}"] = n
                scale = float(y.abs().max())
                for j in differs.flatten().nonzero()[:SHOWN_FLIPS - len(shown)].flatten():
                    shown.append({"at": f"{name} #{i} entry {int(j)} of {list(y.shape)}",
                                  "cpu": float(y.flatten()[j]), "card": float(x.flatten()[j]),
                                  "max|cpu|": scale})
        print(f"{label}, update {u} ({net}): ||g - g_cpu|| / ||g_cpu|| {dist:.3e}; entries of "
              f"opposite sign {sum(signs.values())}, most in {top} (and {zero} in the params of "
              f"exact gradient 0, *{zero_suffix}); ReLU inputs of opposite "
              f"sign since the last update {sum(flips.values())} {json.dumps(flips)}; first "
              f"{json.dumps(shown)}", flush=True)
    counts = {}
    for net in ("G", "D"):
        beyond = _beyond(run, ref, net, param_atol)
        by_param = sorted(((int(b.sum()), n) for n, b in beyond.items() if b.any()), reverse=True)
        counts[net] = sum(c for c, _ in by_param)
        where = ""
        if by_param and beyond[by_param[0][1]].dim() == 2:
            b = beyond[by_param[0][1]]
            rows = sorted(((int(c), i) for i, c in enumerate(b.sum(1)) if c), reverse=True)[:3]
            cols = sorted(((int(c), i) for i, c in enumerate(b.sum(0)) if c), reverse=True)[:3]
            where = (f"; in {by_param[0][1]} {list(b.shape)}, (count, row) {rows}, "
                     f"(count, column) {cols}")
        print(f"{label}, {net}: params beyond {param_atol} {counts[net]}, most in "
              f"{by_param[:5]}{where}", flush=True)
    return counts


def _beyond(run, ref, net, param_atol) -> dict:
    return {n: (run["params"][net][n] - p).abs() > param_atol
            for n, p in ref["params"][net].items()}


def tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to 10 explicit mantissa bits, to
    nearest, ties away from zero (on the magnitude's bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def products(how: str):
    """Within this context every `a @ b` of float32 tensors takes its
    products as the kernels' tensor cores do ("3xtf32": hi.hi + hi.lo +
    lo.hi of hi = tf32_rna(x), lo = tf32_rna(x - hi), each pass an f32
    matmul of TF32 values, exact per product) or in one TF32 pass
    ("tf32": hi.hi). With cuBLAS's TF32 off."""
    matmul = torch.Tensor.__matmul__

    def emulated(a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            return matmul(a, b)
        a_hi, b_hi = tf32_rna(a), tf32_rna(b)
        out = matmul(a_hi, b_hi)
        if how == "3xtf32":
            out = out + (matmul(a_hi, tf32_rna(b - b_hi)) + matmul(tf32_rna(a - a_hi), b_hi))
        return out

    torch.Tensor.__matmul__ = emulated
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def ulp_off(tree, seed: int) -> dict:
    """The Flax-layout tree with every entry moved one float32 ulp, up or
    down at random."""
    import numpy as np

    from gemm_gan_tpu_torch.convert import flatten_params, unflatten_params

    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flatten_params(tree).items():
        v = np.asarray(v, np.float32)
        out[k] = np.nextafter(v, np.where(rng.rand(*v.shape) < 0.5, np.float32(np.inf),
                                          np.float32(-np.inf)).astype(np.float32))
    return unflatten_params(out)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 63])
    ap.add_argument("--hoist", action="store_true", help="train.hoist_fakes=True")
    ap.add_argument("--sweep", type=int, default=0,
                    help="then the draws of seeds 0..N-1: counts beyond PARAM_ATOL only")
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_f32_step_scatter: no CUDA device is available", file=sys.stderr)
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
    cfg = cs.with_train(cs.train_cfg(exp, dropout=0.0), hoist_fakes=args_.hoist)
    params = cs.flax_param_tree(exp.model, seed=0)
    d_params = cs.flax_param_tree(exp.model, seed=1, critic=True)
    keys = GeneratorServer.from_flax(exp.model, params, device="cpu").keys
    data = structured_dataset(n=cs.BATCH * cs.N_BATCHES, n_genes=exp.model.n_genes)
    batch = {k: data[k][:cs.BATCH] for k in (*keys, "genes")}  # phase 3's batches[0]

    @contextlib.contextmanager
    def plain(names, how=None):
        """Kernels `names` replaced by their plain versions, with their
        products taken `how` (`products`; None: f32)."""
        def version(name):
            run = getattr(fa, name + "_plain")
            if how is None:
                return run

            def emulated(*a, **kw):
                with products(how):
                    return run(*a, **kw)
            return emulated
        saved = {n: getattr(fa, n) for n in names}
        try:
            for n in names:
                setattr(fa, n, version(n))
            yield
        finally:
            for n, k in saved.items():
                setattr(fa, n, k)

    every = [k.__name__ for k in fa.KERNELS]

    out = {}
    for seed in args_.seeds:
        draws = cs.random_draws(cfg, seed=seed)
        args = (params, d_params, batch, draws)
        ref = recorded_step(cfg, "cpu", *args)
        fa.reset_launch_counts()
        kernels = recorded_step(cfg, "cuda", *args)
        launched = [k for k, n in fa.launch_counts().items() if n]
        tag = f"seed {seed}{' hoist' if args_.hoist else ''}"
        out[tag] = {"kernels": compare(f"{tag} kernels", kernels, ref, cs.PARAM_ATOL,
                                           cs.ZERO_GRAD_SUFFIX)}
        del kernels
        runs = {"every kernel plain": (every, None),
                **{f"{name} plain": ([name], None) for name in launched},
                "every kernel plain, 3xTF32 products": (every, "3xtf32")}
        for label, (names, how) in runs.items():
            with plain(names, how):
                run = recorded_step(cfg, "cuda", *args)
            out[tag][label] = compare(f"{tag} {label}", run, ref, cs.PARAM_ATOL,
                                      cs.ZERO_GRAD_SUFFIX)
            del run
        run = recorded_step(cfg, "cpu", ulp_off(params, 2), ulp_off(d_params, 3), batch, draws)
        out[tag]["CPU, params one ulp off"] = compare(f"{tag} CPU, params one ulp off", run,
                                                      ref, cs.PARAM_ATOL, cs.ZERO_GRAD_SUFFIX)
        del run, ref
    print(f"params beyond {cs.PARAM_ATOL} per net: {json.dumps(out)}", flush=True)
    if not args_.sweep:
        return 0
    arms = {"kernels": ("cuda", contextlib.nullcontext, params, d_params),
            "every kernel plain": ("cuda", lambda: plain(every), params, d_params),
            "plain, 3xTF32 products": ("cuda", lambda: plain(every, "3xtf32"), params,
                                       d_params),
            "plain, TF32 products": ("cuda", lambda: plain(every, "tf32"), params, d_params),
            "CPU, params one ulp off": ("cpu", contextlib.nullcontext, ulp_off(params, 2),
                                        ulp_off(d_params, 3))}
    counts = {label: [] for label in arms}
    for seed in range(args_.sweep):
        draws = cs.random_draws(cfg, seed=seed)
        ref = recorded_step(cfg, "cpu", params, d_params, batch, draws, record=False)
        for label, (device, context, p, dp) in arms.items():
            with context():
                run = recorded_step(cfg, device, p, dp, batch, draws, record=False)
            counts[label].append({net: int(sum(int(b.sum()) for b in _beyond(
                run, ref, net, cs.PARAM_ATOL).values())) for net in ("G", "D")})
        print(f"sweep, seed {seed}: params beyond {cs.PARAM_ATOL} "
              f"{json.dumps({k: v[-1] for k, v in counts.items()})}", flush=True)
    over = {k: sum(c["D"] + c["G"] > cs.MAX_LOOSE for c in v) for k, v in counts.items()}
    print(f"sweep over the draws of seeds 0-{args_.sweep - 1}: steps beyond MAX_LOOSE "
          f"({cs.MAX_LOOSE}) params {json.dumps(over)}; the critic's counts "
          f"{json.dumps({k: [c['D'] for c in v] for k, v in counts.items()})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
