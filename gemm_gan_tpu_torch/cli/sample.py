"""Sample entry point: restore a checkpoint and generate expression profiles.

Counterpart of `gemm_gan_tpu/cli/sample.py`, with its interface:

    python -m gemm_gan_tpu_torch.cli.sample --data_dir DIR --ckpt_dir RUN/ckpt \
        [--which last|best] [--num_repeats R] [--balanced] [--scan] \
        [--host_dtype float16|float32] [--out generated.npy] [--seed S] [--device cpu]

`--ckpt_dir` is a checkpoint dir written by `cli.train`; the run dir's
`config.json` beside it gives the model and data shapes, and the TCGA layout
under `--data_dir` is loaded with them (`load_tcga`). Without a config.json,
`--variant`'s canonical config is sized from the data. Profiles come from
the train split's loader (`--balanced`: oversampled to balance the disease
classes, `Experiment.generate_balanced`), `--num_repeats` z draws per case,
repeat-major. `--scan` replays one CUDA graph per batch shape (the same
profiles, bit for bit); `--host_dtype float16` casts them on the card before
the copy to the host. Runs on the CUDA card unless `--device cpu` is given.

The first port's form, `--run_dir DIR --cond cond.npz`, serves a JAX run
dir (`config.json` and `generator_params.npz`, see `serving.GeneratorServer.
load`) over conditioning arrays in batches of the run's batch size.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch sampler")
    p.add_argument("--variant", default="vanilla")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--which", default="last", choices=["last", "best"],
                   help="'best' restores the gate-best validation checkpoint "
                        "(sibling ckpt_best/ + best.json of the run dir) instead "
                        "of the newest step, as cli.train --evaluate_which")
    p.add_argument("--out", default="generated.npy")
    p.add_argument("--num_repeats", type=int, default=1)
    p.add_argument("--balanced", action="store_true")
    p.add_argument("--scan", action="store_true",
                   help="replay one CUDA graph per batch shape (embedding once, "
                        "then every repeat's score); the same profiles bit for bit")
    p.add_argument("--host_dtype", default=None, choices=["float16", "float32"],
                   help="cast profiles on the card before the copy to the host "
                        "(float16: half the bytes and half the .npy)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="'cpu' to run the plain PyTorch path; default: CUDA")
    p.add_argument("--run_dir", default=None,
                   help="a JAX run dir (config.json, generator_params.npz), "
                        "served over --cond")
    p.add_argument("--cond", default=None,
                   help="with --run_dir: .npz of conditioning arrays under "
                        "batch-schema keys")
    return p


def _load_experiment(args):
    """The run's Experiment over the TCGA layout under --data_dir."""
    from gemm_gan_tpu_torch.cli.experiment import Experiment
    from gemm_gan_tpu_torch.config import load_config, variant_config
    from gemm_gan_tpu_torch.data.tcga import load_tcga

    # checkpoint dirs written by cli.train are self-describing: the run dir
    # holds config.json with the resolved model and data shapes
    cfg_path = os.path.join(os.path.dirname(os.path.normpath(args.ckpt_dir)), "config.json")
    if os.path.exists(cfg_path):
        cfg = load_config(cfg_path)
        splits = load_tcga(args.data_dir, schema=cfg.data.batch_schema,
                           num_patches=cfg.data.num_patches,
                           normalization=cfg.data.normalization, seed=cfg.train.seed)
    else:
        schema = {"vanilla": "genes", "vae": "genes", "benchmark": "labels",
                  "cvae": "labels", "cross_attention": "multi_token",
                  "film_cross_attention": "multi_token"}.get(args.variant, "multi_patch")
        splits = load_tcga(args.data_dir, schema=schema, seed=args.seed)
        meta = splits["meta"]
        fusion_kw = {}
        if meta["disease_vocab"]:
            fusion_kw = dict(n_disease_types=len(meta["disease_vocab"]),
                             n_primary_sites=len(meta["site_vocab"]))
        cfg = variant_config(args.variant, n_genes=meta["n_genes"], fusion_kw=fusion_kw)
    if args.scan:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, scan_sampling=True))
    return Experiment(cfg, splits, device=args.device)


def _sample_run_dir(args):
    """The first port's form: a JAX run dir served over --cond."""
    import numpy as np
    import torch

    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.serving import CONFIG_FILE, GeneratorServer

    server = GeneratorServer.load(args.run_dir, device=args.device)
    batch_size = load_config(os.path.join(args.run_dir, CONFIG_FILE)).train.batch_size
    with np.load(args.cond) as data:
        cond = {k: data[k] for k in server.keys}
    n = next(iter(cond.values())).shape[0]
    batches = [{k: a[s:s + batch_size] for k, a in cond.items()}
               for s in range(0, n, batch_size)]
    return server.sample_all(batches, args.num_repeats,
                             torch.Generator().manual_seed(args.seed))


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if args.run_dir is not None:
        if args.cond is None:
            parser.error("--run_dir needs --cond")
        out = _sample_run_dir(args)
    else:
        if args.data_dir is None or args.ckpt_dir is None:
            parser.error("--data_dir and --ckpt_dir are required (or --run_dir and --cond)")
        from gemm_gan_tpu_torch.train.checkpoint import resolve_ckpt_dir, restore_state

        exp = _load_experiment(args)
        template = exp.engine.init_state(args.seed, next(iter(exp.loaders["train"].epoch(0))))
        ckpt_dir, step = resolve_ckpt_dir(args.ckpt_dir, args.which)
        state = restore_state(ckpt_dir, template, step=step)
        generator = torch.Generator(device=exp.device).manual_seed(args.seed)
        host_dtype = np.float16 if args.host_dtype == "float16" else None
        if args.balanced:
            out = exp.generate_balanced(state, generator, num_repeats=args.num_repeats,
                                        host_dtype=host_dtype)
        else:
            train = exp.loaders["train"]
            out = exp.engine.generate_samples_all(
                state, lambda: train.epoch(0), args.num_repeats, generator,
                scan=args.scan, host_dtype=host_dtype)
    np.save(args.out, out["fake"])
    print(f"wrote {out['fake'].shape} -> {os.path.abspath(args.out)}")
    return out


if __name__ == "__main__":
    main()
