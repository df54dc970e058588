"""Train entry point of the port: the experiment protocol on one card or a mesh.

    python -m gemm_gan_tpu_torch.cli.train --variant film_cross_attention \\
        --data_dir DIR [--output_path outputs] [--run_name run] [--resume]
    python -m gemm_gan_tpu_torch.cli.train ... --evaluate_only \\
        --evaluate_which best

Counterpart of `gemm_gan_tpu/cli/train.py`, with its flags and two more
(`--on_device_validation`, `--n_runs`, which the JAX package sets through
its config, as `scripts/quality_experiment.py` does): load the
TCGA layout under `--data_dir` (`data.tcga.load_tcga`), size the variant's
fusion from the data, then `Experiment.fit` (training, periodic validation,
checkpoints, the test block) and the post-hoc utility and privacy suites,
or `--evaluate_only` (restore the last or the gate-best checkpoint and
rerun the test block). `--variant vae` and `cvae` take the same path
through `cli/vae_experiment.py`'s `VAEExperiment` (validation by β-ELBO);
the VAE's own settings (`vae_*`) keep the variant's preset. Writes
`config.json` and `results.json` into `<output_path>/<run_name>/`. Runs on
the CUDA card unless `--device cpu`.

Several ranks, one per card (NCCL), under torchrun:

    torchrun --nproc_per_node=N -m gemm_gan_tpu_torch.cli.train \
        --variant film_cross_attention --data_dir DIR --mesh_data D \
        --mesh_model M [--shard_bank]

(or gloo ranks on the CPU with `--device cpu`). `distributed_init()` reads
torchrun's variables; a mesh of (`--mesh_data`, `--mesh_model`) is built
when there is more than one rank or `--mesh_model` > 1, and `Experiment`
runs on it (rank 0 writes the run dir). As in the JAX package,
`--shard_bank` without a mesh raises `ValueError`, and so does
`--shard_bank` with `vae` / `cvae`; the VAE family is single-process
(`VAEExperiment`) and raises on more than one rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

VAE_VARIANTS = ("vae", "cvae")


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch trainer")
    p.add_argument("--variant", default="vanilla")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_path", default="outputs")
    p.add_argument("--run_name", default="run")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--latent_dim", type=int, default=256)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--optimizer", default="rmsprop", choices=["rmsprop", "adam", "adamw"])
    p.add_argument("--n_critic", type=int, default=5)
    p.add_argument("--gp_weight", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_patches", type=int, default=256)
    p.add_argument("--freq_compute_test", type=int, default=50)
    p.add_argument("--normalization", default="standardize",
                   choices=["standardize", "minmax", "none"])
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--bank_dtype", default=None, choices=(None, "bfloat16"),
                   help="store the device bank's patch/token embeddings at this dtype "
                        "(batches are widened to float32 after the gather)")
    p.add_argument("--validation_max_cases", type=int, default=None,
                   help="cap the train-side regeneration during periodic validation "
                        "(default: the whole split)")
    p.add_argument("--on_device_validation", action="store_true",
                   help="validate with the on-device kNN-detection + PRDC proxy (only "
                        "scalars and neighbour indices leave the card) instead of the host "
                        "suites; the final test block runs the host suites either way")
    p.add_argument("--n_runs", type=int, default=None,
                   help="test-block repetitions (default: the variant's preset)")
    p.add_argument("--shard_bank", action="store_true",
                   help="shard the training bank's cases over the mesh's data axis "
                        "(a ShardedDeviceCache; needs a mesh)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--cond_embed_reuse", default="per_call",
                   choices=["per_call", "per_update"],
                   help="per_update: reuse the condition embedding within each update")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of generator params for sampling (0 = off)")
    p.add_argument("--drift_epsilon", type=float, default=0.0,
                   help="eps-drift critic score anchor for long-horizon runs")
    p.add_argument("--critic_scan", action="store_true",
                   help="accepted for the JAX package's command lines; the port's critic "
                        "updates are one loop either way")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each update into this many microbatches and accumulate "
                        "gradients; batch_size must divide")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steady-state epochs (the window "
                        "opens after the first epoch; needs epochs >= 2) and print "
                        "time tables from it, then the tracer's table (the step's stages, "
                        "the replays' idle share, idle by host span)")
    p.add_argument("--profile_epochs", type=int, default=1,
                   help="how many epochs the --profile_dir trace covers")
    p.add_argument("--evaluate_only", action="store_true")
    p.add_argument("--evaluate_which", default="last", choices=("last", "best"),
                   help="which checkpoint --evaluate_only restores: 'last' or 'best' "
                        "(the gate-best validation checkpoint tracked during fit)")
    p.add_argument("--checkpoint_every_eval", action="store_true",
                   help="save a full train-state checkpoint at every validation epoch "
                        "(always on for film_cross_attention); what --resume continues from")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the newest full train-state "
                        "checkpoint in the run dir (fresh start if none exists)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run the plain PyTorch path; default: CUDA")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from gemm_gan_tpu_torch.cli.experiment import Experiment
    from gemm_gan_tpu_torch.cli.vae_experiment import VAEExperiment
    from gemm_gan_tpu_torch.config import save_config, variant_config
    from gemm_gan_tpu_torch.data.tcga import load_tcga
    from gemm_gan_tpu_torch.parallel.mesh import distributed_init, make_mesh

    if args.shard_bank and args.variant in VAE_VARIANTS:
        raise ValueError("--shard_bank is not supported for the VAE variants (they "
                         "train through VAEExperiment's stacked scan)")
    distributed_init(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if world > 1 or args.mesh_model > 1:
        mesh = make_mesh(args.mesh_data, args.mesh_model, device=args.device)
    if args.shard_bank and mesh is None:
        raise ValueError(
            "--shard_bank shards the bank over a mesh data axis and needs more than one "
            "rank; on a single device use the replicated DeviceCache (default) with "
            "--num_patches / bf16 bank storage")

    schema = {"vanilla": "genes", "vae": "genes", "benchmark": "labels", "cvae": "labels",
              "cross_attention": "multi_token",
              "film_cross_attention": "multi_token"}.get(args.variant, "multi_patch")
    # the full padded patch bank when a device cache draws a fresh subset per
    # step (one device, or a sharded bank); a mesh's host batches carry a
    # one-time host subsample, as the JAX package's
    use_device_cache = mesh is None or args.shard_bank
    splits = load_tcga(args.data_dir, schema=schema, num_patches=args.num_patches,
                       normalization=args.normalization, seed=args.seed,
                       patch_bank=use_device_cache and schema in ("multi_patch", "multi_token"))
    meta = splits["meta"]

    fusion_kw = {}
    if meta["disease_vocab"]:
        fusion_kw = dict(n_disease_types=len(meta["disease_vocab"]),
                         n_primary_sites=len(meta["site_vocab"]))
    # size the fusion stack from the loaded data, not the canonical defaults
    for src, dst in (("patch_dim", "patch_dim"), ("text_dim", "text_dim"),
                     ("num_tokens", "max_tokens")):
        if src in meta:
            fusion_kw[dst] = meta[src]
    cfg = variant_config(args.variant, n_genes=meta["n_genes"], fusion_kw=fusion_kw)
    cfg = dataclasses.replace(
        cfg,
        run_name=args.run_name,
        output_dir=args.output_path,
        model=dataclasses.replace(
            cfg.model, latent_dim=args.latent_dim,
            gen_dims=(args.hidden_dim, args.hidden_dim),
            disc_dims=(args.hidden_dim, args.hidden_dim),
            compute_dtype=args.compute_dtype),
        train=dataclasses.replace(
            cfg.train, batch_size=args.batch_size, epochs=args.epochs,
            n_critic=args.n_critic, gp_weight=args.gp_weight,
            optimizer=args.optimizer, lr_gen=args.lr, lr_disc=args.lr,
            seed=args.seed, freq_compute_test=args.freq_compute_test,
            cond_embed_reuse=args.cond_embed_reuse,
            checkpoint_every_eval=(args.checkpoint_every_eval
                                   or cfg.train.checkpoint_every_eval),
            ema_decay=args.ema_decay, drift_epsilon=args.drift_epsilon,
            critic_scan=args.critic_scan, grad_accum=args.grad_accum),
        data=dataclasses.replace(
            cfg.data, data_dir=args.data_dir, num_patches=args.num_patches,
            normalization=args.normalization, seed=args.seed,
            embedding_store_dtype=args.bank_dtype, shard_bank=args.shard_bank),
        eval=dataclasses.replace(
            cfg.eval, validation_max_cases=args.validation_max_cases,
            on_device_validation=args.on_device_validation,
            n_runs=cfg.eval.n_runs if args.n_runs is None else args.n_runs),
    )
    if args.variant in VAE_VARIANTS:
        exp = VAEExperiment(cfg, splits, device=args.device)
    else:
        exp = Experiment(cfg, splits, mesh=mesh, device=None if mesh else args.device)
    main_rank = mesh is None or mesh.rank == 0  # rank 0 writes the run dir
    # the resolved config first, so an interrupted run dir describes itself
    if main_rank:
        save_config(cfg, os.path.join(exp.out_dir, "config.json"))

    if args.evaluate_only:
        results = exp.evaluate(which=args.evaluate_which)
    else:
        fit_kw = {}
        if args.profile_dir:
            fit_kw = dict(profile_dir=args.profile_dir, profile_epochs=args.profile_epochs)
        results = exp.fit(resume=args.resume, **fit_kw)
        if fit_kw:
            from gemm_gan_tpu_torch.utils.metrics import (aggregate_device_trace,
                                                          format_device_table,
                                                          format_tracer_table)

            if exp.profile_captured:
                agg = aggregate_device_trace(args.profile_dir)
                for title, k in (("by category", "by_category"), ("by name", "by_op")):
                    print(format_device_table(agg[k], f"{title} (total ms)"))
            else:
                print(f"no steady-state trace captured under {args.profile_dir} (the "
                      "window opens after the first epoch: the run needs >= 2 epochs)")
            if getattr(exp, "trace_summary", None) is not None:  # the GAN's Experiment
                print(format_tracer_table(exp.trace_summary))
        if not main_rank:
            return {}
        # TSTR utility needs label dumps: conditional variants only
        if "disease" in splits["train"]:
            results["utility"] = exp.posthoc_utility()
        results["privacy"] = exp.posthoc_privacy()

    if not main_rank:
        return {}
    out_file = os.path.join(exp.out_dir, "results.json")
    with open(out_file, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps({"gamma_mean": results.get("gamma_mean"), "output": out_file}))
    return results


if __name__ == "__main__":
    main()
