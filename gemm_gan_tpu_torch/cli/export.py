"""Export entry point: checkpoint -> serving artifact.

Counterpart of `gemm_gan_tpu/cli/export.py`: turns a run dir written by
`cli.train` (a checkpoint beside its `config.json`) into a `torch.export`
artifact (`gemm_gan_tpu_torch.serving`): the deterministic generator
forward (or, for `vae` / `cvae`, the decoder) with the trained weights
inside, loadable with `GeneratorArtifact.load` and no model code.

    python -m gemm_gan_tpu_torch.cli.export --ckpt_dir RUN/ckpt --out ART \
        [--which last|best] [--batch dynamic|N] [--use_ema] \
        [--use_pallas auto|on|off] [--seed S] [--device cpu]

Two differences from the JAX command:

* `--platforms` becomes `--device` (the CUDA card by default): the
  program's weights live on the device it was exported on, and it runs
  there.
* `--use_pallas auto` keeps the run config's `fusion.use_pallas`. JAX's
  `auto` means off because Mosaic kernels lower only for the TPU and their
  grids are shape-specialized; the port's attention op (`gemm_gan_tpu_torch::
  masked_mha`) runs on the card or the CPU and chooses its kernel from the
  real shapes at each call, so it combines with a dynamic batch and dynamic
  sequence lengths.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch serving exporter")
    p.add_argument("--ckpt_dir", required=True,
                   help="checkpoint dir written by cli.train (the run dir's "
                        "config.json supplies the model shapes)")
    p.add_argument("--which", default="last", choices=["last", "best"],
                   help="'best' exports the gate-best validation checkpoint "
                        "(sibling ckpt_best/ + best.json of the run dir) instead "
                        "of the newest step, as cli.train --evaluate_which")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--batch", default="dynamic",
                   help="'dynamic' (default: any batch size at call time) or a "
                        "fixed integer batch")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA generator (train.ema_decay>0 runs only)")
    p.add_argument("--use_pallas", choices=["auto", "on", "off"], default="auto",
                   help="attention through the CUDA kernels (the op "
                        "gemm_gan_tpu_torch::masked_mha) or the plain reference "
                        "in ATen ops; auto keeps the run config's fusion.use_pallas")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="'cpu' to export a CPU program; default: CUDA")
    return p


def _example_batch(cfg):
    """A one-row batch with the run's conditioning shapes: the exporter
    reads only shapes and dtypes."""
    import numpy as np

    m, d, f = cfg.model, cfg.data, cfg.model.fusion
    return {"genes": np.zeros((1, m.n_genes), np.float32),
            "text_emb": np.zeros((1, f.text_dim), np.float32),
            "tokens": np.zeros((1, f.max_tokens, f.text_dim), np.float32),
            "token_mask": np.ones((1, f.max_tokens), bool),
            "patches": np.zeros((1, d.num_patches, f.patch_dim), np.float32),
            "patch_mask": np.ones((1, d.num_patches), bool),
            "disease": np.zeros((1,), np.int32),
            "site": np.zeros((1,), np.int32)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    batch_size = None if args.batch == "dynamic" else int(args.batch)

    from gemm_gan_tpu_torch.config import load_config
    from gemm_gan_tpu_torch.serving import export_generator, export_vae_decoder
    from gemm_gan_tpu_torch.train.checkpoint import resolve_ckpt_dir, restore_state

    cfg_path = os.path.join(os.path.dirname(os.path.normpath(args.ckpt_dir)), "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"no config.json next to {args.ckpt_dir}: export needs the "
                         "self-describing run dir cli.train writes")
    cfg = load_config(cfg_path)
    ckpt_dir, ckpt_step = resolve_ckpt_dir(args.ckpt_dir, args.which)
    if args.use_pallas != "auto":
        # use_pallas switches the attention computation, not the params, so
        # the checkpoint restores the same either way
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fusion=dataclasses.replace(cfg.model.fusion,
                                                  use_pallas=args.use_pallas == "on")))

    batch = _example_batch(cfg)
    if cfg.variant in ("vae", "cvae"):
        from gemm_gan_tpu_torch.train.vae import VAEEngine

        engine = VAEEngine(cfg, device=args.device)
        state = restore_state(ckpt_dir, engine.init_state(args.seed, batch), step=ckpt_step)
        artifact = export_vae_decoder(engine, state, batch, batch_size=batch_size)
    else:
        from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

        engine = WGANGPEngine(cfg, device=args.device)
        state = restore_state(ckpt_dir, engine.init_state(args.seed, batch), step=ckpt_step)
        artifact = export_generator(engine, state, batch, batch_size=batch_size,
                                    use_ema=args.use_ema or None)
    artifact.save(args.out)
    spec = {s["key"]: s["shape"] for s in artifact.manifest["cond_spec"]}
    print(f"exported {cfg.variant} (batch={artifact.manifest['batch']}, "
          f"device={engine.device}, use_pallas={cfg.model.fusion.use_pallas}, "
          f"cond={spec or 'none'}) -> {os.path.abspath(args.out)}")
    return artifact


if __name__ == "__main__":
    main()
