"""Sample entry point: serve a trained generator from a run dir.

Counterpart of `gemm_gan_tpu/cli/sample.py` for the port:

    python -m gemm_gan_tpu_torch.cli.sample --run_dir DIR --cond cond.npz \
        --num_repeats R --out generated.npy [--device cpu] [--seed S]

`DIR` holds the run's `config.json` and `generator_params.npz`
(`convert.save_params_npz` of the generator's Flax params). `cond.npz`
holds the conditioning arrays under the batch-schema keys (`tokens`,
`token_mask`, `patches`, `patch_mask` for the flagship); it is served in
batches of the run's `train.batch_size`, each batch's condition embedding
shared by its `num_repeats` z draws. The output is [R * N, n_genes],
repeat-major. Runs on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch sampler")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--cond", required=True,
                   help=".npz of conditioning arrays under batch-schema keys")
    p.add_argument("--num_repeats", type=int, default=1)
    p.add_argument("--out", default="generated.npy")
    p.add_argument("--device", default=None,
                   help="'cpu' to run the plain PyTorch path; default: CUDA")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

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
    out = server.sample_all(batches, args.num_repeats,
                            torch.Generator().manual_seed(args.seed))
    np.save(args.out, out["fake"])
    print(f"wrote {out['fake'].shape} -> {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
