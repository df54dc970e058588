"""Post-hoc evaluation over a run's dumped test_* directories.

    python -m gemm_gan_tpu_torch.cli.evaluate --results_path outputs/run \\
        [--epoch auto|all|E] [--train_real npy] [--skip_utility] \\
        [--plots [--plot_genes 500]] [--out report.json] [--device cpu]

Counterpart of `gemm_gan_tpu/cli/evaluate.py`, with its flags and output
JSON, plus `--device`: the utility suites (TRTR / TSTR / TR+TSR on disease
and primary-site labels), then per dump directory Γ, the exact 1- / 2-
Wasserstein and the linear / polynomial MMD of test_gen against test_real,
DCR / NNDR of data_gen against the directory's data_real (or
`--train_real`) and test_real, and with `--plots` the figures. Works on any
directory `Experiment` or `VAEExperiment` wrote. Runs on the CUDA card
unless `--device cpu`.

`--epoch auto` (the default) scores only the dumps of `best.json`'s epoch
when the run directory has one, else every test_* directory. The utility
suites need label dumps (conditional variants): pass `--skip_utility` for
unconditional runs. `--plots` without matplotlib raises before any work.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob


def build_parser():
    p = argparse.ArgumentParser(description="gemm_gan_tpu_torch post-hoc evaluator")
    p.add_argument("--results_path", required=True)
    p.add_argument("--train_real",
                   help="npy of train-real expressions replacing each run dir's "
                        "data_real.npy as the privacy (dcr/nndr) real reference")
    p.add_argument("--skip_utility", action="store_true")
    p.add_argument("--epoch", default="auto",
                   help="score only test_*_epoch_<E> dirs. Default 'auto': the epoch of the "
                        "run dir's best.json (gate-best tracking) when there is one, else "
                        "every test_* dir. An integer picks an epoch, 'all' every dump dir")
    p.add_argument("--plots", action="store_true",
                   help="write the post-hoc figures per test_* dir (<dir>/figures/): "
                        "real-vs-gen embedding panels, top-variance gene distributions, "
                        "gene-gene correlation-distance matrices (needs matplotlib)")
    p.add_argument("--plot_genes", type=int, default=500,
                   help="cap on genes entering the [G, G] correlation-distance figure "
                        "(top variance; a full TCGA profile would be 18,868^2)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' to run the plain PyTorch path; default: CUDA")
    return p


def resolve_epoch(results_path: str, epoch: str):
    """`--epoch` as an int, or None for every dump dir ('all', or 'auto'
    without a best.json)."""
    if epoch == "all":
        return None
    if epoch != "auto":
        return int(epoch)
    best_path = os.path.join(results_path, "best.json")
    if not os.path.exists(best_path):
        return None
    with open(best_path) as f:
        best = json.load(f)["epoch"]
    print(f"evaluate: best.json found, scoring epoch {best} dumps "
          "(pass --epoch all for every dump dir)")
    return best


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from gemm_gan_tpu_torch.eval.distances import compute_distribution_distances
    from gemm_gan_tpu_torch.eval.gamma import gamma_coef
    from gemm_gan_tpu_torch.eval.privacy import dcr, nndr
    from gemm_gan_tpu_torch.eval.utility import UtilityEvaluator, UtilityEvaluatorPrimary
    from gemm_gan_tpu_torch.utils.device import resolve_device
    from gemm_gan_tpu_torch.viz import matplotlib_available

    if args.plots and not matplotlib_available():
        raise ImportError("--plots needs matplotlib, which is not installed")
    device = resolve_device(args.device)
    epoch = resolve_epoch(args.results_path, args.epoch)
    pattern = "test_*" if epoch is None else f"test_*_epoch_{epoch}"
    out = {}
    if not args.skip_utility:
        ev = UtilityEvaluator(args.results_path, pattern=pattern, device=device)
        if ev.results_dirs:
            ev.evaluate()
            out["utility_disease"] = ev.report()
        evp = UtilityEvaluatorPrimary(args.results_path, pattern=pattern, device=device)
        try:
            if evp.results_dirs:
                evp.evaluate()
                out["utility_primary_site"] = evp.report()
        except FileNotFoundError:
            pass  # dumps without primary-site labels

    per_run = []
    for d in sorted(glob(os.path.join(args.results_path, pattern))):
        test_real = np.load(os.path.join(d, "test_real.npy"))
        test_gen = np.load(os.path.join(d, "test_gen.npy"))
        rec = {"dir": os.path.basename(d),
               "gamma": float(gamma_coef(test_real, test_gen, device=device))}
        rec.update(compute_distribution_distances(test_gen, test_real, device=device))
        # the real reference defaults to the dir's own data_real dump;
        # --train_real replaces it. A dir missing either array skips privacy
        gen_path = os.path.join(d, "data_gen.npy")
        real_path = args.train_real or os.path.join(d, "data_real.npy")
        if os.path.exists(gen_path) and os.path.exists(real_path):
            gen = np.load(gen_path)
            train_real = np.load(real_path)
            rec["dcr"] = dcr(train_real, gen, test_real, device=device)
            rec["nndr"] = nndr(train_real, gen, test_real, device=device)
        if args.plots:
            rec["figures"] = _plots(d, test_real, test_gen, args.plot_genes)
        per_run.append(rec)
    out["per_run"] = per_run

    text = json.dumps(out, indent=2, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return out


def _plots(d: str, test_real, test_gen, plot_genes: int) -> str:
    """The post-hoc figure set of one dump dir, in `<d>/figures/`."""
    import numpy as np

    from gemm_gan_tpu_torch.viz import (plot_distance_matrices, plot_embedding_panels,
                                        plot_gene_distributions)

    fig_dir = os.path.join(d, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    labels_path = os.path.join(d, "test_labels_real.npy")
    labels = np.load(labels_path) if os.path.exists(labels_path) else None
    plot_embedding_panels(test_real, test_gen, labels=labels,
                          out_path=os.path.join(fig_dir, "embedding_panels.png"))
    var_order = np.argsort(test_real.var(axis=0))[::-1]
    plot_gene_distributions(test_real, test_gen, gene_idx=var_order[:6].tolist(),
                            out_path=os.path.join(fig_dir, "gene_distributions.png"))
    top = np.sort(var_order[:plot_genes])
    plot_distance_matrices(test_real[:, top], test_gen[:, top],
                           out_path=os.path.join(fig_dir, "corr_distance_matrices.png"))
    return fig_dir


if __name__ == "__main__":
    main()
