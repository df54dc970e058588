"""The port's post-hoc evaluator against the JAX package's, on the CPU:
`cli.evaluate`, cross-modal retrieval and `PrivacyEvaluator`
(`eval/privacy.py`), the TF-TG helpers (`eval/gamma.py`), `umap_lite` and
the figures of `viz.py`.

Tolerances: retrieval indices equal and scores within 1e-5; the privacy
shares equal (counts) and their means within 1e-5; TF-TG and
`umap_embed` bit for bit (numpy copies), `tsne_2d` bit for bit with
`utils.tsne` at JAX's clamped perplexity; both `cli.evaluate.main`s on one
dump directory with the same keys, Γ within 1e-5, the exact Wasserstein
distances within 1e-12 relative, the MMDs within 1e-5 relative, DCR / NNDR
equal, the utility reports' keys equal. The figures are written where
matplotlib is installed; without it they raise, naming it.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import json
import os

import numpy as np
import pytest
import torch

from gemm_gan_tpu import viz as jviz
from gemm_gan_tpu.cli.evaluate import main as jax_evaluate
from gemm_gan_tpu.eval import gamma as jgamma
from gemm_gan_tpu.eval import privacy as jpriv
from gemm_gan_tpu.eval.utility import save_run_artifacts as jax_save_run_artifacts
from gemm_gan_tpu.utils.umap_lite import umap_embed as jax_umap_embed
from gemm_gan_tpu_torch import viz
from gemm_gan_tpu_torch.cli import evaluate as cli_evaluate
from gemm_gan_tpu_torch.eval import gamma as tgamma
from gemm_gan_tpu_torch.eval import privacy as tpriv
from gemm_gan_tpu_torch.utils.tsne import tsne
from gemm_gan_tpu_torch.utils.umap_lite import umap_embed

CPU = "cpu"
SCORE_TOL = 1e-5
COUNT_TOL = 1e-6
needs_matplotlib = pytest.mark.skipif(not viz.matplotlib_available(),
                                      reason="matplotlib is not installed")


# ---------------------------------------------------------------- retrieval
def test_retrieve_cross_modal_matches_jax():
    rng = np.random.RandomState(0)
    q, g = rng.randn(20, 16).astype(np.float32), rng.randn(50, 16).astype(np.float32)
    g[7] = 0.0  # a zero gallery vector: the norm's floor, not NaN
    for k in (1, 3):
        idx, scores = tpriv.retrieve_cross_modal(q, g, top_k=k, device=CPU)
        jidx, jscores = jpriv.retrieve_cross_modal(q, g, top_k=k)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(scores, jscores, atol=SCORE_TOL)


def test_retrieval_accuracy_matches_jax():
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 3, 12)
    patches = [rng.randn(rng.randint(2, 6), 8).astype(np.float32) + labels[i]
               for i in range(12)]
    text = rng.randn(12, 8).astype(np.float32) + labels[:, None]
    gen_labels = rng.randint(0, 3, 30)
    gen = rng.randn(30, 8).astype(np.float32) + gen_labels[:, None]
    got = tpriv.retrieval_accuracy(gen, gen_labels, labels, patches, text, device=CPU)
    want = jpriv.retrieval_accuracy(gen, gen_labels, labels, patches, text)
    assert got == want


# ----------------------------------------------------------------- privacy
def _dump_dirs(root, n_dirs=2, seed=2, labels=True):
    """test_{run}_epoch_{E} dirs of the dump contract (JAX's writer)."""
    rng = np.random.RandomState(seed)
    for run in range(n_dirs):
        real = rng.randn(30, 12).astype(np.float32)
        arrays = {"data_real": real, "data_gen": (real + 0.3 * rng.randn(30, 12)).astype(
                      np.float32),
                  "test_real": rng.randn(20, 12).astype(np.float32),
                  "test_gen": (rng.randn(20, 12) + 0.4).astype(np.float32)}
        if labels:
            for f in ("train_labels_real", "train_labels_gen"):
                arrays[f] = rng.randint(0, 3, 30)
            for f in ("test_labels_real", "test_labels_gen"):
                arrays[f] = rng.randint(0, 3, 20)
        jax_save_run_artifacts(os.path.join(root, f"test_{run}_epoch_{3 + 2 * run}"), arrays)


def test_privacy_evaluator_matches_jax(tmp_path):
    _dump_dirs(str(tmp_path), n_dirs=3)
    os.makedirs(tmp_path / "test_9_epoch_9")  # nonconforming: skipped by both
    np.save(tmp_path / "test_9_epoch_9" / "data_gen.npy", np.zeros((3, 12), np.float32))
    got = tpriv.PrivacyEvaluator(str(tmp_path), device=CPU).evaluate()
    want = jpriv.PrivacyEvaluator(str(tmp_path)).evaluate()
    assert sorted(got) == sorted(want) == ["dcr", "dcr_mean", "nndr", "nndr_mean"]
    for k in ("dcr", "nndr"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=COUNT_TOL)
    for k in ("dcr_mean", "nndr_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_TOL)
    train_real = np.random.RandomState(3).randn(25, 12).astype(np.float32)
    got = tpriv.PrivacyEvaluator(str(tmp_path), device=CPU).evaluate(train_real)
    want = jpriv.PrivacyEvaluator(str(tmp_path)).evaluate(train_real)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_TOL, atol=COUNT_TOL)
    assert tpriv.PrivacyEvaluator(str(tmp_path / "none"), device=CPU).evaluate() == {}


# ------------------------------------------------------------------- TF-TG
def _tf_tg_graph(path, genes, rng):
    """A synthetic TSV graph of `tf \\t _ \\t tg` lines, with targets and a
    TF missing from the expression matrix and a blank line."""
    lines = []
    for tf in ("G0", "G3", "G7", "NOPE"):
        for tg in rng.choice(genes + ["ABSENT"], 4, replace=False):
            lines.append(f"{tf}\tactivates\t{tg}")
    lines.insert(3, "")
    path.write_text("\n".join(lines) + "\n")


def test_tf_tg_helpers_match_jax_bit_for_bit(tmp_path):
    rng = np.random.RandomState(4)
    genes = [f"G{i}" for i in range(15)]
    expr = rng.randn(40, 15)
    expr[:, 5] = 1.0  # a constant target: the zero-variance guard
    _tf_tg_graph(tmp_path / "graph.tsv", genes, rng)
    graph = tgamma.load_tf_tg_graph(str(tmp_path / "graph.tsv"))
    assert graph == jgamma.load_tf_tg_graph(str(tmp_path / "graph.tsv"))
    got, want = tgamma.tf_tg_corrs(expr, genes, graph), jgamma.tf_tg_corrs(expr, genes, graph)
    assert list(got) == list(want) and "NOPE" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for flat in (True, False):
        got = tgamma.compute_tf_tg_corrs(expr, genes, graph, flat=flat)
        want = jgamma.compute_tf_tg_corrs(expr, genes, graph, flat=flat)
        assert got == want


# ------------------------------------------------------------- embeddings
def test_umap_embed_matches_jax_bit_for_bit():
    rng = np.random.RandomState(5)
    data = np.concatenate([rng.randn(30, 6), rng.randn(30, 6) + 4.0])
    data[5] = data[6]  # duplicated rows stay finite
    for seed in (0, 42):
        got = umap_embed(data, n_neighbors=8, n_epochs=60, seed=seed)
        np.testing.assert_array_equal(got, jax_umap_embed(data, n_neighbors=8, n_epochs=60,
                                                          seed=seed))
        assert np.isfinite(got).all()
    np.testing.assert_array_equal(viz.umap_2d(data[:25], n_neighbors=5, seed=3),
                                  jviz.umap_2d(data[:25], n_neighbors=5, seed=3))


def test_tsne_is_not_ported(tmp_path):
    """Named when t-SNE raised; it is ported now: `tsne_2d` is `utils.tsne`
    with JAX's perplexity clamp (held against scikit-learn in
    tests/test_torch_tsne.py), on the card unless device="cpu"; the
    panels' t-SNE takes it too."""
    rng = np.random.RandomState(8)
    real, fake = rng.randn(12, 6), rng.randn(12, 6) + 3.0
    both = np.concatenate([real, fake])
    got = viz.tsne_2d(both, device=CPU)
    assert got.shape == (24, 2) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, tsne(both, (24 - 1) / 3.0, device=CPU).embedding)
    if viz.matplotlib_available():
        out = str(tmp_path / "tsne.png")
        assert viz.plot_embedding_panels(real, fake, method="tsne", out_path=out,
                                         device=CPU) == out and os.path.exists(out)
    else:
        with pytest.raises(ImportError, match="matplotlib"):
            viz.plot_embedding_panels(real, fake, method="tsne", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            viz.tsne_2d(both)


@needs_matplotlib
def test_figures_are_written(tmp_path):
    rng = np.random.RandomState(6)
    real, fake = rng.randn(30, 10), rng.randn(30, 10) + 0.5
    labels = rng.randint(0, 3, 30)
    outs = [
        viz.plot_embedding_panels(real, fake, labels=labels,
                                  out_path=str(tmp_path / "panels.png")),
        viz.plot_embedding_panels(real, fake, out_path=str(tmp_path / "panel.png")),
        viz.plot_gene_distributions(real, fake, [0, 3, 7],
                                    out_path=str(tmp_path / "genes.png")),
        viz.plot_distance_matrix(real, fake, out_path=str(tmp_path / "dist.png")),
        viz.scatter_2d(real[:, :2], labels, out_path=str(tmp_path / "scatter.png"),
                       title="t"),
        viz.plot_distance_matrices(real, fake, out_path=str(tmp_path / "mats.png")),
        viz.plot_learned_graph(rng.rand(6, 6), str(tmp_path), epoch=3),
        viz.plot_curves({"loss": [3, 2, 1]}, out_path=str(tmp_path / "curves.png")),
    ]
    for out in outs:
        assert os.path.getsize(out) > 0, out
    assert np.load(tmp_path / "learned_graph3.npy").shape == (6, 6)


def test_figures_without_matplotlib_raise_naming_it(monkeypatch, tmp_path):
    monkeypatch.setattr(viz, "matplotlib_available", lambda: False)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_gene_distributions(np.zeros((4, 3)), np.zeros((4, 3)), [0])
    _dump_dirs(str(tmp_path), n_dirs=1)
    with pytest.raises(ImportError, match="matplotlib"):
        cli_evaluate.main(["--results_path", str(tmp_path), "--plots", "--skip_utility",
                           "--device", "cpu"])
    assert not os.path.exists(tmp_path / "test_0_epoch_3" / "figures")


# ---------------------------------------------------------------- the CLI
def _per_run_close(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    assert got["dir"] == want["dir"]
    assert abs(got["gamma"] - want["gamma"]) <= SCORE_TOL
    for k in ("1-Wasserstein", "2-Wasserstein"):
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
    for k in ("Linear_MMD", "Poly_MMD"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    for k in ("dcr", "nndr"):
        if k in want:
            assert abs(got[k] - want[k]) <= COUNT_TOL, k


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.mark.parametrize("epoch", ["auto", "all", "3"])
def test_cli_evaluate_matches_jax(tmp_path, epoch):
    """Both `cli.evaluate.main`s on one run dir of two dumps (epochs 3 and
    5, best.json naming 5): the epoch choice, the report's keys and per-run
    values, and `--out`."""
    _dump_dirs(str(tmp_path), n_dirs=2)
    with open(tmp_path / "best.json", "w") as f:
        json.dump({"epoch": 5, "step": 40, "score": 1.0}, f)
    args = ["--results_path", str(tmp_path), "--epoch", epoch]
    got = cli_evaluate.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    want = jax_evaluate(args)
    dirs = {"auto": ["test_1_epoch_5"], "all": ["test_0_epoch_3", "test_1_epoch_5"],
            "3": ["test_0_epoch_3"]}[epoch]
    assert [r["dir"] for r in got["per_run"]] == [r["dir"] for r in want["per_run"]] == dirs
    assert _keys(got) == _keys(json.loads(json.dumps(want, default=float)))
    for g, w in zip(got["per_run"], want["per_run"], strict=True):
        _per_run_close(g, w)
    for report in ("utility_disease", "utility_primary_site"):
        if report in got:
            for setting in got[report].values():
                for clf in setting.values():
                    assert all(0.0 <= m <= 1.0 for m, _ in clf.values())
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["per_run"][0]["dir"] == dirs[0]


def test_cli_evaluate_train_real_skip_utility_and_label_free_dumps(tmp_path):
    """Dumps without labels (an unconditional run) under --skip_utility;
    --train_real replaces data_real as the privacy reference; a dump dir
    without data_gen skips privacy only."""
    _dump_dirs(str(tmp_path), n_dirs=2, labels=False)
    os.remove(tmp_path / "test_1_epoch_5" / "data_gen.npy")
    train_real = np.random.RandomState(7).randn(25, 12).astype(np.float32)
    np.save(tmp_path / "train_real.npy", train_real)
    args = ["--results_path", str(tmp_path), "--skip_utility",
            "--train_real", str(tmp_path / "train_real.npy")]
    got = cli_evaluate.main(args + ["--device", "cpu"])
    want = jax_evaluate(args)
    assert "utility_disease" not in got and len(got["per_run"]) == 2
    assert "dcr" in got["per_run"][0] and "dcr" not in got["per_run"][1]
    for g, w in zip(got["per_run"], want["per_run"], strict=True):
        _per_run_close(g, w)


@needs_matplotlib
def test_cli_evaluate_plots(tmp_path):
    _dump_dirs(str(tmp_path), n_dirs=1)
    got = cli_evaluate.main(["--results_path", str(tmp_path), "--skip_utility", "--plots",
                             "--plot_genes", "5", "--device", "cpu"])
    fig_dir = got["per_run"][0]["figures"]
    assert sorted(os.listdir(fig_dir)) == ["corr_distance_matrices.png",
                                           "embedding_panels.png", "gene_distributions.png"]


def test_cli_evaluate_parser_matches_jax():
    from gemm_gan_tpu.cli.evaluate import build_parser as jax_parser

    port = {a.dest for a in cli_evaluate.build_parser()._actions}
    assert port - {a.dest for a in jax_parser()._actions} == {"device"}
