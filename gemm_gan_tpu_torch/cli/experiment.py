"""The experiment protocol around the fused engine, on one device or a mesh.

Counterpart of `gemm_gan_tpu/cli/experiment.py::Experiment`:

  * `fit`: training epochs, validation every `freq_compute_test` epochs (not
    after the last) on train vs val regeneration (the on-device kNN + PRDC
    proxy with `eval.on_device_validation`, else the host detection and
    metric suites), the optional full-state checkpoint at each validation
    (`train.checkpoint_every_eval`), gate-best tracking in `ckpt_best/` and
    `best.json`; then the final checkpoint, the validation curves and the
    test block. `fit(resume=True)` continues from the newest checkpoint;
  * the test block: `n_runs` repetitions, each dumping the npy artifact
    contract into `test_{run}_epoch_{E}/` and scoring Γ, detection, the
    evaluation metrics and (with `eval.pr_nhood_sizes`) P/R@k;
  * `evaluate(which)`: restore the last or the gate-best checkpoint and
    rerun the test block named by the restored step's epoch;
  * `posthoc_utility` / `posthoc_privacy` over the dumps.

Random draws: validation and test generation draw z from their own
generators, seeded from (seed + 1, epoch) and (seed + 2, run), never from
the training state's, so validating changes nothing in training and
`evaluate` regenerates a run's test block exactly. (The JAX package folds
its keys the same way; torch cannot give `jax.random`'s bits, so the
numbers differ.) A fresh `fit` seeds the device's default generator, which
the nets' dropout draws from, with `train.seed`; a checkpoint carries its
state.

`eval.scan_sampling` takes the engine's graphed sampling path
(`generate_samples_all(scan=True)`, the same profiles bit for bit).

Under a mesh (`mesh`: every rank constructs the Experiment with the SAME
full `splits` and its `parallel.mesh.Mesh`), as the JAX multi-process
contract:

  * training is sharded by batch: each data rank feeds its contiguous
    block of every global batch (`Batches(shard_mode="batch",
    process_index=data index, process_count=D)`), or, under
    `data.shard_bank`, gathers from its shard of a `ShardedDeviceCache`;
    the ranks of one `model` group feed the same rows;
  * validation and test generation run on host loaders of the full splits
    on every rank (under `data.shard_bank` the train split trimmed to the
    cases the bank trained, and a one-time host patch subsample to
    `num_patches`); each batch's rows are split over `data` and gathered
    (`WGANGPEngine.generate_samples_all`), so every rank holds them all;
  * the host metric suites, npy dumps, curves, logs and JSON files are
    rank 0's: `fit()` / `evaluate()` return the results there and `{}`
    elsewhere; checkpoint save / restore is collective (`train.checkpoint`)
    and the gate-best decision is rank 0's, broadcast; the post-hoc suites
    read rank 0's dumps and are rank 0's to call;
  * dropout draws from the device's default generator seeded with
    `train.seed` + the data index (the ranks of a `model` group draw the
    same masks).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import sys
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig
from gemm_gan_tpu_torch.data.device_cache import DeviceCache, ShardedDeviceCache, epoch_seed
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.eval.detection import (compute_evaluation_metrics, detection,
                                               knn_detection)
from gemm_gan_tpu_torch.eval.gamma import gamma_coef
from gemm_gan_tpu_torch.eval.knn_pr import knn_precision_recall_features
from gemm_gan_tpu_torch.eval.prdc import compute_prdc
from gemm_gan_tpu_torch.eval.privacy import dcr, nndr
from gemm_gan_tpu_torch.eval.utility import (UtilityEvaluator, UtilityEvaluatorPrimary,
                                             save_run_artifacts)
from gemm_gan_tpu_torch.parallel.comm import broadcast_object
from gemm_gan_tpu_torch.train.checkpoint import (dropout_generator, resolve_ckpt_dir,
                                                 restore_state, resume_or_fresh, save_state)
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device
from gemm_gan_tpu_torch.utils.metrics import TRACER, EpochProfileWindow, MetricLogger
from gemm_gan_tpu_torch.viz import matplotlib_available, plot_curves

def _host_subsample_patches(split: Dict, num_patches: int, seed: int) -> Dict:
    """One-time seeded host subsample of a full-width patch bank to
    `num_patches` valid patches per case (zero-padded + masked below that)."""
    if "patches" not in split or split["patches"].shape[1] <= num_patches:
        return split
    rng = np.random.RandomState(seed)
    pats, masks = split["patches"], split["patch_mask"]
    n = len(pats)
    out_p = np.zeros((n, num_patches) + pats.shape[2:], pats.dtype)
    out_m = np.zeros((n, num_patches), bool)
    for i in range(n):
        valid = np.flatnonzero(masks[i])
        sel = (rng.choice(valid, num_patches, replace=False)
               if len(valid) > num_patches else valid)
        out_p[i, :len(sel)] = pats[i, sel]
        out_m[i, :len(sel)] = True
    out = dict(split)
    out["patches"], out["patch_mask"] = out_p, out_m
    return out


def val_score(rec: Dict) -> float:
    """Scalar quality of one validation record, higher = better:
    (1 - detection accuracy) + precision + recall + coverage. The detector
    is "LR" in host-suite mode and "KNN" in the on-device proxy."""
    det_d = rec["detection"]
    det = (det_d.get("LR") or det_d.get("KNN") or next(iter(det_d.values())))["accuracy"]
    m = rec["metrics"]
    return float((1.0 - det) + m["precision"] + m["recall"] + m.get("coverage", 0.0))


def _balanced_indices(disease: np.ndarray, max_oversample: int, rng) -> np.ndarray:
    """Class-balanced oversampling capped at max_oversample x."""
    classes, counts = np.unique(disease, return_counts=True)
    max_count = counts.max()
    out = []
    for cls, cnt in zip(classes, counts):
        idx = np.where(disease == cls)[0]
        target = min(max_count, cnt * max_oversample)
        reps = rng.choice(idx, target, replace=True) if target > cnt else idx
        out.append(reps)
    out = np.concatenate(out)
    rng.shuffle(out)
    return out


def _store_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


class Experiment:
    """The experiment protocol of one run on one device (`device`: the CUDA
    card unless "cpu"), or on this rank's share of a mesh (`mesh`)."""

    def __init__(self, cfg: ExperimentConfig, splits: Dict, mesh=None,
                 device: DeviceLike = None):
        if cfg.data.shard_bank and mesh is None:
            raise ValueError("data.shard_bank shards the training bank over a mesh's data "
                             "axis and needs a mesh; on one device use the replicated "
                             "DeviceCache (data.cache_on_device)")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.is_main = mesh is None or mesh.rank == 0
        self.cfg = cfg
        self.splits = splits
        t = cfg.train
        if mesh is not None:
            self._mesh_loaders(cfg, splits)
        elif cfg.data.cache_on_device:
            # the banks on the device: gathers and fresh per-step patch
            # subsampling there
            def make(name):
                return DeviceCache(splits[name], t.batch_size,
                                   num_patches=cfg.data.num_patches, seed=t.seed,
                                   shuffle=(name == "train"), drop_remainder=False,
                                   embedding_store_dtype=_store_dtype(
                                       cfg.data.embedding_store_dtype),
                                   device=self.device)
        else:
            def make(name):
                # drop_remainder=False: ragged tails train and evaluate
                return Batches(splits[name], t.batch_size, seed=t.seed,
                               shuffle=(name == "train"), drop_remainder=False)
        if mesh is None:
            self.loaders = {name: make(name) for name in ("train", "val", "test")
                            if name in splits}
            self.gen_loaders = self.loaders
        self.engine = WGANGPEngine(cfg, steps_per_epoch=len(self.loaders["train"]),
                                   device=self.device, mesh=mesh)
        self.out_dir = os.path.join(cfg.output_dir, cfg.run_name)
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger = MetricLogger(self.out_dir, cfg.run_name) if self.is_main else None
        self.val_metrics_history = []
        self._best = None  # {score, epoch, eval_epoch, step} of ckpt_best

    def _mesh_loaders(self, cfg: ExperimentConfig, splits: Dict) -> None:
        """This rank's training loader and the generation loaders of a mesh
        run (the class docstring)."""
        t, mesh = cfg.train, self.mesh
        D = mesh.shape["data"]
        if t.batch_size % D:
            raise ValueError(f"global batch_size {t.batch_size} must divide evenly across "
                             f"the data axis ({D})")
        if cfg.data.shard_bank:
            train = ShardedDeviceCache(
                splits["train"], t.batch_size, mesh, num_patches=cfg.data.num_patches,
                seed=t.seed, embedding_store_dtype=_store_dtype(cfg.data.embedding_store_dtype))
        else:
            train = Batches(splits["train"], t.batch_size // D, seed=t.seed, shuffle=True,
                            drop_remainder=False, process_index=mesh.index("data"),
                            process_count=D, shard_mode="batch")
        self.loaders = {"train": train}

        def gen_split(name):
            s = splits[name]
            if cfg.data.shard_bank:
                if name == "train":
                    keep = (len(s["genes"]) // D) * D
                    s = {k: v[:keep] for k, v in s.items()}
                s = _host_subsample_patches(s, cfg.data.num_patches, t.seed)
            return s

        self.gen_loaders = {
            name: Batches(gen_split(name), t.batch_size, seed=t.seed,
                          shuffle=(name == "train"), drop_remainder=False)
            for name in ("train", "val", "test") if name in splits}

    def _generate_all(self, state, generator: torch.Generator, loader, epoch: int,
                      device_out: bool = False, batches=None):
        """`generate_samples_all` over a whole split's `loader.epoch(epoch)`
        (or over `batches`, a callable returning an iterable), streamed one
        batch at a time."""
        if batches is None:
            batches = lambda: loader.epoch(epoch)  # noqa: E731
        return self.engine.generate_samples_all(state, batches, 1, generator,
                                                device_out=device_out,
                                                scan=self.cfg.eval.scan_sampling)

    def _generator(self, seed: int, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(epoch_seed(seed, index))

    # ----------------------------------------------------------------- train
    def fit(self, resume: bool = False, profile_dir: str = None,
            profile_epochs: int = 1) -> Dict:
        """Train, validate, checkpoint, then run the test block; returns its
        summary. `resume=True` continues from the newest full-state
        checkpoint under this run dir (params, optimizer moments and counts,
        EMA, step, generators): the same final state as an uninterrupted run.
        No checkpoint: a fresh start. `profile_dir`: a `torch.profiler` trace
        of `profile_epochs` epochs, opened after the first epoch of this
        call (needs >= 2 epochs), and the tracer (`utils/metrics.py`) on over
        the whole fit, its `summary()` kept as `trace_summary`."""
        t = self.cfg.train
        eng = self.engine
        train = self.loaders["train"]
        state = eng.init_state(t.seed, next(iter(train.epoch(0))))
        dropout_generator(self.device).manual_seed(
            t.seed + (0 if self.mesh is None else self.mesh.index("data")))

        # whole epochs as one call need >= 1 full batch: a DeviceCache goes
        # through the graphed step_many_cached, host batches through
        # step_many on the stacked epoch; tiny splits take the per-batch path
        scan_cache = stacked_fn = None
        if train.n_full_batches:
            if isinstance(train, (DeviceCache, ShardedDeviceCache)):
                scan_cache = train
            else:
                stacked_fn = train.stacked_epoch
        use_scan = scan_cache is not None or stacked_fn is not None
        steps_per_epoch = train.n_full_batches if use_scan else len(train)

        start_epoch = 0
        ckpt_dir = os.path.join(self.out_dir, "ckpt")
        if not resume and self.is_main:
            # a fresh fit into a used out_dir must not inherit the old run's
            # gate-best state
            best_ckpt = os.path.join(self.out_dir, "ckpt_best")
            if os.path.isdir(best_ckpt):
                shutil.rmtree(best_ckpt)
            best_json = os.path.join(self.out_dir, "best.json")
            if os.path.exists(best_json):
                os.remove(best_json)
        elif resume:
            state, start_epoch = resume_or_fresh(ckpt_dir, state, steps_per_epoch,
                                                 t.epochs, loader=train)
            if start_epoch:
                # the pre-crash validation history and best record, so the
                # curves cover the whole run and the resumed tail replaces
                # ckpt_best only when it beats the earlier peak
                hist_path = os.path.join(self.out_dir, "val_metrics.json")
                if os.path.exists(hist_path):
                    with open(hist_path) as f:
                        self.val_metrics_history = [r for r in json.load(f)
                                                    if r["epoch"] < start_epoch]
                best_path = os.path.join(self.out_dir, "best.json")
                if os.path.exists(best_path):
                    with open(best_path) as f:
                        self._best = json.load(f)

        prof = EpochProfileWindow(profile_dir, profile_epochs)
        if profile_dir is not None:
            TRACER.reset()
            TRACER.enable()

        def on_epoch_end(engine, state, epoch):
            prof.on_epoch_end(epoch)
            if (epoch + 1) % t.freq_compute_test == 0 and epoch != t.epochs - 1:
                rec = self._validation_eval(state, epoch)
                if t.checkpoint_every_eval:
                    save_state(ckpt_dir, state)
                self._maybe_save_best(state, rec, epoch)
            return None

        try:
            state = eng.fit(state, t.epochs, lambda: train.epoch(),
                            on_epoch_end=on_epoch_end, logger=self.logger,
                            stacked_fn=stacked_fn, scan_cache=scan_cache,
                            start_epoch=start_epoch)
        finally:
            prof.close()
            if profile_dir is not None:
                TRACER.disable()
        self.profile_captured = prof.captured
        self.trace_summary = TRACER.summary() if profile_dir is not None else None
        self.state = state
        save_state(ckpt_dir, state)
        self._plot_val_curves()
        return self._test_block(state)

    def _validation_eval(self, state, epoch: int) -> Dict:
        """Detection + metrics on train vs val regeneration. With
        `eval.on_device_validation` the profiles stay on the device and a
        kNN detection test + PRDC run there (only neighbour indices and
        scalars leave it); otherwise the host suites run. The train side is
        capped at `eval.validation_max_cases` cases (None: the whole split)."""
        ev = self.cfg.eval
        gen = self._generator(self.cfg.train.seed + 1, epoch)
        train_loader, val_loader = self.gen_loaders["train"], self.gen_loaders["val"]
        train_batches = None
        if ev.validation_max_cases is not None:
            n_b = max(1, ev.validation_max_cases // train_loader.batch_size)
            train_batches = lambda: itertools.islice(train_loader.epoch(epoch), n_b)  # noqa: E731
        on_device = ev.on_device_validation
        train_out = self._generate_all(state, gen, train_loader, epoch,
                                       device_out=on_device, batches=train_batches)
        val_out = self._generate_all(state, gen, val_loader, epoch, device_out=on_device)
        if not self.is_main:
            return None
        if on_device:
            det = knn_detection(train_out["real"], train_out["fake"],
                                val_out["real"], val_out["fake"])
            metrics = compute_prdc(train_out["real"], train_out["fake"],
                                   nearest_k=ev.nearest_k)
        else:
            det = detection(train_out["real"], train_out["fake"],
                            val_out["real"], val_out["fake"], device=self.device)
            metrics = compute_evaluation_metrics(
                train_out["real"], train_out["fake"], val_out["real"], val_out["fake"],
                nn=ev.nearest_k,
                n_components=min(ev.pca_components, train_out["real"].shape[0] - 1),
                device=self.device)
        rec = {"epoch": epoch, "detection": det, "metrics": metrics}
        self.val_metrics_history.append(rec)
        # persisted after every eval, so a resumed run can rehydrate it
        with open(os.path.join(self.out_dir, "val_metrics.json"), "w") as f:
            json.dump(self.val_metrics_history, f, indent=2, default=float)
        det_first = next(iter(det.values()))
        self.logger.log(epoch, val_detection_acc=det_first["accuracy"],
                        val_precision=metrics["precision"], val_recall=metrics["recall"])
        return rec

    def _maybe_save_best(self, state, rec: Dict, epoch: int) -> None:
        """Save the full state to `ckpt_best/` and record {score, epoch,
        eval_epoch, step} in `best.json` whenever a validation scores
        strictly above the best so far (`val_score`; ties keep the earliest
        peak). "epoch" counts the epochs completed, the number `evaluate`
        names its dumps by; "eval_epoch" is the 0-based validation epoch."""
        score = broadcast_object(None if rec is None else val_score(rec), self.mesh)
        if self._best is not None and score <= self._best["score"]:
            return
        step = save_state(os.path.join(self.out_dir, "ckpt_best"), state)
        self._best = {"score": float(score), "epoch": int(epoch) + 1,
                      "eval_epoch": int(epoch), "step": int(step)}
        if self.is_main:
            with open(os.path.join(self.out_dir, "best.json"), "w") as f:
                json.dump(self._best, f, indent=2)

    def _plot_val_curves(self) -> None:
        """`validation_metrics.png`; without matplotlib none is written (the
        curves are in `val_metrics.json`) and stderr says so."""
        if not self.val_metrics_history or not self.is_main:
            return
        if not matplotlib_available():
            print("matplotlib is not installed: validation_metrics.png not written "
                  "(val_metrics.json holds the curves)", file=sys.stderr)
            return
        hist = {
            # "LR" in host mode; "KNN" in on-device-proxy mode
            "detection_acc": [next(iter(r["detection"].values()))["accuracy"]
                              for r in self.val_metrics_history],
            "precision": [r["metrics"]["precision"] for r in self.val_metrics_history],
            "recall": [r["metrics"]["recall"] for r in self.val_metrics_history],
            "coverage": [r["metrics"]["coverage"] for r in self.val_metrics_history],
        }
        plot_curves(hist, os.path.join(self.out_dir, "validation_metrics.png"),
                    title="validation metrics")

    # ------------------------------------------------------------------ test
    def _test_block(self, state, epoch: Optional[int] = None) -> Dict:
        """`eval.n_runs` test repetitions: artifact dumps + per-run metrics."""
        t, ev = self.cfg.train, self.cfg.eval
        epoch = t.epochs if epoch is None else epoch
        all_results = []
        has_labels = "disease" in self.splits["train"]
        for run in range(ev.n_runs):
            gen = self._generator(t.seed + 2, run)
            train_out = self._generate_all(state, gen, self.gen_loaders["train"], run)
            test_out = self._generate_all(state, gen, self.gen_loaders["test"], run)
            if not self.is_main:
                continue
            run_dir = os.path.join(self.out_dir, f"test_{run}_epoch_{epoch}")
            arrays = {"data_real": train_out["real"], "data_gen": train_out["fake"],
                      "test_real": test_out["real"], "test_gen": test_out["fake"]}
            if has_labels:
                arrays.update({
                    "train_labels_real": train_out["disease"],
                    "train_labels_gen": train_out["disease"],
                    "test_labels_real": test_out["disease"],
                    "test_labels_gen": test_out["disease"],
                })
                if "site" in train_out:
                    arrays.update({
                        "train_labels_primary_site_real": train_out["site"],
                        "train_labels_primary_site_gen": train_out["site"],
                        "test_labels_primary_site_real": test_out["site"],
                        "test_labels_primary_site_gen": test_out["site"],
                    })
            save_run_artifacts(run_dir, arrays)

            pr_at_k = {}
            if ev.pr_nhood_sizes:
                # kNN P/R at each k on the test-set real-vs-gen pair, for
                # the sizes the manifold can hold
                n_ref = min(test_out["real"].shape[0], test_out["fake"].shape[0])
                ks = tuple(k for k in ev.pr_nhood_sizes if k < n_ref)
                if ks:
                    state_pr = knn_precision_recall_features(
                        test_out["real"], test_out["fake"], nhood_sizes=ks,
                        device=self.device)
                    for i, k in enumerate(ks):
                        pr_at_k[f"precision@{k}"] = float(state_pr["precision"][i])
                        pr_at_k[f"recall@{k}"] = float(state_pr["recall"][i])

            all_results.append({
                "gamma": float(gamma_coef(test_out["real"], test_out["fake"],
                                          device=self.device)),
                **pr_at_k,
                "detection": detection(train_out["real"], train_out["fake"],
                                       test_out["real"], test_out["fake"],
                                       device=self.device),
                "metrics": compute_evaluation_metrics(
                    train_out["real"], train_out["fake"], test_out["real"], test_out["fake"],
                    nn=ev.nearest_k,
                    n_components=min(ev.pca_components, train_out["real"].shape[0] - 1),
                    device=self.device),
            })
        if not self.is_main:
            return {}
        return {"gamma_mean": float(np.mean([r["gamma"] for r in all_results])),
                "gamma_std": float(np.std([r["gamma"] for r in all_results])),
                "runs": all_results}

    # -------------------------------------------------------------- evaluate
    def evaluate(self, which: str = "last") -> Dict:
        """Restore the newest checkpoint (`which="last"`) or the gate-best
        one (`"best"`: `ckpt_best/`, pinned to `best.json`'s step) and rerun
        the test block, its dumps named by the restored step's epoch (a
        full run's restore overwrites fit's dumps with equal arrays)."""
        ckpt_dir, step = resolve_ckpt_dir(os.path.join(self.out_dir, "ckpt"), which)
        train = self.loaders["train"]
        template = self.engine.init_state(self.cfg.train.seed, next(iter(train.epoch(0))))
        state = restore_state(ckpt_dir, template, step=step)
        # fit()'s steps-per-epoch accounting: full batches on the stacked
        # paths, every batch on the per-batch one
        steps_per_epoch = train.n_full_batches or len(train)
        epoch = min(int(state.step) // max(steps_per_epoch, 1), self.cfg.train.epochs)
        return self._test_block(state, epoch=epoch)

    # -------------------------------------------------------------- post-hoc
    def posthoc_utility(self, epoch: Optional[int] = None) -> Dict:
        """UtilityEvaluator + primary-site variant over the dumps; `epoch`
        keeps one epoch's dump dirs (e.g. best.json's)."""
        pattern = "test_*" if epoch is None else f"test_*_epoch_{epoch}"
        out = {}
        ev = UtilityEvaluator(self.out_dir, pattern=pattern, device=self.device)
        if ev.results_dirs:
            ev.evaluate()
            out["disease"] = ev.report()
        evp = UtilityEvaluatorPrimary(self.out_dir, pattern=pattern, device=self.device)
        try:
            if evp.results_dirs:
                evp.evaluate()
                out["primary_site"] = evp.report()
        except FileNotFoundError:
            pass  # dumps without primary-site labels
        return out

    def posthoc_privacy(self, epoch: Optional[int] = None) -> Dict:
        """DCR / NNDR over each test_* dir, against the train split; `epoch`
        filters like `posthoc_utility`."""
        pattern = "test_*" if epoch is None else f"test_*_epoch_{epoch}"
        train_real = self.splits["train"]["genes"]
        results = {"dcr": [], "nndr": []}
        for d in sorted(glob(os.path.join(self.out_dir, pattern))):
            gen = np.load(os.path.join(d, "data_gen.npy"))
            test_real = np.load(os.path.join(d, "test_real.npy"))
            results["dcr"].append(dcr(train_real, gen, test_real, device=self.device))
            results["nndr"].append(nndr(train_real, gen, test_real, device=self.device))
        return {k: (float(np.mean(v)), float(np.std(v))) for k, v in results.items() if v}

    def generate_balanced(self, state, generator: torch.Generator,
                          num_repeats: int = 1, host_dtype=None) -> Dict:
        """Generation over the train split oversampled to balance the
        disease classes (at most `eval.balanced_max_oversample` x).
        `host_dtype` goes to `generate_samples_all` (a cast on the device
        before the copy to the host)."""
        t, ev = self.cfg.train, self.cfg.eval
        data = self.splits["train"]
        rng = np.random.RandomState(t.seed)
        idx = _balanced_indices(data["disease"], ev.balanced_max_oversample, rng)
        balanced = {k: v[idx] for k, v in data.items()}
        loader = Batches(balanced, 64, seed=t.seed, shuffle=False, drop_remainder=False)
        return self.engine.generate_samples_all(state, lambda: loader.epoch(0),
                                                num_repeats, generator,
                                                scan=ev.scan_sampling, host_dtype=host_dtype)
