"""The experiment protocol of the VAE family, single-process.

Counterpart of `gemm_gan_tpu/cli/vae_experiment.py::VAEExperiment`, beside
`cli/experiment.py`'s `Experiment` for the GANs, with the same contract:

  * `fit`: training epochs (the stacked epoch through `VAEEngine.step_many`,
    one CUDA graph replayed per batch on the card; the per-batch path for a
    split with no full batch), every `freq_compute_test` epochs (not after
    the last) a full-state checkpoint and a validation by the mean β-ELBO
    of the val split, gate-best tracking (`ckpt_best/`, `best.json` with
    score = -val loss), then the final checkpoint and the test block. A
    fresh fit removes an earlier run's gate-best state; `fit(resume=True)`
    continues from the newest checkpoint;
  * the test block: `n_runs` repetitions, each dumping the npy contract of
    `Experiment` into `test_{run}_epoch_{E}/` (with the labels for the
    CVAE) and scoring Γ, detection and the evaluation metrics;
  * `evaluate(which)`: restore the last or the gate-best checkpoint and
    rerun the test block named by the restored step's epoch;
  * `posthoc_utility` / `posthoc_privacy`, borrowed from `Experiment`.

Loaders keep ragged tails (`drop_remainder=False`). Random draws: the
validation's noise and the test block's prior draws come from their own
generators, seeded from (seed + 3, epoch) and (seed + 2, run), never from
the training state's. (JAX folds its keys the same way; torch cannot give
`jax.random`'s bits, so the numbers differ.)
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig
from gemm_gan_tpu_torch.data.device_cache import epoch_seed
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.eval.detection import compute_evaluation_metrics, detection
from gemm_gan_tpu_torch.eval.gamma import gamma_coef
from gemm_gan_tpu_torch.eval.utility import save_run_artifacts
from gemm_gan_tpu_torch.train.checkpoint import (resolve_ckpt_dir, restore_state,
                                                 resume_or_fresh, save_state)
from gemm_gan_tpu_torch.train.vae import VAEEngine
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device
from gemm_gan_tpu_torch.utils.metrics import EpochProfileWindow, MetricLogger


class VAEExperiment:
    """The VAE / CVAE protocol of one run on one device (`device`: the CUDA
    card unless "cpu")."""

    def __init__(self, cfg: ExperimentConfig, splits: Dict, device: DeviceLike = None):
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            # single-process by design, as the JAX package's VAEExperiment
            raise ValueError(f"VAEExperiment runs on one process; got "
                             f"{dist.get_world_size()} ranks")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.splits = splits
        t = cfg.train
        self.loaders = {
            name: Batches(splits[name], t.batch_size, seed=t.seed,
                          shuffle=(name == "train"), drop_remainder=False)
            for name in ("train", "val", "test") if name in splits
        }
        self.engine = VAEEngine(cfg, steps_per_epoch=len(self.loaders["train"]),
                                device=self.device)
        self.out_dir = os.path.join(cfg.output_dir, cfg.run_name)
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger = MetricLogger(self.out_dir, cfg.run_name)
        self.val_metrics_history = []
        self._best = None  # {score, val_loss, epoch, eval_epoch, step} of ckpt_best

    def _generator(self, seed: int, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(epoch_seed(seed, index))

    def _steps_per_epoch(self) -> int:
        """The steps `fit` takes an epoch: the full batches on the stacked
        path, every batch on the per-batch one."""
        train = self.loaders["train"]
        return train.n_full_batches or len(train)

    # --------------------------------------------------------------- validation
    def _validation_eval(self, state, epoch: int) -> Optional[Dict]:
        """The val split's mean β-ELBO, recon and KL (batch-size weighted),
        the VAE's own selection criterion; None without a val split."""
        if "val" not in self.loaders:
            return None
        gen = self._generator(self.cfg.train.seed + 3, epoch)
        totals, n = {"loss": 0.0, "recon": 0.0, "kl": 0.0}, 0
        for batch in self.loaders["val"].epoch(epoch):
            m = self.engine.eval_loss(state, gen, batch)
            b = len(batch["genes"])
            for k in totals:
                totals[k] += m[k] * b
            n += b
        rec = {"epoch": epoch, **{k: v / n for k, v in totals.items()}}
        self.val_metrics_history.append(rec)
        self.logger.log(epoch, val_elbo=rec["loss"], val_recon=rec["recon"],
                        val_kl=rec["kl"])
        return rec

    def _maybe_save_best(self, state, rec: Optional[Dict], epoch: int) -> None:
        """Save to `ckpt_best/` and record `best.json` whenever the val
        loss is strictly below the best so far; `score` is -val loss, the
        GAN contract's higher-is-better number."""
        if rec is None:
            return
        score = -rec["loss"]
        if self._best is not None and score <= self._best["score"]:
            return
        step = save_state(os.path.join(self.out_dir, "ckpt_best"), state)
        self._best = {"score": float(score), "val_loss": float(rec["loss"]),
                      "epoch": int(epoch) + 1, "eval_epoch": int(epoch), "step": int(step)}
        with open(os.path.join(self.out_dir, "best.json"), "w") as f:
            json.dump(self._best, f, indent=2)

    # ------------------------------------------------------------------ train
    def fit(self, resume: bool = False, profile_dir: str = None,
            profile_epochs: int = 1) -> Dict:
        """Train, validate, checkpoint, then run the test block; returns its
        summary. `resume=True` continues from the newest full-state
        checkpoint in the run dir (a fresh start if there is none).
        `profile_dir`: a `torch.profiler` trace of `profile_epochs` epochs,
        opened after the first epoch of this call."""
        t = self.cfg.train
        train = self.loaders["train"]
        state = self.engine.init_state(t.seed, next(iter(train.epoch(0))))
        # the stacked path needs >= 1 full batch an epoch
        stacked_fn = train.stacked_epoch if train.n_full_batches else None
        ckpt_dir = os.path.join(self.out_dir, "ckpt")

        start_epoch = 0
        if resume:
            state, start_epoch = resume_or_fresh(ckpt_dir, state, self._steps_per_epoch(),
                                                 t.epochs, loader=train)
        else:
            # a fresh fit into a used out_dir must not inherit the old run's
            # gate-best state
            best_ckpt = os.path.join(self.out_dir, "ckpt_best")
            if os.path.isdir(best_ckpt):
                shutil.rmtree(best_ckpt)
            best_json = os.path.join(self.out_dir, "best.json")
            if os.path.exists(best_json):
                os.remove(best_json)

        prof = EpochProfileWindow(profile_dir, profile_epochs)

        def on_epoch_end(engine, state, epoch):
            prof.on_epoch_end(epoch)
            if (epoch + 1) % t.freq_compute_test == 0 and epoch != t.epochs - 1:
                save_state(ckpt_dir, state)
                self._maybe_save_best(state, self._validation_eval(state, epoch), epoch)
            return None

        try:
            state = self.engine.fit(state, t.epochs, lambda: train.epoch(),
                                    logger=self.logger, stacked_fn=stacked_fn,
                                    on_epoch_end=on_epoch_end, start_epoch=start_epoch)
        finally:
            prof.close()
        self.profile_captured = prof.captured
        self.state = state
        save_state(ckpt_dir, state)
        return self._test_block(state)

    # ------------------------------------------------------------------- test
    def _gen_like(self, state, generator: torch.Generator, loader, epoch: int) -> Dict:
        """Profiles decoded for each batch of `loader.epoch(epoch)` (for the
        CVAE, at the batch's labels), beside the real ones."""
        reals, fakes, diseases, sites = [], [], [], []
        for batch in loader.epoch(epoch):
            if self.engine.conditional:
                fake = self.engine.sample(state, generator, disease=batch["disease"],
                                          site=batch["site"])
                diseases.append(batch["disease"])
                sites.append(batch["site"])
            else:
                fake = self.engine.sample(state, generator, num=batch["genes"].shape[0])
            reals.append(batch["genes"])
            fakes.append(fake)
        out = {"real": np.concatenate(reals), "fake": np.concatenate(fakes)}
        if diseases:
            out["disease"] = np.concatenate(diseases)
            out["site"] = np.concatenate(sites)
        return out

    def _test_block(self, state, epoch: Optional[int] = None) -> Dict:
        """`eval.n_runs` test repetitions: artifact dumps + per-run metrics."""
        t, ev = self.cfg.train, self.cfg.eval
        epoch = t.epochs if epoch is None else epoch
        all_results = []
        for run in range(ev.n_runs):
            gen = self._generator(t.seed + 2, run)
            train_out = self._gen_like(state, gen, self.loaders["train"], run)
            test_out = self._gen_like(state, gen, self.loaders["test"], run)
            run_dir = os.path.join(self.out_dir, f"test_{run}_epoch_{epoch}")
            arrays = {"data_real": train_out["real"], "data_gen": train_out["fake"],
                      "test_real": test_out["real"], "test_gen": test_out["fake"]}
            if "disease" in train_out:
                arrays.update({
                    "train_labels_real": train_out["disease"],
                    "train_labels_gen": train_out["disease"],
                    "test_labels_real": test_out["disease"],
                    "test_labels_gen": test_out["disease"],
                    "train_labels_primary_site_real": train_out["site"],
                    "train_labels_primary_site_gen": train_out["site"],
                    "test_labels_primary_site_real": test_out["site"],
                    "test_labels_primary_site_gen": test_out["site"],
                })
            save_run_artifacts(run_dir, arrays)
            all_results.append({
                "gamma": float(gamma_coef(test_out["real"], test_out["fake"],
                                          device=self.device)),
                "detection": detection(train_out["real"], train_out["fake"],
                                       test_out["real"], test_out["fake"],
                                       device=self.device),
                "metrics": compute_evaluation_metrics(
                    train_out["real"], train_out["fake"], test_out["real"], test_out["fake"],
                    nn=ev.nearest_k,
                    n_components=min(ev.pca_components, train_out["real"].shape[0] - 1),
                    device=self.device),
            })
        return {"gamma_mean": float(np.mean([r["gamma"] for r in all_results])),
                "gamma_std": float(np.std([r["gamma"] for r in all_results])),
                "runs": all_results}

    # --------------------------------------------------------------- evaluate
    def evaluate(self, which: str = "last") -> Dict:
        """Restore the newest checkpoint (`which="last"`) or the lowest-val-
        ELBO one (`"best"`) and rerun the test block, its dumps named by the
        restored step's epoch."""
        ckpt_dir, step = resolve_ckpt_dir(os.path.join(self.out_dir, "ckpt"), which)
        template = self.engine.init_state(self.cfg.train.seed,
                                          next(iter(self.loaders["train"].epoch(0))))
        state = restore_state(ckpt_dir, template, step=step)
        epoch = min(int(state.step) // max(self._steps_per_epoch(), 1), self.cfg.train.epochs)
        return self._test_block(state, epoch=epoch)

    # --------------------------------------------------------------- post-hoc
    def posthoc_utility(self, epoch: Optional[int] = None) -> Dict:
        from gemm_gan_tpu_torch.cli.experiment import Experiment

        return Experiment.posthoc_utility(self, epoch)  # the same dump contract

    def posthoc_privacy(self, epoch: Optional[int] = None) -> Dict:
        from gemm_gan_tpu_torch.cli.experiment import Experiment

        return Experiment.posthoc_privacy(self, epoch)
