"""A training cell: the port's WGAN-GP engine over a `DeviceCache` bank,
epoch after epoch, as `cli.train` and `Experiment.fit` run it
(`WGANGPEngine.fit(scan_cache=...)`: `step_many_cached`, one CUDA graph of
the fused step replayed per batch).

Set-up, in this order, all of it timed as `setup_s`:

1. the bank (`traffic.make_bank`) and the weights (`init_params` of the
   architecture's reference), made on the device from sub-seeds of
   `--seed`;
2. the engine and its state, the benchmark's weights copied in;
3. the check's three steps: the same state through `step_many_cached` over
   a `DeviceCache` of one batch, whose rows are refilled in place before
   each call with eight more cases of the bank (24 distinct cases), so
   each call is one step of the window's call and feed; the state is kept
   on the host before the first step and after each (`snapshot`), and
   `check.py` compares it with the reference's;
4. the warm-up epoch: the cell's own first epoch, which captures the
   window's CUDA graph.

The window then runs whole epochs, as many as fit in `--seconds` judging
by the warm-up epoch's time and at least one, and ends in a synchronise.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import model
from perfbench.traffic import DTYPES, make_bank, steps_per_epoch

CHECK_STEPS = 3
RMSPROP_DECAY = 0.99  # the optimizer's second moment after one update is (1 - decay) g^2
# sub-seeds of the run's seed, one per use
SEED_WEIGHTS, SEED_BANK, SEED_DRAWS, SEED_DROPOUT, SEED_CACHE, SEED_CHECK_CACHE, \
    SEED_CHECK_ROWS, SEED_TRACE_CACHE = range(8)


def sub_seed(seed: int, use: int) -> int:
    """A 31-bit seed for one use, from the run's seed (any size)."""
    return int(np.random.SeedSequence([seed, use]).generate_state(1, np.uint32)[0] >> 1)


def port_config(cfg: dict):
    """The port's `ExperimentConfig` of a benchmark configuration file."""
    from gemm_gan_tpu_torch.config import variant_config

    ec = variant_config(cfg["architecture"], n_genes=cfg["model"]["n_genes"],
                        fusion_kw=dict(cfg["fusion"]))
    model = dataclasses.replace(ec.model, **{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in cfg["model"].items()})
    return dataclasses.replace(ec, model=model,
                               train=dataclasses.replace(ec.train, **cfg["train"]),
                               data=dataclasses.replace(ec.data, **cfg["data"]))


def snapshot(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The program's state as the check keeps it (`check.py`): each net's
    parameters and each optimizer's second moments by parameter name,
    copied to the host."""
    def host(pairs):
        return {k: v.detach().to("cpu", copy=True) for k, v in pairs}

    def moments(module, opt):
        names = {id(p): name for name, p in module.named_parameters()}
        return host((names[id(p)], nu) for p, nu in zip(opt.params, opt.nu))

    return {"gen": host(state.gen.named_parameters()),
            "critic": host(state.critic.named_parameters()),
            "ema": host(state.g_ema.named_parameters()) if state.g_ema is not None else {},
            "g_nu": moments(state.gen, state.g_opt), "d_nu": moments(state.critic, state.d_opt)}


class TrainCell:
    """One run of a training cell (see the module's docstring)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.B = cfg["train"]["batch_size"]
        self.steps_per_epoch = steps_per_epoch(cfg, traffic)
        self.seeds = {k: sub_seed(seed, k) for k in range(8)}
        self.dtype = DTYPES[cfg["model"]["compute_dtype"]]

    # ------------------------------------------------------------- set-up
    def _cache(self, data, seed):
        from gemm_gan_tpu_torch.data.device_cache import DeviceCache

        return DeviceCache(data, self.B, num_patches=self.traffic["num_patches"], seed=seed,
                           shuffle=True, embedding_store_dtype=DTYPES[self.traffic["store_dtype"]],
                           device=self.device)

    def _load_weights(self, state) -> None:
        with torch.no_grad():
            for module, weights in ((state.gen, self.weights["gen"]),
                                    (state.critic, self.weights["critic"]),
                                    (state.g_ema, self.weights["gen"])):
                own = dict(module.named_parameters())
                if set(own) != set(weights):
                    raise RuntimeError(f"the port's parameters differ from the benchmark's: "
                                       f"{sorted(set(own) ^ set(weights))[:6]}")
                for k, p in own.items():
                    p.copy_(weights[k])

    def setup(self, wrap: Callable = None, warm: bool = True) -> None:
        """Steps 1-4 of the module's docstring (without the warm-up epoch
        when not `warm`: the check alone). `wrap(engine)` may replace the
        engine's methods before the first step (the tests' faults)."""
        from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

        cfg, dev, B = self.cfg, self.device, self.B
        self.phases = {}
        t0 = time.perf_counter()
        bank = make_bank(cfg, self.traffic, self.seeds[SEED_BANK], dev)
        g = torch.Generator(device=dev).manual_seed(self.seeds[SEED_WEIGHTS])
        init = model(cfg["architecture"]).init_params
        self.weights = {net: init(cfg, net, g, dev) for net in ("gen", "critic")}
        # the check's rows: 3 x B distinct cases of the bank
        rows = np.random.RandomState(self.seeds[SEED_CHECK_ROWS]).permutation(
            self.traffic["cases"])[:CHECK_STEPS * B]
        self.check_rows = [{k: v[torch.as_tensor(rows[t * B:(t + 1) * B], device=dev)].clone()
                            for k, v in bank.items()} for t in range(CHECK_STEPS)]
        self.cache = self._cache(bank, self.seeds[SEED_CACHE])
        self.engine = WGANGPEngine(port_config(cfg), steps_per_epoch=len(self.cache), device=dev)
        if wrap is not None:
            wrap(self.engine)
        check_bank = {k: v.clone() for k, v in self.check_rows[0].items()}
        state = self.engine.init_state(self.seeds[SEED_DRAWS], check_bank)
        self._load_weights(state)
        self._sync()
        self.phases["bank, weights, engine"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.manual_seed(self.seeds[SEED_DROPOUT])
        self.state, self.check = self._check_steps(state, check_bank)
        self.phases["check steps"] = time.perf_counter() - t0
        self.bank = bank
        if warm:
            self.warm_epoch_s = self.phases["warm-up epoch"] = self._epochs(1, 0)

    def _check_steps(self, state, check_bank):
        check_cache = self._cache(check_bank, self.seeds[SEED_CHECK_CACHE])
        if any(check_cache.arrays[k] is not v for k, v in check_bank.items()):
            raise RuntimeError("the DeviceCache copied the check's bank; it cannot be refilled")
        losses: List[Dict[str, float]] = []
        snapshots = [snapshot(state)]
        self.check_step_s = []
        for t in range(CHECK_STEPS):
            t0 = time.perf_counter()
            for k, v in check_bank.items():
                v.copy_(self.check_rows[t][k])
            state, metrics = self.engine.step_many_cached(state, check_cache, epoch=t)
            losses.append({k: float(v) for k, v in metrics.items()})
            snapshots.append(snapshot(state))
            self._sync()
            self.check_step_s.append(time.perf_counter() - t0)
        del check_cache
        gc.collect()
        return state, {"losses": losses, "snapshots": snapshots}

    def _epochs(self, n: int, start: int, on_epoch_end: Optional[Callable] = None) -> float:
        """Run epochs [start, start + n); the seconds they took, ending in a
        synchronise."""
        self._sync()
        t0 = time.perf_counter()
        self.state = self.engine.fit(self.state, epochs=start + n, scan_cache=self.cache,
                                     start_epoch=start, on_epoch_end=on_epoch_end)
        self._sync()
        return time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- window
    def window_epochs(self, seconds: float) -> int:
        return max(1, int(seconds / self.warm_epoch_s))

    def window(self, n_epochs: int, on_epoch_end: Optional[Callable] = None) -> dict:
        """Epochs 1..n_epochs: {"seconds", "steps", "failed"}; a step of an
        epoch whose last losses are not finite counts as failed."""
        seconds = self._epochs(n_epochs, 1, on_epoch_end)
        bad = sum(1 for d, g in zip(self.engine.history["d_loss"], self.engine.history["g_loss"])
                  if not (np.isfinite(d) and np.isfinite(g)))
        steps = n_epochs * self.steps_per_epoch
        return {"seconds": seconds, "steps": steps, "failed": bad * self.steps_per_epoch}

    # -------------------------------------------------------------- trace
    def prepare_trace(self, steps: int) -> None:
        """A `--trace 1` run's own epochs: a `DeviceCache` over the bank's
        first `steps` x B cases (views, no copy), whose CUDA graph is
        captured here by one epoch, so that the traced epochs replay only."""
        self.trace_cache = self._cache({k: v[:steps * self.B] for k, v in self.bank.items()},
                                       self.seeds[SEED_TRACE_CACHE])
        self.state = self.engine.fit(self.state, epochs=1, scan_cache=self.trace_cache)
        self._sync()

    def traced_epochs(self, on_epoch_end: Callable, n: int = 2) -> dict:
        """`n` epochs of the trace's cache (the window's dict)."""
        self._sync()
        t0 = time.perf_counter()
        self.state = self.engine.fit(self.state, epochs=1 + n, scan_cache=self.trace_cache,
                                     start_epoch=1, on_epoch_end=on_epoch_end)
        self._sync()
        steps = n * len(self.trace_cache)
        return {"seconds": time.perf_counter() - t0, "steps": steps, "failed": 0,
                "steps_per_epoch": len(self.trace_cache)}

    def release(self) -> None:
        """Drop the program's state, bank and graphs."""
        for name in ("state", "engine", "cache", "bank", "trace_cache"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
