"""A generate cell: the port's sampling entry making a synthetic cohort,
one call a pass, as `cli.sample --scan` and the product run's
regeneration of a split call it: `WGANGPEngine.generate_samples_all(state,
batches, num_repeats, generator, scan=True)` on an engine's state. Each
call serves the state's EMA generator through a server of its own
(`GeneratorServer.sample_all`), which captures its CUDA graph of the
condition embedding and the scores (`_SampleGraph`) at the call's first
batch and replays it for the others, so every pass pays the capture that
every call pays. The caller receives the profiles on the host, each
batch's fetched as numpy and the call's concatenated, as `cli.sample`
writes them (`generate_samples_all`'s default fetch).

Set-up, in this order, all of it timed as `setup_s`:

1. the bank (`traffic.make_bank`) and the generator's weights
   (`init_params` of the architecture's reference), made on the device
   from sub-seeds of `--seed`;
2. the engine and its state, the weights copied into the state's EMA
   generator (the one `generate_samples_all` serves; the trained
   generator keeps its own initial weights);
3. two warm-up calls over the bank: the first loads the kernels and fills
   the allocators with the profiles' memory; the second runs as a call of
   the window does and gives the window's number of calls.

The window then runs whole calls over the bank, as many as fit in
`--seconds` judging by the second warm-up call, at least one: the bank's
batches in order, z drawn batch-major from one device generator seeded
from `--seed` and passed from call to call. The profiles of a few batches
are kept for the check (`generate_check.py`): the window's first and
last, and more drawn from the seed, `CHECKED_ROWS` cases in all.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from perfbench.reference import model
from perfbench.train_cell import port_config, sub_seed
from perfbench.traffic import make_bank

CONDITIONING = ("tokens", "token_mask", "patches", "patch_mask")
CHECKED_ROWS = 256  # cases whose profiles the check compares: whole batches, as many as hold them
# sub-seeds of the run's seed, one per use
SEED_WEIGHTS, SEED_BANK, SEED_WARM_Z, SEED_WINDOW_Z, SEED_PICKS, SEED_TRACE_Z, \
    SEED_STATE = range(7)

Pick = Tuple[int, int]  # (call, batch) of the window


class GenerateCell:
    """One run of a generate cell (see the module's docstring)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.B, self.R = traffic["batch_size"], traffic["num_repeats"]
        self.n_batches = -(-traffic["cases"] // self.B)
        self.seeds = {k: sub_seed(seed, k) for k in range(7)}

    # ------------------------------------------------------------- set-up
    def setup(self, wrap: Optional[Callable] = None) -> None:
        """Steps 1-3 of the module's docstring. `wrap(server)` may replace
        the methods of each server the engine makes, before its first batch
        (the tests' faults)."""
        from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

        cfg, dev = self.cfg, self.device
        self.phases = {}
        t0 = time.perf_counter()
        self.bank = make_bank(cfg, self.traffic, self.seeds[SEED_BANK], dev)
        g = torch.Generator(device=dev).manual_seed(self.seeds[SEED_WEIGHTS])
        self.weights = model(cfg["architecture"]).init_params(cfg, "gen", g, dev)
        self.engine = WGANGPEngine(port_config(cfg), device=dev)
        sample = {k: v[:cfg["train"]["batch_size"]] for k, v in self.bank.items()}
        self.state = self.engine.init_state(self.seeds[SEED_STATE], sample)
        if self.state.g_ema is None:
            raise RuntimeError("the configuration keeps no EMA generator (train.ema_decay)")
        own = dict(self.state.g_ema.named_parameters())
        if set(own) != set(self.weights):
            raise RuntimeError(f"the port's parameters differ from the benchmark's: "
                               f"{sorted(set(own) ^ set(self.weights))[:6]}")
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(self.weights[k])
        if wrap is not None:
            make = self.engine._sampler

            def sampler(state, use_ema):
                server = make(state, use_ema)
                wrap(server)
                return server

            self.engine._sampler = sampler
        self._sync()
        self.phases["bank, weights, engine"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = self._call(self._z(SEED_WARM_Z))
        if len(warm["fake"]) != self.R * self.traffic["cases"]:
            raise RuntimeError(f"the warm-up call returned {len(warm['fake'])} profiles")
        del warm
        self._sync()
        self.phases["first warm-up call"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._call(self._z(SEED_WARM_Z))
        self._sync()
        self.call_s = self.phases["second warm-up call"] = time.perf_counter() - t0

    def _z(self, use: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seeds[use])

    def batches(self, span: Optional[str] = None):
        """The bank's batches in order, each a dict of views of its
        conditioning. `span`: each batch's handling by the caller inside a
        profiler span of that name (it opens when the batch is handed
        over and closes when the next is asked for)."""
        for s in range(0, self.traffic["cases"], self.B):
            batch = {k: self.bank[k][s:s + self.B] for k in CONDITIONING}
            if span is None:
                yield batch
            else:
                with torch.profiler.record_function(span):
                    yield batch

    def _call(self, z: torch.Generator, span: Optional[str] = None) -> dict:
        """One call of the sampling entry over the bank, as a user makes it."""
        return self.engine.generate_samples_all(self.state, lambda: self.batches(span), self.R,
                                                z, scan=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- window
    def window_calls(self, seconds: float) -> int:
        return max(1, int(seconds / self.call_s))

    def picks(self, n_calls: int) -> List[Pick]:
        """The window's batches whose profiles the check compares: the
        first, the last, and others drawn from the seed, all distinct, till
        they hold `CHECKED_ROWS` cases (or every batch of the window)."""
        total = n_calls * self.n_batches
        want = min(total, max(2, -(-CHECKED_ROWS // self.B)))
        ends = {0, total - 1}
        rest = np.random.RandomState(self.seeds[SEED_PICKS]).permutation(total)
        drawn = [int(i) for i in rest if i not in ends][:want - len(ends)]
        return sorted(divmod(i, self.n_batches) for i in ends | set(drawn))

    def rows(self, fake: np.ndarray, batch: int) -> np.ndarray:
        """[R, rows, n_genes]: a copy of a batch's profiles, every repeat,
        out of a call's repeat-major `fake`."""
        n, s = self.traffic["cases"], batch * self.B
        return np.stack([fake[r * n + s:r * n + min(s + self.B, n)] for r in range(self.R)])

    def window(self, n_calls: int) -> dict:
        """`n_calls` calls: {"seconds", "samples", "failed", "batches",
        "kept": {pick: profiles as numpy}}. The clock stops when the last
        call's profiles have landed where the caller receives them (a
        synchronise); a profile asked for and not returned counts as
        failed."""
        picks = self.picks(n_calls)
        z = self._z(SEED_WINDOW_Z)
        kept = {}
        returned = 0
        self._sync()
        t0 = time.perf_counter()
        for p in range(n_calls):
            fake = self._call(z)["fake"]
            returned += len(fake)
            for pick in picks:
                if pick[0] == p:
                    kept[pick] = self.rows(fake, pick[1])
            del fake
        self._sync()
        seconds = time.perf_counter() - t0
        asked = n_calls * self.R * self.traffic["cases"]
        return {"seconds": seconds, "samples": returned, "failed": asked - returned,
                "batches": n_calls * self.n_batches, "kept": kept}

    # -------------------------------------------------------------- trace
    def traced_call(self, span: str) -> int:
        """One call, each batch inside `span`; its batches."""
        self._call(self._z(SEED_TRACE_Z), span=span)
        self._sync()
        return self.n_batches

    # -------------------------------------------------------------- check
    def check_inputs(self, picks: List[Pick]) -> dict:
        """What the reference gets: the weights, each picked batch's
        conditioning (a copy of the bank's rows), and where its z lies
        among the window's draws."""
        conds = {}
        for _, b in picks:
            if b not in conds:
                s = b * self.B
                conds[b] = {k: self.bank[k][s:s + self.B].clone() for k in CONDITIONING}
        return {"weights": self.weights, "conds": conds, "z_seed": self.seeds[SEED_WINDOW_Z],
                "batches_per_pass": self.n_batches, "rows": self.B, "repeats": self.R,
                "latent_dim": self.cfg["model"]["latent_dim"]}

    def release(self) -> None:
        """Drop the program's engine, state and bank."""
        self.engine = self.state = self.bank = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
