"""Host batch iterator over an in-memory dataset dict.

A copy of `gemm_gan_tpu/data/loader.py::Batches` (numpy only), kept here so
the port imports nothing of the JAX package; the same data and seed give
the same batches. The full embedding set is preloaded once (host RAM, or
the card through `data.device_cache.DeviceCache`) and batches are index
gathers, where the reference re-read each case's patch file on every item.

Epoch shuffling is seeded per epoch (bitwise reproducible); for multi-host
runs each process iterates its own shard of the index space.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional
import warnings

import numpy as np


class Batches:
    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 42, shuffle: bool = True, drop_remainder: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 shard_mode: str = "strided"):
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"length mismatch for {k}: {len(v)} vs {n}")
        if shard_mode not in ("strided", "batch"):
            raise ValueError(f"unknown shard_mode {shard_mode!r}")
        if process_count > 1 and not drop_remainder:
            # every process must contribute EQUAL rows to each assembled
            # global batch, so per-epoch rows that don't split evenly across
            # processes are dropped even with drop_remainder=False — warn
            # once instead of silently diverging from the single-process
            # stream
            dropped = ((n % (batch_size * process_count)) % process_count
                       if shard_mode == "batch" else n % process_count)
            if dropped:
                warnings.warn(
                    f"Batches: {dropped} of {n} rows per epoch cannot split "
                    f"evenly across {process_count} processes and are "
                    f"dropped despite drop_remainder=False (shard_mode="
                    f"{shard_mode!r}); multi- vs single-process epoch "
                    "streams differ by those rows", stacklevel=2)
        self.data = data
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.process_index = process_index
        self.process_count = process_count
        # "strided": process p iterates idx[p::count] — balanced, but the
        #   assembled global batch interleaves the epoch stream.
        # "batch": process p takes the p-th CONTIGUOUS block of each global
        #   batch of batch_size*count rows, so the assembled global batch
        #   ([proc0 rows, proc1 rows, ...]) is IDENTICAL to the batch a
        #   single-process loader with batch_size*count would yield. A
        #   ragged epoch tail is truncated to the largest multiple of
        #   process_count; the < process_count leftover rows are dropped
        #   with a constructor warning.
        self.shard_mode = shard_mode
        self._epoch = 0

    def seek(self, epoch: int):
        """Position the no-arg `epoch()` stream at `epoch` (resume support:
        the next call yields that epoch's deterministic batch order)."""
        self._epoch = epoch

    def __len__(self):
        if self.shard_mode == "batch" and self.process_count > 1:
            global_b = self.batch_size * self.process_count
            full = self.n // global_b
            if self.drop_remainder:
                return full
            tail = self.n - full * global_b
            return full + (1 if tail >= self.process_count else 0)
        per_host = self.n // self.process_count
        if self.drop_remainder:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        e = self._epoch if epoch is None else epoch
        if epoch is None:
            self._epoch += 1
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + e)
            idx = rng.permutation(idx)
        if self.shard_mode == "batch" and self.process_count > 1:
            global_b = self.batch_size * self.process_count
            full = self.n // global_b
            for k in range(full):
                s = k * global_b + self.process_index * self.batch_size
                take = idx[s:s + self.batch_size]
                yield {k2: v[take] for k2, v in self.data.items()}
            tail = idx[full * global_b:]
            t = len(tail) // self.process_count
            if not self.drop_remainder and t:
                # equal per-process tail slices; < process_count leftover
                # rows are dropped (warned at construction)
                take = tail[self.process_index * t:(self.process_index + 1) * t]
                yield {k2: v[take] for k2, v in self.data.items()}
            return
        # equal-length shards: every process yields the SAME batch structure
        # (count and sizes), so assembled global batches always line up
        idx = idx[self.process_index::self.process_count]
        idx = idx[: self.n // self.process_count]
        stop = (len(idx) // self.batch_size) * self.batch_size if self.drop_remainder else len(idx)
        for s in range(0, stop, self.batch_size):
            take = idx[s:s + self.batch_size]
            yield {k: v[take] for k, v in self.data.items()}

    def __iter__(self):
        return self.epoch()

    @property
    def n_full_batches(self) -> int:
        """Full-size batches per epoch — the length of `stacked_epoch`'s
        leading axis. 0 means the stacked path is unusable (dataset smaller
        than one batch); callers should take the per-batch path."""
        if self.shard_mode == "batch" and self.process_count > 1:
            return self.n // (self.batch_size * self.process_count)
        return (self.n // self.process_count) // self.batch_size

    def stacked_epoch(self, epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One epoch's batches stacked on a leading axis [K, B, ...] for the
        engine's `step_many`. A ragged final batch (drop_remainder=False)
        cannot stack and is dropped here."""
        if self.n_full_batches == 0:
            raise ValueError(
                f"stacked_epoch needs at least one full batch "
                f"(n={self.n}, batch_size={self.batch_size}); "
                "use the per-batch epoch() path")
        batches = [b for b in self.epoch(epoch)
                   if len(next(iter(b.values()))) == self.batch_size]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def subset(self, keys) -> "Batches":
        return Batches({k: self.data[k] for k in keys}, self.batch_size,
                       self.seed, self.shuffle, self.drop_remainder,
                       self.process_index, self.process_count,
                       self.shard_mode)
