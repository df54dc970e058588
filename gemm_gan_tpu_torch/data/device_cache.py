"""Device-resident dataset caches with batch assembly on the card.

Counterpart of `gemm_gan_tpu/data/device_cache.py`: `DeviceCache` (the
whole bank on one device) and `ShardedDeviceCache` (the bank sharded over a
mesh's `data` axis, and optionally its patch axis over `model`; below). The whole
(padded) bank lives on the device once; every batch is a gather by index,
and the per-item patch subsampling runs on the device: fresh subsets every
step, as the reference's per-item resampling, with no host work.

Subsampling, as in the JAX package: U(0, 1) scores per patch slot, invalid
slots pushed to 2.0, the `num_patches` smallest taken (a uniform random
subset without replacement among the valid slots; slots past a case's valid
count come out masked and zeroed). torch's generators cannot give
`jax.random`'s bits, so the scores are the port's own: each epoch's, for all
its batches at once ([batches, B, P]), from a generator keyed on (seed,
epoch). The eager `epoch(e)` and the graphed epoch of
`WGANGPEngine.step_many_cached` read the same scores, and a resumed run
sees the batches of the uninterrupted one. The epoch's order is numpy's
`RandomState(seed + e).permutation`, as in the JAX package, so it matches
the JAX cache exactly.

`embedding_store_dtype` (e.g. `torch.bfloat16`) stores the large float
embedding banks (patches, tokens, text_emb) narrow; batches always leave the
cache in float32 (subsampled first, then widened). Gene expression, masks
and labels are stored exactly (floating arrays as float32).
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.utils import threefry
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device

NARROWABLE = ("patches", "tokens", "text_emb")


def subsample_patches(patches: torch.Tensor, mask: torch.Tensor, scores: torch.Tensor,
                      num_patches: int):
    """(sub [B, num_patches, D], sub_mask [B, num_patches]): per item the
    `num_patches` slots of smallest score among the valid ones (invalid
    slots score 2.0), in ascending order of score; unselected or invalid
    slots are zeroed. `patches` [B, P, D] keeps its dtype."""
    sel = torch.topk(torch.where(mask, scores, 2.0), num_patches, dim=1,
                     largest=False).indices
    sub = torch.gather(patches, 1, sel[..., None].expand(-1, -1, patches.shape[-1]))
    sub_mask = torch.gather(mask, 1, sel)
    return sub * sub_mask[..., None], sub_mask


def assemble_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                   scores: Optional[torch.Tensor], num_patches: Optional[int],
                   narrowed: frozenset) -> Dict[str, torch.Tensor]:
    """One batch of the bank `arrays`: rows `idx` [B] (a device tensor),
    patches subsampled with `scores` [B, P] when given, narrowed arrays
    widened to float32 after the subsampling."""
    batch = {k: a.index_select(0, idx) for k, a in arrays.items()}
    if scores is not None:
        # subsample before widening: the gathered full-width rows dwarf the
        # subset
        batch["patches"], batch["patch_mask"] = subsample_patches(
            batch["patches"], batch["patch_mask"], scores, num_patches)
    for k in narrowed:
        batch[k] = batch[k].float()
    return batch


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s subsampling scores."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0])


class DeviceCache:
    """Device-resident analogue of `Batches` (same epoch/iter contract):
    `epoch(e)` yields dicts of tensors on `device`."""

    def __init__(self, data: Dict[str, object], batch_size: int,
                 num_patches: Optional[int] = None, seed: int = 42,
                 shuffle: bool = True, drop_remainder: bool = True,
                 embedding_store_dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        """`data`: numpy arrays or tensors (tensors already on the device
        are not copied through the host), all of one length."""
        self.device = resolve_device(device)
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"length mismatch for {k}: {len(v)} vs {n}")
        self._narrowed = frozenset(k for k in NARROWABLE if k in data
                                   and embedding_store_dtype is not None)

        def prep(k, v):
            t = torch.as_tensor(v, device=self.device)
            if k in self._narrowed:
                return t.to(embedding_store_dtype)
            return t.float() if t.is_floating_point() else t

        self.arrays = {k: prep(k, v) for k, v in data.items()}
        self.n = n
        self.batch_size = batch_size
        self.num_patches = num_patches
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self.resample = (num_patches is not None and "patches" in self.arrays
                         and self.arrays["patches"].shape[1] > num_patches)
        # pure assembler over (arrays, idx, scores), for callers that run
        # the gather inside their own step (`WGANGPEngine.step_many_cached`);
        # it holds no reference to the cache
        self.assemble_fn = functools.partial(assemble_batch, num_patches=num_patches,
                                             narrowed=self._narrowed)

    def seek(self, epoch: int):
        """Position the no-arg `epoch()` stream at `epoch` (resume support:
        the next call yields that epoch's deterministic batches)."""
        self._epoch = epoch

    def __len__(self):
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    @property
    def n_full_batches(self) -> int:
        """Full-size batches per epoch (leading axis of `stacked_epoch`);
        0 means the stacked paths are unusable: use the per-batch path."""
        return self.n // self.batch_size

    def _next_epoch(self, epoch: Optional[int]) -> int:
        e = self._epoch if epoch is None else epoch
        if epoch is None:
            self._epoch += 1
        return e

    def _order(self, e: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + e).permutation(idx)
        return idx

    def _scores(self, e: int) -> Optional[torch.Tensor]:
        """Epoch `e`'s subsampling scores [len(self), B, P] (None without
        resampling), drawn on the device."""
        if not self.resample:
            return None
        g = torch.Generator(device=self.device).manual_seed(epoch_seed(self.seed, e))
        P = self.arrays["patches"].shape[1]
        return torch.rand(len(self), self.batch_size, P, generator=g, device=self.device)

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
        e = self._next_epoch(epoch)
        idx = torch.as_tensor(self._order(e), device=self.device)
        scores = self._scores(e)
        stop = (self.n // self.batch_size) * self.batch_size \
            if self.drop_remainder else self.n
        for i, s in enumerate(range(0, stop, self.batch_size)):
            take = idx[s:s + self.batch_size]
            yield self.assemble_fn(self.arrays, take,
                                   None if scores is None else scores[i, :len(take)])

    def __iter__(self):
        return self.epoch()

    def epoch_spec(self, epoch: Optional[int] = None):
        """(idx [K, B] int64, scores [K, B, P] or None), on the device, for
        one epoch's full-size batches: the small inputs behind
        `stacked_epoch`'s gather, which `WGANGPEngine.step_many_cached`
        copies into its graph. The same batches as `epoch(e)`; a ragged
        final batch is dropped here whatever `drop_remainder` says."""
        if self.n_full_batches == 0:
            raise ValueError(
                f"the stacked paths need at least one full batch "
                f"(n={self.n}, batch_size={self.batch_size}); "
                "use the per-batch epoch() path")
        e = self._next_epoch(epoch)
        K = self.n_full_batches
        idx = self._order(e)[:K * self.batch_size].reshape(K, self.batch_size)
        scores = self._scores(e)
        return (torch.as_tensor(idx, device=self.device),
                None if scores is None else scores[:K].contiguous())

    def stacked_epoch(self, epoch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Whole epoch as one [K, B, ...] stack on the device (for
        `WGANGPEngine.step_many`). Holds every batch of the epoch at once;
        `step_many_cached` gathers each inside the step instead."""
        idx, scores = self.epoch_spec(epoch)
        batches = [self.assemble_fn(self.arrays, idx[k], None if scores is None else scores[k])
                   for k in range(len(idx))]
        return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


class ShardedDeviceCache:
    """`DeviceCache` with the bank SHARDED over the mesh's `data` axis.

    Counterpart of `gemm_gan_tpu/data/device_cache.py::ShardedDeviceCache`.
    Every rank passes the same global `data`; the case axis is cut into
    `data`-axis shards of n // S cases (surplus cases dropped, as JAX's
    equal shards), and each rank keeps its own shard on its device: per-rank
    residency is bank / S, and every gather is local to the shard.

    Sampling contract (the JAX package's, bit for bit: `utils.threefry`
    gives `jax.random`'s streams): each data shard draws a fresh
    without-replacement permutation of ITS OWN cases per epoch (key =
    fold_in(fold_in(key(seed), epoch), shard)), so a global batch is S
    stacked per-shard blocks of batch_size / S cases; batch k's patch
    subsampling draws U(0, 1) scores with key fold_in(fold_in(epoch key,
    k), shard) (then folded with the `model` index under
    `shard_patches`).

    `shard_patches=True` also shards the PATCH axis of `patches` /
    `patch_mask` over the mesh's `model` axis: each rank keeps its W / M
    slots, subsamples num_patches / M of them with its own key (a
    stratified-by-shard subset, as JAX's), and the batch's patches are
    all-gathered over `model` after the gather, so a batch leaves the cache
    as the engine consumes it: this rank's rows, every patch slot.

    `epoch(e)` yields this rank's batches; `epoch_spec(e)` the epoch's
    local index table and scores for `WGANGPEngine.step_many_cached`, whose
    graph gathers with `assemble_fn`."""

    def __init__(self, data: Dict[str, object], batch_size: int, mesh,
                 num_patches: Optional[int] = None, seed: int = 42,
                 embedding_store_dtype: Optional[torch.dtype] = None,
                 shard_patches: bool = False):
        self.mesh = mesh
        self.device = mesh.device
        S = int(mesh.shape["data"])
        M = int(mesh.shape["model"]) if shard_patches else 1
        self.shard_patches = shard_patches and M > 1
        if shard_patches:
            if "patches" not in data:
                raise ValueError("shard_patches=True needs a 'patches' array")
            W = data["patches"].shape[1]
            if W % M:
                raise ValueError(
                    f"patch width {W} not divisible by model axis {M}; pad "
                    "the bank (patch_mask False on the padding)")
            if num_patches is not None and num_patches % M:
                raise ValueError(
                    f"num_patches {num_patches} not divisible by model "
                    f"axis {M} (shard-local subsampling draws "
                    "num_patches/M per shard)")
        if batch_size % S:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"data axis size {S}")
        self.batch_size = batch_size
        self.b_shard = batch_size // S
        self.num_patches = num_patches
        self.seed = seed
        self._epoch = 0
        self._key = threefry.key(seed)
        n_in = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n_in:
                raise ValueError(f"length mismatch for {k}: {len(v)} vs {n_in}")
        self.n = (n_in // S) * S
        self.n_shard = self.n // S
        if self.n_shard < self.b_shard:
            raise ValueError(
                f"{self.n_shard} cases per shard < per-shard batch "
                f"{self.b_shard} (n={self.n}, data={S})")
        self._narrowed = frozenset(k for k in NARROWABLE if k in data
                                   and embedding_store_dtype is not None)
        d, m = mesh.index("data"), mesh.index("model")
        rows = slice(d * self.n_shard, (d + 1) * self.n_shard)

        def prep(k, v):
            t = torch.as_tensor(v[rows])
            if self.shard_patches and k in ("patches", "patch_mask"):
                w = t.shape[1] // M
                t = t[:, m * w:(m + 1) * w]
            t = t.to(self.device)
            if k in self._narrowed:
                return t.to(embedding_store_dtype)
            return t.float() if t.is_floating_point() else t

        self.arrays = {k: prep(k, v) for k, v in data.items()}
        self.resample = (num_patches is not None and "patches" in data
                         and data["patches"].shape[1] > num_patches)
        self.local_num_patches = (num_patches // M if (self.resample and self.shard_patches)
                                  else num_patches)
        self.assemble_fn = functools.partial(
            _assemble_sharded, num_patches=self.local_num_patches,
            narrowed=self._narrowed, mesh=mesh if self.shard_patches else None)

    def seek(self, epoch: int):
        self._epoch = epoch

    def _next_epoch(self, epoch: Optional[int]) -> int:
        e = self._epoch if epoch is None else epoch
        if epoch is None:
            self._epoch += 1
        return e

    def epoch_base_key(self, epoch: int):
        """The epoch's key (drives the per-shard permutations and the
        subsampling keys)."""
        return threefry.fold_in(self._key, epoch)

    def __len__(self):
        return self.n_shard // self.b_shard

    @property
    def n_full_batches(self) -> int:
        return len(self)

    def epoch_spec(self, epoch: Optional[int] = None):
        """(idx [K, b_shard] int64 into this rank's bank, scores [K,
        b_shard, local patch width] or None), on the device: this rank's
        part of every batch of the epoch."""
        e = self._next_epoch(epoch)
        ekey = self.epoch_base_key(e)
        d = self.mesh.index("data")
        K, b = len(self), self.b_shard
        perm = threefry.permutation(threefry.fold_in(ekey, d), self.n_shard)
        idx = perm[:K * b].reshape(K, b)
        scores = None
        if self.resample:
            width = self.arrays["patches"].shape[1]
            keys = [threefry.fold_in(threefry.fold_in(ekey, k), d) for k in range(K)]
            if self.shard_patches:
                keys = [threefry.fold_in(bk, self.mesh.index("model")) for bk in keys]
            scores = torch.from_numpy(np.stack([threefry.uniform(bk, (b, width))
                                                for bk in keys])).to(self.device)
        return torch.as_tensor(idx, device=self.device), scores

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
        idx, scores = self.epoch_spec(epoch)
        for k in range(len(idx)):
            yield self.assemble_fn(self.arrays, idx[k], None if scores is None else scores[k])

    def __iter__(self):
        return self.epoch()


def _assemble_sharded(arrays, idx, scores, num_patches, narrowed, mesh):
    """`assemble_batch` on this rank's shard; with `mesh` (shard_patches)
    the patches and their mask are then all-gathered over `model`."""
    batch = assemble_batch(arrays, idx, scores, num_patches, narrowed)
    if mesh is not None:
        from gemm_gan_tpu_torch.parallel import comm

        for k in ("patches", "patch_mask"):
            batch[k] = comm.all_gather(batch[k], mesh, "model", dim=1)
    return batch
