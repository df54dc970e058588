"""The port's data layer (gemm_gan_tpu_torch.data) vs the JAX package's.

`splits`, `loader.Batches` and `tcga.load_tcga` are numpy copies: on the
same inputs they must give the same arrays, bit for bit. `DeviceCache` runs
here on the CPU (`device="cpu"`): its epoch order and its bf16 store are
held bit for bit to the JAX cache's; its subsampling, handed the scores the
JAX cache draws, selects the same slots. The data dirs are built in tmp.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gemm_gan_tpu.data import device_cache as jcache
from gemm_gan_tpu.data import loader as jloader
from gemm_gan_tpu.data import splits as jsplits
from gemm_gan_tpu.data import tcga as jtcga
from gemm_gan_tpu_torch.data import device_cache as tcache
from gemm_gan_tpu_torch.data import loader as tloader
from gemm_gan_tpu_torch.data import splits as tsplits
from gemm_gan_tpu_torch.data import tcga as ttcga
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset


def _equal(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            _equal(g[k], w[k], f"batch {i}, {k}")


# ----------------------------------------------------------------- splits
@pytest.mark.parametrize("n,seed", [(1000, 42), (100, 7), (37, 0)])
def test_split_indices_match_jax(n, seed):
    got, want = tsplits.split_indices(n, seed=seed), jsplits.split_indices(n, seed=seed)
    for g, w in zip(got, want):
        _equal(g, w)
    if n == 1000:
        assert [len(x) for x in got] == [640, 160, 200]
    _equal(np.sort(np.concatenate(got)), np.arange(n))


def test_normalizations_match_jax(rng):
    train = rng.randn(50, 6).astype(np.float32)
    train[:, 3] = 2.0  # constant gene -> 0
    others = (rng.randn(20, 6).astype(np.float32), rng.rand(10, 6).astype(np.float32))
    for fn in ("standardize", "minmax"):
        (got, got_stats), (want, want_stats) = (getattr(m, fn)(train, *others)
                                                for m in (tsplits, jsplits))
        for g, w in zip(got + got_stats, want + want_stats):
            _equal(g, w, fn)
        _equal(got[0][:, 3], np.zeros(50))
    x = np.zeros((10, 3), np.float32)
    x[:, 0], x[0, 1] = 1.0, 1.0  # 0% and 90% zeros kept, 100% dropped
    for g, w in zip(tsplits.drop_mostly_zero_genes(x), jsplits.drop_mostly_zero_genes(x)):
        _equal(g, w)
    _equal(tsplits.drop_mostly_zero_genes(x)[1], [True, True, False])


# ----------------------------------------------------------------- Batches
@pytest.mark.parametrize("n,kw", [
    (48, dict(batch_size=8, seed=5)),
    (48, dict(batch_size=7, seed=0)),
    (47, dict(batch_size=4, seed=3, drop_remainder=False, shuffle=False,
              process_index=1, process_count=2)),
    (43, dict(batch_size=4, seed=0, drop_remainder=False, process_index=0,
              process_count=2, shard_mode="batch")),
    (43, dict(batch_size=4, seed=0, drop_remainder=False, process_index=1,
              process_count=2, shard_mode="batch")),
])
def test_batches_match_jax(n, kw, tiny_data):
    data = {k: v[:n] for k, v in tiny_data.items()}
    warned = []
    for module in (tloader, jloader):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            warned.append((module.Batches(data, **kw), [str(x.message) for x in w]))
    (got, got_warned), (want, want_warned) = warned
    assert got_warned == want_warned
    assert len(got) == len(want) and got.n_full_batches == want.n_full_batches
    for e in (0, 1):
        _same_batches(got.epoch(e), want.epoch(e))
    got.seek(3)
    want.seek(3)
    _same_batches(got.epoch(), want.epoch())
    a, b = got.stacked_epoch(2), want.stacked_epoch(2)
    assert a.keys() == b.keys()
    for k in a:
        _equal(a[k], b[k], k)


def test_batches_epochs_differ_and_tiny_split_guard(tiny_data):
    loader = tloader.Batches(tiny_data, batch_size=8, seed=5)
    first = [next(iter(loader.epoch(e)))["genes"] for e in (0, 0, 1)]
    _equal(first[0], first[1])
    assert not np.array_equal(first[0], first[2])
    small = tloader.Batches({k: v[:3] for k, v in tiny_data.items()}, batch_size=8)
    assert small.n_full_batches == 0
    with pytest.raises(ValueError):
        small.stacked_epoch(0)


# ----------------------------------------------------------------- load_tcga
N_CASES, N_GENES, PATCH_DIM, TEXT_DIM, TOKENS = 30, 40, 16, 12, 6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The layout of tests/test_load_tcga.py's fixture, built in tmp."""
    d = tmp_path_factory.mktemp("tcga_port")
    rng = np.random.RandomState(0)
    cases = [f"case-{i:03d}" for i in range(N_CASES)]
    expr = rng.rand(N_CASES, N_GENES) * 8
    expr[:, -3:] = 0.0
    pd.DataFrame(expr, index=pd.Index(cases, name="case_id"),
                 columns=[f"ENSG{i:05d}" for i in range(N_GENES)]
                 ).to_parquet(os.path.join(d, "rna_seq.parquet"))
    cls = pd.DataFrame(rng.randn(N_CASES, TEXT_DIM).astype(np.float32),
                       index=pd.Index(cases, name="case_id"))
    cls.columns = [str(c) for c in cls.columns]
    cls.to_parquet(os.path.join(d, "clinical_modernbert_embeddings.parquet"))
    pdir = os.path.join(d, "patch_embeddings_uni")
    tdir = os.path.join(d, "clinical_modernbert_embeddings")
    os.makedirs(pdir)
    os.makedirs(tdir)
    for c in cases:
        np.save(os.path.join(pdir, f"{c}.npy"),
                rng.randn(rng.randint(2, 12), PATCH_DIM).astype(np.float32))
        np.save(os.path.join(tdir, f"{c}.npy"), rng.randn(TOKENS, TEXT_DIM).astype(np.float32))
        np.save(os.path.join(tdir, f"{c}_attention_mask.npy"),
                np.arange(TOKENS) < rng.randint(2, TOKENS + 1))
    metainfos = {c: {"disease_type": ["Adeno", "Squamous", "Glioma"][i % 3],
                     "primary_site": ["Lung", "Brain"][i % 2]} for i, c in enumerate(cases)}
    with open(os.path.join(d, "metainfos.pkl"), "wb") as f:
        pickle.dump(metainfos, f)
    return str(d)


@pytest.mark.parametrize("kw", [
    dict(schema="genes"),
    dict(schema="genes", normalization="minmax", seed=7),
    dict(schema="multi_patch", num_patches=8),
    dict(schema="multi_patch", num_patches=4, patch_bank=True),
    dict(schema="multi_token", num_patches=8, max_tokens=TOKENS),
    dict(schema="labels"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_load_tcga_matches_jax(kw, data_dir):
    got = ttcga.load_tcga(data_dir, **kw)
    want = jtcga.load_tcga(data_dir, **kw)
    assert got.keys() == want.keys()
    for split in ("train", "val", "test"):
        assert got[split].keys() == want[split].keys()
        for k in want[split]:
            assert got[split][k].dtype == want[split][k].dtype, (split, k)
            _equal(got[split][k], want[split][k], f"{split}/{k}")
    for k in ("case_ids", "gene_names", "n_genes", "disease_vocab", "site_vocab"):
        _equal(got["meta"][k], want["meta"][k], k)
    for k in want["meta"]["split_indices"]:
        _equal(got["meta"]["split_indices"][k], want["meta"]["split_indices"][k], k)
    assert got["meta"]["n_genes"] == N_GENES - 3
    if kw.get("patch_bank"):
        assert got["train"]["patches"].shape[1] > 4


# ----------------------------------------------------------------- DeviceCache
def _bank(rng, n=24, P=16, D=8):
    lens = rng.randint(1, P + 1, n)
    mask = np.arange(P)[None, :] < lens[:, None]
    return {"genes": rng.randn(n, 6).astype(np.float32),
            "patches": rng.randn(n, P, D).astype(np.float32) * mask[..., None],
            "patch_mask": mask, "disease": rng.randint(0, 3, n).astype(np.int32)}


@pytest.mark.parametrize("shuffle,drop_remainder", [(True, True), (False, False)])
def test_device_cache_epoch_matches_jax_without_resampling(shuffle, drop_remainder):
    data = _bank(np.random.RandomState(1), n=27)
    kw = dict(batch_size=8, seed=3, shuffle=shuffle, drop_remainder=drop_remainder)
    got = tcache.DeviceCache(data, device="cpu", **kw)
    want = jcache.DeviceCache(data, **kw)
    assert len(got) == len(want) and got.n_full_batches == want.n_full_batches
    _same_batches(got.epoch(5), want.epoch(5))
    _same_batches(got.epoch(5), tloader.Batches(data, **kw).epoch(5))
    idx, scores = got.epoch_spec(2)
    _equal(idx, np.asarray(want.epoch_spec(2)[0]))
    assert scores is None
    stacked, jstacked = got.stacked_epoch(2), want.stacked_epoch(2)
    for k in jstacked:
        _equal(stacked[k], jstacked[k], k)


def test_device_cache_bf16_store_matches_jax():
    data = synthetic_dataset(n=24, n_genes=12, num_patches=8, patch_dim=16,
                             num_tokens=6, text_dim=12, seed=3)
    got = tcache.DeviceCache(data, batch_size=8, seed=0, embedding_store_dtype=torch.bfloat16,
                             device="cpu")
    want = jcache.DeviceCache(data, batch_size=8, seed=0, embedding_store_dtype=jnp.bfloat16)
    for k in ("patches", "tokens", "text_emb"):
        assert got.arrays[k].dtype == torch.bfloat16
    assert got.arrays["genes"].dtype == torch.float32
    assert got.arrays["patch_mask"].dtype == torch.bool
    for g, w in zip(got.epoch(1), want.epoch(1)):
        for k in w:
            if w[k].dtype == jnp.float32:
                assert g[k].dtype == torch.float32, k
            _equal(g[k], w[k], k)  # bf16 values widened to f32: the same bits


def test_subsample_selects_the_jax_slots_from_its_scores():
    """Handed the U(0, 1) scores `_subsample_patches` draws from its key,
    the port's selection gives the same subset, order, zeroing and mask."""
    data = _bank(np.random.RandomState(2), n=8, P=16)
    key = jax.random.key(0)
    for num in (4, 16):
        want = jcache._subsample_patches(jnp.asarray(data["patches"]),
                                         jnp.asarray(data["patch_mask"]), key, num)
        scores = np.asarray(jax.random.uniform(key, data["patch_mask"].shape))
        got = tcache.subsample_patches(torch.from_numpy(data["patches"]),
                                       torch.from_numpy(data["patch_mask"]),
                                       torch.from_numpy(scores.copy()), num)
        for g, w in zip(got, want):
            _equal(g, w, f"num {num}")


def test_subsample_selects_only_valid_slots():
    P, num = 16, 4
    data = _bank(np.random.RandomState(3), n=8, P=P)
    cache = tcache.DeviceCache(data, batch_size=8, num_patches=num, seed=0, shuffle=False,
                               device="cpu")
    batch = next(iter(cache.epoch(0)))
    sub, sub_mask = batch["patches"].numpy(), batch["patch_mask"].numpy()
    assert sub.shape == (8, num, 8)
    for i in range(8):
        assert sub_mask[i].sum() == min(data["patch_mask"][i].sum(), num)
        assert np.all(sub[i][~sub_mask[i]] == 0)
        valid = data["patches"][i][data["patch_mask"][i]]
        for row in sub[i][sub_mask[i]]:
            assert any(np.array_equal(row, v) for v in valid)


def test_resampling_is_seeded_per_epoch():
    """Fresh subsets across epochs; the same (seed, epoch) gives the same
    batches in another cache (a resumed run); `epoch(e)` and
    `stacked_epoch(e)` read the same scores."""
    data = _bank(np.random.RandomState(4), n=16)

    def cache():
        return tcache.DeviceCache(data, batch_size=8, num_patches=4, seed=0, device="cpu")

    a, b = cache(), cache()
    e0 = [x["patches"] for x in a.epoch(0)]
    e1 = [x["patches"] for x in a.epoch(1)]
    assert not torch.equal(e0[0], e1[0])
    for x, y in zip(e0, (x["patches"] for x in b.epoch(0))):
        assert torch.equal(x, y)
    stacked = b.stacked_epoch(0)
    for k, x in enumerate(a.epoch(0)):
        for key in x:
            assert torch.equal(x[key], stacked[key][k]), key
    b.seek(1)
    assert torch.equal(next(iter(b.epoch()))["patches"], e1[0])
