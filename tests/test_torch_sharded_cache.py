"""The port's `ShardedDeviceCache` vs the JAX package's, bit for bit.

The JAX cache runs on the 2x2 virtual CPU mesh, the port's on four gloo
ranks (`tests/_torch_dist_worker.py::sharded_cache`), on the data of
tests/test_patch_sharded_bank.py: each rank's batches must be exactly its
data shard's rows of JAX's global batches (every key, two epochs), with the
bank sharded over cases, over cases and patches (no resampling: only the
layout changes), and over both with shard-local resampling (num_patches / M
per model shard, from `jax.random`'s keys: `utils.threefry`). The index
table is JAX's per-shard permutation. The validation errors are JAX's.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_ranks
from gemm_gan_tpu.data.device_cache import ShardedDeviceCache as JShardedDeviceCache
from gemm_gan_tpu.data.synthetic import synthetic_dataset
from gemm_gan_tpu.parallel.mesh import make_mesh as j_make_mesh
from gemm_gan_tpu_torch.data.device_cache import ShardedDeviceCache
from gemm_gan_tpu_torch.parallel.mesh import Mesh
from gemm_gan_tpu_torch.utils import threefry


def _full_mask_data(n=16, width=8, patch_dim=16, genes=24):
    data = synthetic_dataset(n=n, n_genes=genes, num_patches=width, patch_dim=patch_dim,
                             num_tokens=6, text_dim=12, seed=3)
    data["patch_mask"] = np.ones_like(data["patch_mask"])
    data["patches"] = (np.arange(1, n * width * patch_dim + 1, dtype=np.float32)
                       .reshape(n, width, patch_dim) / 997.0)
    return data


def _resample_data(n=16, width=16):
    data = synthetic_dataset(n=n, n_genes=12, num_patches=width, patch_dim=8,
                             num_tokens=4, text_dim=8, seed=5)
    data["patches"] = np.tile(np.arange(1, width + 1, dtype=np.float32)[None, :, None],
                              (n, 1, 8))
    data["patch_mask"] = np.ones((n, width), bool)
    data["patch_mask"][:, width - 2:] = False
    data["patch_mask"][3, :5] = False  # a ragged case
    return data


CONFIGS = {"case": ("full", {}), "patch": ("full", {"shard_patches": True}),
           "resample": ("resample", {"shard_patches": True, "num_patches": 8})}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_cache")
    datas = {"full": _full_mask_data(), "resample": _resample_data()}
    for name, d in datas.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **d)
    run_ranks("sharded_cache", 4, tmp)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(4)]
    return datas, outs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_batches_are_jax_global_rows_bitwise(run, name):
    datas, outs = run
    data_name, kw = CONFIGS[name]
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cache = JShardedDeviceCache(datas[data_name], batch_size=8, mesh=mesh, seed=0, **kw)
    for rank, out in enumerate(outs):
        d = rank // 2
        assert int(out[f"{name}/len"]) == len(cache) == 2
        width = datas[data_name]["patches"].shape[1]
        assert int(out[f"{name}/local_patches"]) == (width // 2 if kw else width)
        for e in (0, 1):
            for k, batch in enumerate(cache.epoch(e)):
                for key, v in batch.items():
                    want = np.asarray(v)[d * 4:(d + 1) * 4]
                    got = out[f"{name}/{e}/{k}/{key}"]
                    assert got.dtype == want.dtype, (name, key)
                    np.testing.assert_array_equal(got, want, err_msg=f"{name} e{e} k{k} {key}")


def test_index_table_is_jax_per_shard_permutation(run):
    _, outs = run
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cache = JShardedDeviceCache(_full_mask_data(), batch_size=8, mesh=mesh, seed=0)
    perm = np.asarray(cache.epoch_perm_fn(cache.epoch_base_key(0)))
    for rank, out in enumerate(outs):
        d = rank // 2
        np.testing.assert_array_equal(out["case/idx"].reshape(-1), perm[d * 8:(d + 1) * 8])


def test_threefry_matches_jax_random():
    for seed in (0, 42):
        k = jax.random.fold_in(jax.random.key(seed), 3)
        tk = threefry.fold_in(threefry.key(seed), 3)
        assert np.array_equal(np.asarray(jax.random.key_data(k)), np.array(tk, np.uint32))
        for n in (1, 5, 64, 2000):
            np.testing.assert_array_equal(threefry.permutation(tk, n),
                                          np.asarray(jax.random.permutation(k, n)))
        np.testing.assert_array_equal(threefry.uniform(tk, (4, 9)),
                                      np.asarray(jax.random.uniform(k, (4, 9))))
        np.testing.assert_array_equal(np.array(threefry.split(tk), np.uint32),
                                      np.asarray(jax.random.key_data(jax.random.split(k))))


def _mesh(data, model):
    return Mesh({"data": data, "model": model}, 0, {"data": 0, "model": 0},
                torch.device("cpu"), {"data": None, "model": None},
                {"data": [0], "model": [0]})


@pytest.mark.parametrize("kw,match", [
    (dict(batch_size=7), "not divisible by data axis"),
    (dict(shard_patches=True, patches=np.zeros((16, 7, 2), np.float32)),
     "patch width 7 not divisible"),
    (dict(shard_patches=True, num_patches=3), "num_patches 3 not divisible"),
    (dict(shard_patches=True, drop_patches=True), "needs a 'patches' array"),
    (dict(batch_size=16, n=12), "cases per shard < per-shard batch"),
])
def test_validation_errors_match_jax(kw, match):
    kw = dict(kw)
    data = _full_mask_data(n=kw.pop("n", 16))
    if "patches" in kw:
        data["patches"] = kw.pop("patches")
        data["patch_mask"] = np.ones(data["patches"].shape[:2], bool)
    if kw.pop("drop_patches", False):
        del data["patches"], data["patch_mask"]
    args = dict(batch_size=kw.pop("batch_size", 8), seed=0, **kw)
    jmesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=match):
        JShardedDeviceCache(data, mesh=jmesh, **args)
    with pytest.raises(ValueError, match=match):
        ShardedDeviceCache(data, mesh=_mesh(2, 2), **args)
