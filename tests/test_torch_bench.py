"""`python -m gemm_gan_tpu_torch.bench`, the port's step measurement, on
the CPU at tiny shapes: one parseable JSON line with the keys of
`bench.py`'s (less its host-CPU denominator) and the card's name and
power limit; the bench configuration and batch are `bench.py`'s; without a
card and without `--device cpu` it raises. The rate itself is measured
only on the card (`chip_smoke.py` phase 16 (d))."""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from gemm_gan_tpu_torch import bench

KEYS = {"metric", "value", "unit", "compute_dtype", "scan_len", "name", "power_limit"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: tiny shapes are many small ops, which torch's
    thread pool only slows (and the suite runs files side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(dtype):
    cfg = bench.bench_config(dtype)
    m = cfg.model
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, n_genes=16, latent_dim=8, gen_dims=(16, 16), disc_dims=(16, 16),
        fusion=dataclasses.replace(m.fusion, cond_dim=16, text_dim=12, patch_dim=16,
                                   ff_dim=32, num_heads=2, num_layers=1)))
    rng = np.random.RandomState(0)
    batch = {"genes": rng.randn(4, 16).astype(np.float32),
             "tokens": rng.randn(4, 6, 12).astype(np.float32),
             "token_mask": np.ones((4, 6), dtype=bool),
             "patches": rng.randn(4, 8, 16).astype(np.float32),
             "patch_mask": np.ones((4, 8), dtype=bool)}
    return cfg, batch


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_prints_one_parseable_line(dtype, capsys):
    cfg, batch = _tiny(dtype)
    record = bench.main(["--device", "cpu", "--scan_len", "3", "--n_calls", "2",
                         "--dtype", dtype], cfg=cfg, batch=batch)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == json.loads(json.dumps(record)) and KEYS <= got.keys()
    assert got["metric"] == "wgan_gp_flagship_steps_per_sec" and got["unit"] == "steps/s"
    assert got["compute_dtype"] == dtype and got["scan_len"] == 3
    assert got["name"] == "cpu" and got["power_limit"] is None
    assert len(got["call_seconds"]) == 2
    assert got["value"] == pytest.approx(3 / got["call_seconds"][1])


def test_bench_configuration_and_batch_are_bench_py_s():
    for name in ("B", "N_GENES", "N_PATCHES", "PATCH_DIM", "N_TOKENS", "TEXT_DIM",
                 "LATENT", "N_CRITIC"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    got = bench.bench_batch(np.random.RandomState(0))
    want = jax_bench._batch(np.random.RandomState(0))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    cfg = bench.bench_config()
    assert cfg.variant == "film_cross_attention" and cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.cond_embed_reuse == "per_update" and cfg.train.batched_scores
    assert not cfg.train.hoist_fakes and cfg.train.n_critic == 5
    assert bench.bench_config("float32").model.compute_dtype == "float32"


def test_bench_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
