"""Full-state checkpoints of the port and exact resume, on the CPU.

Torch twins of tests/test_checkpoint.py. A restored run continues bitwise
equal to the uninterrupted one: params, optimizer moments and counts, the
EMA, the step and both generators (z / alpha / noise, and dropout).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gemm_gan_tpu_torch.cli.experiment import Experiment
from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.train.checkpoint import (STATE_FILE, latest_step, resolve_ckpt_dir,
                                                 restore_state, resume_or_fresh, save_state)
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

CPU = "cpu"
FUSION_KW = dict(cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2,
                 num_layers=1, n_disease_types=3, n_primary_sites=2, use_pallas=False)


def tiny_cfg(variant, out_dir="outputs", **train_kw):
    """The JAX tests' tiny config (tests/conftest.py::tiny_cfg) for the port,
    with the fusion's dropout (0.1) on for the flagship."""
    cfg = variant_config(variant, n_genes=24, fusion_kw=FUSION_KW)
    kw = dict(n_critic=2, critic_scan=True)
    kw.update(train_kw)
    return dataclasses.replace(
        cfg, output_dir=str(out_dir), run_name="r",
        model=dataclasses.replace(cfg.model, gen_dims=(32, 32), disc_dims=(32, 32),
                                  latent_dim=16),
        train=dataclasses.replace(cfg.train, **kw),
        eval=dataclasses.replace(cfg.eval, n_runs=1, pca_components=4, nearest_k=3,
                                 pr_nhood_sizes=()))


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(n=48, n_genes=24, n_classes=3, n_sites=2, num_patches=8,
                             patch_dim=16, num_tokens=6, text_dim=12, seed=1)


def splits_of(data, keys=None):
    idx = {"train": np.arange(0, 32), "val": np.arange(32, 40), "test": np.arange(40, 48)}
    keys = keys or list(data)
    out = {s: {k: data[k][i] for k in keys} for s, i in idx.items()}
    out["meta"] = {"n_genes": 24}
    return out


def _same_state(a, b):
    """Every tensor of two training states bitwise equal."""
    assert a.step == b.step
    for net in ("gen", "critic", "g_ema"):
        sa, sb = getattr(a, net), getattr(b, net)
        assert (sa is None) == (sb is None), net
        if sa is not None:
            for (k, x), (_, y) in zip(sa.state_dict().items(), sb.state_dict().items()):
                assert torch.equal(x, y), (net, k)
    for opt in ("g_opt", "d_opt"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        assert oa.count == ob.count and torch.equal(oa.count_t, ob.count_t), opt
        for xs, ys in ((oa.nu, ob.nu), (oa.mu or [], ob.mu or [])):
            assert all(torch.equal(x, y) for x, y in zip(xs, ys)), opt
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("variant,optimizer", [("vanilla", "rmsprop"),
                                               ("film_cross_attention", "adam")])
def test_resume_is_exact(tmp_path, data, variant, optimizer):
    """Save after two steps, continue; a fresh engine restored from the
    checkpoint takes the same third step bitwise (the flagship with dropout
    0.1 and an EMA: the dropout generator is part of the state)."""
    cfg = tiny_cfg(variant, optimizer=optimizer, ema_decay=0.9)
    batch = next(iter(Batches(splits_of(data)["train"], batch_size=8, seed=0)))

    eng = WGANGPEngine(cfg, steps_per_epoch=2, device=CPU)
    state = eng.init_state(0, batch)
    torch.manual_seed(5)
    state, _ = eng.step(state, batch)
    state, _ = eng.step(state, batch)
    ckpt = str(tmp_path / "ckpt")
    assert save_state(ckpt, state) == 2
    assert latest_step(ckpt) == 2
    cont, m_direct = eng.step(state, batch)

    torch.manual_seed(123)  # the restore sets the dropout generator back
    eng2 = WGANGPEngine(cfg, steps_per_epoch=2, device=CPU)
    restored = restore_state(ckpt, eng2.init_state(7, batch))
    assert restored.step == 2 and restored.g_opt.count == 2 and restored.d_opt.count == 4
    resumed, m_resumed = eng2.step(restored, batch)
    for k in m_direct:
        assert torch.equal(m_direct[k], m_resumed[k]), k
    _same_state(cont, resumed)


def test_checkpoint_dir_keeps_the_newest_five_and_replaces_a_step(tmp_path, data):
    cfg = tiny_cfg("vanilla")
    batch = next(iter(Batches(splits_of(data, ["genes"])["train"], batch_size=8, seed=0)))
    eng = WGANGPEngine(cfg, steps_per_epoch=1, device=CPU)
    state = eng.init_state(0, batch)
    ckpt = str(tmp_path / "ckpt")
    for _ in range(7):
        state, _ = eng.step(state, batch)
        save_state(ckpt, state)
    assert sorted(os.listdir(ckpt)) == [str(s) for s in range(3, 8)]
    before = torch.load(os.path.join(ckpt, "7", STATE_FILE), weights_only=True)
    state.gen.trunk.head.weight.data.add_(1.0)
    save_state(ckpt, state)  # the same step again: replaced, no temporary left
    after = torch.load(os.path.join(ckpt, "7", STATE_FILE), weights_only=True)
    assert not torch.equal(before["gen"]["trunk.head.weight"], after["gen"]["trunk.head.weight"])
    assert sorted(os.listdir(ckpt)) == [str(s) for s in range(3, 8)]
    with pytest.raises(FileNotFoundError):
        restore_state(ckpt, state, step=2)
    with pytest.raises(FileNotFoundError):
        restore_state(str(tmp_path / "none"), state)
    fresh, start = resume_or_fresh(str(tmp_path / "none"), state, 2, 4)
    assert fresh is state and start == 0


def test_experiment_resume_exact(tmp_path, data):
    """Experiment.fit(resume=True) continues an interrupted run to the same
    final state as an uninterrupted one, bitwise: 2 epochs then 2 resumed
    against 4 straight. The flagship on a DeviceCache (step_many_cached),
    dropout 0.1, EMA, validation every epoch: the two runs validate at
    different epochs (0, 1, 2 against 0 and 2), so validation draws
    nothing from training's generators."""
    def cfg_for(out_dir, epochs):
        return tiny_cfg("film_cross_attention", out_dir, epochs=epochs, freq_compute_test=1,
                        batch_size=8, checkpoint_every_eval=True, ema_decay=0.99)

    torch.manual_seed(999)
    straight = Experiment(cfg_for(tmp_path / "a", 4), splits_of(data), device=CPU)
    straight.fit()

    interrupted = Experiment(cfg_for(tmp_path / "b", 2), splits_of(data), device=CPU)
    interrupted.fit()  # final save at step 2 * steps_per_epoch
    torch.manual_seed(0)
    resumed = Experiment(cfg_for(tmp_path / "b", 4), splits_of(data), device=CPU)
    resumed.fit(resume=True)

    # the pre-crash validation history rehydrates from val_metrics.json
    with open(os.path.join(str(tmp_path / "b"), "r", "val_metrics.json")) as f:
        assert [r["epoch"] for r in json.load(f)] == [0, 2]
    assert straight.state.step == 4 * straight.loaders["train"].n_full_batches
    _same_state(straight.state, resumed.state)


def test_resolve_ckpt_dir_pins_best_step(tmp_path):
    """which='best' maps to the sibling ckpt_best/ and pins the restore step
    to best.json's record."""
    run = tmp_path / "run"
    (run / "ckpt").mkdir(parents=True)
    (run / "ckpt_best").mkdir()
    (run / "best.json").write_text(json.dumps({"score": 1.0, "epoch": 3, "step": 12}))
    ckpt = str(run / "ckpt")

    assert resolve_ckpt_dir(ckpt, "last") == (ckpt, None)
    best_dir, step = resolve_ckpt_dir(ckpt, "best")
    assert best_dir == str(run / "ckpt_best")
    assert step == 12

    # no best.json: the directory still resolves, the newest step wins
    (run / "best.json").unlink()
    assert resolve_ckpt_dir(ckpt, "best") == (str(run / "ckpt_best"), None)

    shutil.rmtree(run / "ckpt_best")
    with pytest.raises(FileNotFoundError, match="freq_compute_test"):
        resolve_ckpt_dir(ckpt, "best")
    with pytest.raises(ValueError, match="which"):
        resolve_ckpt_dir(ckpt, "latest")
