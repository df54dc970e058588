"""Port's attention (gemm_gan_tpu_torch.kernels) vs the JAX package's.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
these are held against the Pallas kernels run in interpret mode, on the
same numpy inputs. Tolerance rtol 2e-4 / atol 2e-5 on o, the one
tests/test_kernels.py holds the Pallas kernels to (f32, different
summation order). The CUDA kernels themselves are held against the same
plain versions on the card by chip_smoke.py.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os
import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu_torch.kernels import build
from gemm_gan_tpu_torch.kernels import flash_attention as tfa

RTOL, ATOL = 2e-4, 2e-5
LSE_RTOL = 1e-5  # lse ~ log(Lk) + max logit: relative agreement


def _inputs(seed, q_shape, kv_shape, Lk, fully_masked=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(*q_shape).astype(np.float32)
    k = rng.randn(*kv_shape).astype(np.float32)
    v = rng.randn(*kv_shape).astype(np.float32)
    B = q_shape[0]
    lens = rng.randint(1, Lk + 1, B)
    if fully_masked:
        lens[0] = 0
    mask = np.arange(Lk)[None, :] < lens[:, None]
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(autouse=True)
def _fresh_counts():
    tfa.reset_launch_counts()
    yield
    assert tfa.flash_fwd_ble.launches == 0 and tfa.flash_fwd_bhld.launches == 0, \
        "CPU tensors must never launch a kernel"


@pytest.mark.parametrize("Lq,Lk,fully_masked", [(128, 128, False), (130, 260, False),
                                                (130, 260, True)])
def test_ble_plain_matches_pallas_ble_kernel(Lq, Lk, fully_masked, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    B, H, D = 2, 2, 8
    q, k, v, mask = _inputs(0, (B, Lq, H * D), (B, Lk, H * D), Lk, fully_masked)
    qs = q * np.float32(D ** -0.5)  # both sides take pre-scaled q here
    o_j, res = jfa._flash_core_ble_fwd(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), 1.0, H, False)
    lse_j = np.asarray(res[-1])[:, :, ::jfa._LANES].transpose(0, 2, 1)  # col h*128
    o_t, lse_t = tfa.flash_fwd_ble(*_t(qs, k, v, mask), H)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=RTOL, atol=ATOL)
    assert lse_t.shape == (B, H, Lq)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=LSE_RTOL)
    if fully_masked:
        assert np.all(o_t[0].numpy() == 0.0)
    # the public wrapper folds the scale into q itself
    got = tfa.flash_mha_ble(*_t(q, k, v, mask), num_heads=H)
    want = jfa.flash_mha_ble(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), num_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Lq,Lk", [(130, 260), (136, 600)])
def test_bhld_plain_matches_pallas_blocked_kernel(Lq, Lk, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    B, H, D = 2, 2, 8
    q, k, v, mask = _inputs(1, (B, H, Lq, D), (B, H, Lk, D), Lk, fully_masked=True)
    qs = q * np.float32(D ** -0.5)
    # the dispatch's default blocks (512, 256): Lk=600 takes 3 k blocks
    o_j, res = jfa._flash_core_fwd(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), 1.0, 512, 256, False)
    lse_j = np.asarray(res[-1])[:, :Lq, 0].reshape(B, H, Lq)
    o_t, lse_t = tfa.flash_fwd_bhld(*_t(qs, k, v, mask))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=LSE_RTOL)
    got = tfa.flash_mha(*_t(q, k, v, mask))
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plain_classic_chunks_agree_with_one_block(monkeypatch):
    """The plain classic version runs in chunks of query rows; the chunking
    must not change the result."""
    B, H, Lq, Lk, D = 2, 2, 70, 90, 8
    q, k, v, mask = _t(*_inputs(2, (B, H, Lq, D), (B, H, Lk, D), Lk, True))
    whole = tfa.flash_fwd_bhld_plain(q, k, v, mask)
    monkeypatch.setattr(tfa, "_PLAIN_BLOCK_Q", 16)
    chunked = tfa.flash_fwd_bhld_plain(q, k, v, mask)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_mha_reference_matches_jax_including_fully_masked_rows():
    B, H, Lq, Lk, D = 3, 2, 5, 24, 8
    q, k, v, mask = _inputs(3, (B, H, Lq, D), (B, H, Lk, D), Lk, fully_masked=True)
    want = np.asarray(jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask)))
    got = tfa.mha_reference(*_t(q, k, v, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[0] == 0.0)


def test_blocked_reference_matches_reference():
    B, H, Lq, Lk, D = 1, 2, 300, 40, 8
    q, k, v, mask = _t(*_inputs(4, (B, H, Lq, D), (B, H, Lk, D), Lk))
    np.testing.assert_allclose(tfa.mha_reference_blocked(q, k, v, mask).numpy(),
                               tfa.mha_reference(q, k, v, mask).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_constants_match_jax():
    assert tfa.MIN_PALLAS_LQ == jfa.MIN_PALLAS_LQ == 128
    assert tfa.BLE_MAX_L == jfa.BLE_MAX_L == 512
    assert tfa.BLOCKED_REF_MIN_LK == jfa.BLOCKED_REF_MIN_LK == 2048


@pytest.mark.parametrize("layout,Lq,Lk,use_pallas", [
    ("bhld", 1, 24, True),     # CLS query: plain reference
    ("ble", 1, 40, True),      # CLS query in the projection layout
    ("ble", 130, 130, True),   # single block: the ble kernel's plain version
    ("ble", 600, 600, True),   # > BLE_MAX_L: heads split, classic kernel
    ("ble", 130, 130, False),  # kernels off: plain reference
])
def test_masked_mha_dispatch_matches_jax(layout, Lq, Lk, use_pallas, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    B, H, D = 2, 2, 8
    if layout == "ble":
        shapes = (B, Lq, H * D), (B, Lk, H * D)
    else:
        shapes = (B, H, Lq, D), (B, H, Lk, D)
    q, k, v, mask = _inputs(5, *shapes, Lk, fully_masked=True)
    kw = dict(layout=layout, num_heads=H) if layout == "ble" else {}
    want = jfa.masked_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), use_pallas=use_pallas, **kw)
    got = tfa.masked_mha(*_t(q, k, v, mask), use_pallas=use_pallas, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_masked_mha_long_sequences_take_blocked_reference(monkeypatch):
    calls = []
    real = tfa.mha_reference_blocked
    monkeypatch.setattr(tfa, "mha_reference_blocked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    B, H, L, D = 1, 1, tfa.BLOCKED_REF_MIN_LK, 8
    q, k, v, mask = _t(*_inputs(6, (B, H, L, D), (B, H, L, D), L))
    got = tfa.masked_mha(q, k, v, mask, use_pallas=False)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), tfa.mha_reference(q, k, v, mask).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_kernel_wrappers_take_plain_versions_only_on_cpu_tensors():
    """CPU tensors go to the plain versions; the checks a CUDA launch goes
    through reject CPU tensors rather than fall back."""
    B, H, L, D = 1, 2, 8, 8
    q, k, v, mask = _t(*_inputs(7, (B, L, H * D), (B, L, H * D), L))
    o, lse = tfa.flash_fwd_ble(q, k, v, mask, H)
    po, plse = tfa.flash_fwd_ble_plain(q, k, v, mask, H)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check_inputs("flash_fwd_ble", q, k, v, mask, (B, L, H * D), D)


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'flash_fwd.cu(1): error: no good' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no good"):
        build.build()
    assert os.listdir(tmp_path / "build") == []  # no half-written library


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    first = build.library_path()
    assert first.startswith(str(tmp_path)) and first == build.library_path()
    src = tmp_path / "csrc"
    src.mkdir()
    names = sorted(os.listdir(build.CSRC_DIR))
    for name in names:
        (src / name).write_text((Path(build.CSRC_DIR) / name).read_text())
    monkeypatch.setattr(build, "CSRC_DIR", str(src))
    assert build.library_path() == first  # same sources, same library
    assert build.sources() == [n for n in names if n.endswith(".cu")]
    assert build.sources() == ["flash_bwd_bf16.cu", "flash_bwd_bhld_bf16.cu",
                              "flash_bwd_bhld_mxu.cu", "flash_bwd_dkv.cu",
                              "flash_bwd_dkv_bf16.cu", "flash_bwd_dq.cu", "flash_bwd_dq_bf16.cu",
                              "flash_bwd_fused.cu", "flash_bwd_mxu.cu", "flash_fwd.cu",
                              "flash_fwd_bf16.cu", "flash_fwd_bhld_bf16.cu"]
    # a header is part of the key: editing it must not load a stale library
    (src / "tf32x3.cuh").write_text("// changed\n")
    header_changed = build.library_path()
    assert header_changed != first
    (src / build.sources()[-1]).write_text("// changed\n")
    assert build.library_path() not in (first, header_changed)
