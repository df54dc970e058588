"""The classic layout's kernels (Q3-Q6) in the bf16 modes, on the CPU.

The plain versions of `flash_fwd_bhld_bf16` / `_mxu` (Q3),
`flash_bwd_bhld_fused_bf16` / `_mxu` (Q6), `flash_bwd_dq_bf16` / `_mxu`
(Q4) and `flash_bwd_dkv_bf16` / `_mxu` (Q5), reached through the port's own
dispatch (`_bhld_kernels`, `single_block`), against the JAX package's
`_flash_core_fwd` / `_flash_core_bwd` with the `flash_mha` blocking (512
query rows, 256 keys) in interpret mode: bf16 refs, and `mxu_bf16` on f32
and on bf16 refs. Two shapes, D 16, ragged masks with a fully-masked
sample: L 130 (one block: the fused backward) and Lq = Lk = 600 (three key
blocks of 256, the last one short: the dq and dk/dv kernels). The keys from
300 on are scaled by 1.8, so that the running max of many rows grows past
the first key block: under `mxu_bf16` the rounded P then depends on the
key blocks (ROADMAP F4, which the 600-token forward pins).

Tolerances: every output within 1 bf16 ulp of the largest entry of its
row (both sides sum in f32 in other orders and round once); lse within
LSE_ATOL = 1e-5. An f32 output (o, and dq, dk, dv, under `mxu_bf16` with
f32 refs) also within F32_ATOL = 1e-5 on all but FLIP_SHARE = 0.5% of its
entries: where a rounded P or dS lies within an f32 ulp of a bf16 rounding
boundary, the two sides' exp and sums (1-2 f32 ulps apart) round it to
neighbouring bf16 values, which moves its row's output by up to 2^-8 of
that P's share (measured: 18 of 38,400 o entries at L 600, by up to
4.9e-4). Where no P falls so (one head, all keys valid, L 600: 6.6e-7),
the repaired forward holds 1e-5 everywhere; rounding exp(s - the row's max
over all keys), as before the repair, misses 1e-5 on 8,326 of 9,600
entries there, by up to 1.0e-3.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from test_torch_bf16 import LSE_ATOL, _assert_rows_within_ulps, _t
from test_torch_train import _no_launches_on_cpu

assert _no_launches_on_cpu  # the autouse fixture applies here too

F32_ATOL = 1e-5
FLIP_SHARE = 5e-3
B, H, D = 2, 2, 16
MODES = [(jnp.bfloat16, False), (jnp.bfloat16, True), (jnp.float32, True)]


def _inputs(L, dtype):
    rng = np.random.RandomState(L)
    q = rng.randn(B, H, L, D).astype(np.float32) * np.float32(D ** -0.5)
    k = rng.randn(B, H, L, D).astype(np.float32)
    k[:, :, 300:] *= 1.8
    v, do = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(2))
    lens = rng.randint(1, L + 1, B)
    lens[0] = 0  # sample 0 has no valid key
    mask = np.arange(L)[None, :] < lens[:, None]
    return [jnp.asarray(x, dtype) for x in (q, k, v, do)] + [jnp.asarray(mask)]


def _hold(got, want, what):
    """Within 1 bf16 ulp of each row's largest entry; in f32 also within
    F32_ATOL on all but FLIP_SHARE of the entries."""
    want = _t(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    _assert_rows_within_ulps(got, want, 1, what)
    if got.dtype == torch.float32:
        beyond = float(((got - want).abs() > F32_ATOL).float().mean())
        assert beyond <= FLIP_SHARE, (what, beyond)


def _jax_forward(L, dtype, mxu):
    q, k, v, do, mask = _inputs(L, dtype)
    o, res = jfa._flash_core_fwd(q, k, v, mask, 1.0, 512, 256, mxu)
    lse = np.array(res[5])[:, :L, 0].reshape(B, H, L)
    return (q, k, v, do, mask), o, lse, res


@pytest.mark.parametrize("dtype,mxu", MODES)
@pytest.mark.parametrize("L", [130, 600])
def test_classic_forward_plain_versions_match_pallas_in_bf16(L, dtype, mxu, monkeypatch):
    """Q3's bf16 and mxu modes: o and lse against `_fwd_kernel`."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    (q, k, v, _, mask), o, lse, _ = _jax_forward(L, dtype, mxu)
    fwd = tfa._bhld_kernels(_t(q).dtype, mxu)[0]
    assert fwd.__name__ == "flash_fwd_bhld_" + ("mxu" if mxu else "bf16")
    got, got_lse = fwd(*(_t(x) for x in (q, k, v, mask)))
    _hold(got, o, "o")
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=0, atol=LSE_ATOL)
    assert float(got[0].abs().max()) == 0.0  # no valid key: 0


@pytest.mark.parametrize("dtype,mxu", MODES)
@pytest.mark.parametrize("L", [130, 600])
def test_classic_backward_plain_versions_match_pallas_in_bf16(L, dtype, mxu, monkeypatch):
    """Q6 (L 130) or Q4 and Q5 (L 600) in the bf16 and mxu modes against
    `_bwd_fused_kernel` or `_bwd_dq_kernel` and `_bwd_dkv_kernel`, from the
    JAX forward's o and lse, delta from their f32 upcast."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    (q, k, v, do, mask), o, lse, res = _jax_forward(L, dtype, mxu)
    want = jfa._flash_core_bwd(1.0, 512, 256, mxu, res, do)[:3]
    _, fused, dq_kernel, dkv_kernel = tfa._bhld_kernels(_t(q).dtype, mxu)
    tdo, to = _t(do), _t(o)
    args = (*(_t(x) for x in (q, k, v, mask)), tdo, torch.from_numpy(lse),
            (tdo.float() * to.float()).sum(-1))
    if tfa.single_block(L, L):
        assert L == 130
        got = fused(*args)
    else:
        got = (dq_kernel(*args), *dkv_kernel(*args))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _hold(g, w, name)
        assert float(g[0].abs().max()) == 0.0, name  # sample 0: no valid key


def test_mxu_forward_rounds_p_per_key_block_as_jax(monkeypatch):
    """ROADMAP F4: under `mxu_bf16` the classic forward rounds P per key
    block of 256 (`classic_block_k`) from the running max, as JAX's blocked
    `_fwd_kernel` does, not exp(s - the row's max over all keys). One head,
    L 600, all keys valid, f32 refs: o within F32_ATOL everywhere."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.RandomState(0)
    L = 600
    q = rng.randn(1, 1, L, D).astype(np.float32) * np.float32(D ** -0.5)
    k = rng.randn(1, 1, L, D).astype(np.float32)
    k[:, :, 300:] *= 1.8
    v = rng.randn(1, 1, L, D).astype(np.float32)
    mask = np.ones((1, L), bool)
    want, _ = jfa._flash_core_fwd(*map(jnp.asarray, (q, k, v, mask)), 1.0, 512, 256, True)
    got, _ = tfa.flash_fwd_bhld_plain(*map(torch.from_numpy, (q, k, v, mask)), mxu_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    assert tfa.classic_block_k(L) == 256
