"""Port's attention backward (gemm_gan_tpu_torch.kernels) vs the JAX package's.

On the CPU the port's backward wrappers take their plain PyTorch versions;
these are held against the Pallas backward kernels run in interpret mode
on the forward's own residuals, on the same numpy inputs. The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.

Tolerances: the plain backward vs a Pallas backward kernel on identical
residuals, rtol 2e-4 / atol 2e-5 (f32, another summation order, as for the
forward in test_torch_flash_attention.py); gradients through the whole
`masked_mha` (forward + backward, the scale folded into q) rtol 5e-4 /
atol 5e-5, the tolerance tests/test_kernels.py holds the Pallas gradients
to.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu_torch.kernels import flash_attention as tfa

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _inputs(seed, q_shape, kv_shape, Lk, fully_masked=True):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(*q_shape).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(*kv_shape).astype(np.float32) for _ in range(2))
    lens = rng.randint(1, Lk + 1, q_shape[0])
    if fully_masked:
        lens[0] = 0
    mask = np.arange(Lk)[None, :] < lens[:, None]
    return q, k, v, mask, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    tfa.reset_launch_counts()
    yield
    assert not any(tfa.launch_counts().values()), "CPU tensors must never launch a kernel"


@pytest.mark.parametrize("Lq,Lk", [(128, 128), (130, 260)])
def test_ble_backward_plain_matches_pallas_ble_kernel(Lq, Lk):
    """Q2: `flash_bwd_ble_plain` vs `_bwd_kernel_ble` on the residuals of
    `_fwd_kernel_ble`, with a fully-masked sample."""
    B, H, D = 2, 2, 8
    q, k, v, mask, do = _inputs(0, (B, Lq, H * D), (B, Lk, H * D), Lk)
    qs = q * np.float32(D ** -0.5)
    _, res = jfa._flash_core_ble_fwd(*map(jnp.asarray, (qs, k, v, mask)), 1.0, H, False)
    want = jfa._flash_core_ble_bwd(1.0, H, False, res, jnp.asarray(do))[:3]
    o = np.asarray(res[4])
    lse = np.asarray(res[5])[:, :, ::jfa._LANES].transpose(0, 2, 1)  # [B, H, Lq]
    got = tfa.flash_bwd_ble(*_t(qs, k, v, mask, o, lse, do), H)
    _close(got, want)
    for g in got:  # sample 0 has no valid key: every gradient is 0 there
        assert np.all(g[0].numpy() == 0.0)


def _classic_residuals(B, H, Lq, Lk, D, seed):
    q, k, v, mask, do = _inputs(seed, (B, H, Lq, D), (B, H, Lk, D), Lk)
    qs = q * np.float32(D ** -0.5)
    # the JAX dispatch's blocks (512, 256)
    _, res = jfa._flash_core_fwd(*map(jnp.asarray, (qs, k, v, mask)), 1.0, 512, 256, False)
    want = jfa._flash_core_bwd(1.0, 512, 256, False, res, jnp.asarray(do))[:3]
    o = np.asarray(res[4])
    lse = np.asarray(res[5])[:, :Lq, 0].reshape(B, H, Lq)
    delta = (do * o).sum(-1)
    return _t(qs, k, v, mask, do, lse, delta), want


def test_fused_backward_plain_matches_pallas_fused_kernel():
    """Q6: (130, 260) is one block of the classic kernels, so JAX takes
    `_bwd_fused_kernel`."""
    args, want = _classic_residuals(2, 2, 130, 260, 8, seed=1)
    assert tfa.single_block(130, 260)
    _close(tfa.flash_bwd_bhld_fused(*args), want)


def test_blocked_backward_plain_matches_pallas_dq_dkv_kernels():
    """Q4 + Q5: (136, 600) takes 3 k blocks, so JAX runs `_bwd_dq_kernel`
    and `_bwd_dkv_kernel`."""
    args, want = _classic_residuals(2, 2, 136, 600, 8, seed=2)
    assert not tfa.single_block(136, 600)
    _close([tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args)], want)


def test_plain_backward_chunks_agree_with_one_block(monkeypatch):
    """The plain dq / dk-dv versions run in chunks of query rows; the
    chunking must not change the result beyond summation order."""
    args, _ = _classic_residuals(2, 2, 136, 600, 8, seed=3)
    whole = [tfa.flash_bwd_dq_plain(*args), *tfa.flash_bwd_dkv_plain(*args)]
    monkeypatch.setattr(tfa, "_PLAIN_BLOCK_Q", 32)
    chunked = [tfa.flash_bwd_dq_plain(*args), *tfa.flash_bwd_dkv_plain(*args)]
    np.testing.assert_array_equal(whole[0].numpy(), chunked[0].numpy())
    _close(chunked[1:], [w.numpy() for w in whole[1:]], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("Lq,Lk", [(1, 8), (8, 8), (130, 260), (257, 257), (300, 300),
                                   (505, 384), (513, 100), (136, 600), (4097, 4097)])
def test_single_block_matches_jax_blocking(Lq, Lk):
    """`single_block` is the n_q == n_k == 1 test of JAX's `_prep` with the
    dispatch's blocks (512, 256)."""
    q = jnp.zeros((1, 1, Lq, 8))
    k = jnp.zeros((1, 1, Lk, 8))
    _, _, _, _, bq, bk, Lq_p, Lk_p = jfa._prep(q, k, k, None, 512, 256)
    assert tfa.single_block(Lq, Lk) == (Lq_p // bq == 1 and Lk_p // bk == 1)


@pytest.mark.parametrize("layout,Lq,Lk,backward", [
    ("ble", 130, 130, "flash_bwd_ble"),          # single block, E layout
    ("bhld", 130, 260, "flash_bwd_bhld_fused"),  # single block, classic
    ("bhld", 136, 600, "flash_bwd_dq"),          # 3 k blocks: dq + dk/dv
    ("ble", 600, 600, "flash_bwd_dq"),           # > BLE_MAX_L: heads split
])
def test_masked_mha_gradients_match_jax(layout, Lq, Lk, backward, monkeypatch):
    """`torch.autograd.grad` through the port's `masked_mha` vs `jax.grad`
    through JAX's, with the kernels on (Pallas in interpret mode, the
    port's plain versions behind its autograd Functions), and the backward
    the port's dispatch chose."""
    B, H, D = 2, 2, 8
    if layout == "ble":
        shapes = (B, Lq, H * D), (B, Lk, H * D)
        kw = dict(layout="ble", num_heads=H)
    else:
        shapes, kw = ((B, H, Lq, D), (B, H, Lk, D)), {}
    q, k, v, mask, w = _inputs(4, *shapes, Lk)
    called = []
    for name in ("flash_bwd_ble", "flash_bwd_bhld_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real: called.append(_n) or _f(*a))

    def jax_loss(q, k, v):
        return jnp.sum(jfa.masked_mha(q, k, v, jnp.asarray(mask), **kw) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tfa.masked_mha(tq, tk, tv, torch.from_numpy(mask), **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    _close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert called[0] == backward
    if backward == "flash_bwd_dq":
        assert called == ["flash_bwd_dq", "flash_bwd_dkv"]
    else:
        assert called == [backward]


def test_attention_is_first_order_only():
    """The autograd Functions are `once_differentiable`: backpropagating a
    gradient that came out of attention's backward raises rather than
    returning a wrong number."""
    q, k, v, mask, _ = _inputs(5, (1, 128, 16), (1, 128, 16), 128, fully_masked=False)
    tq = torch.from_numpy(q).requires_grad_(True)
    out = tfa.masked_mha(tq, *_t(k, v, mask), layout="ble", num_heads=2)
    g, = torch.autograd.grad(out.square().sum(), tq, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_backward_wrappers_check_their_operands():
    """The checks a CUDA launch goes through reject a wrong lse or delta
    rather than read past it."""
    B, H, L, D = 1, 2, 8, 8
    q, k, v, mask, do = _t(*_inputs(6, (B, H, L, D), (B, H, L, D), L, fully_masked=False))
    lse = torch.zeros(B, H, L)
    with pytest.raises(ValueError, match="delta"):
        tfa._check_grad_inputs("flash_bwd_dq", q, {"delta": (torch.zeros(B, H, L + 1),
                                                             (B, H, L))})
    with pytest.raises(ValueError, match="lse"):
        tfa._check_grad_inputs("flash_bwd_dq", q, {"lse": (lse.double(), (B, H, L))})
    tfa._check_grad_inputs("flash_bwd_dq", q, {"do": (do, q.shape), "lse": (lse, (B, H, L))})
