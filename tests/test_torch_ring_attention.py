"""The port's ring attention (gemm_gan_tpu_torch.kernels.ring_attention) vs
the JAX package's, over gloo ranks on the CPU.

JAX runs `ring_mha` on the virtual CPU mesh (model = 2 and 4); the port on
four spawned ranks (`tests/_torch_dist_worker.py::ring`): a 1x4 mesh for
model = 4 and a 2x2 one for model = 2 (each data row runs the same ring).
Inputs are made with numpy from a seed: ragged key masks with a fully
masked row (whose output is 0), and L = 13, which neither axis size divides
(the ring pads it). The output is held at rtol 1e-4 / atol 1e-5, the q / k
/ v gradients at tests/test_torch_train.py's gradient tolerance. The same
spawn checks that the model-axis collective pair differentiates twice (a
penalty on dy/dx through a row-parallel product), against plain PyTorch on
one process.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_ranks
from gemm_gan_tpu.kernels.ring_attention import ring_mha as j_ring_mha
from gemm_gan_tpu.parallel.mesh import make_mesh as j_make_mesh
from gemm_gan_tpu_torch.kernels.flash_attention import mha_reference
from gemm_gan_tpu_torch.kernels.ring_attention import ring_mha

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _case(rng, B, H, L, D, lengths):
    q, k, v, w = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return {"q": q, "k": k, "v": v, "w": w, "mask": mask}


def _jax_ring(case, n, dtype=jnp.float32):
    mesh = j_make_mesh(data=1, model=n, devices=jax.devices()[:n])
    w = jnp.asarray(case["w"])

    def loss(q, k, v):
        o = j_ring_mha(q, k, v, jnp.asarray(case["mask"]), mesh=mesh)
        return jnp.sum(o.astype(jnp.float32) * w)

    q, k, v = (jnp.asarray(case[n_]).astype(dtype) for n_ in ("q", "k", "v"))
    o = j_ring_mha(q, k, v, jnp.asarray(case["mask"]), mesh=mesh)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(o.astype(jnp.float32))] + [np.asarray(g.astype(jnp.float32))
                                                  for g in grads]


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.RandomState(0)
    cases = {"a": _case(rng, 3, 2, 13, 8, [13, 7, 0]),   # full, ragged, fully masked
             "b": _case(rng, 2, 4, 16, 16, [16, 11]),
             "c": _case(rng, 2, 2, 11, 16, [11, 6])}      # in bf16
    tp = {"tp_x": rng.standard_normal((5, 6)).astype(np.float32),
          "tp_w": rng.standard_normal((3, 6)).astype(np.float32)}
    np.savez(os.path.join(tmp, "inputs.npz"), **tp,
             **{f"{c}_{k}": v for c, d in cases.items() for k, v in d.items()})
    run_ranks("ring", 4, tmp)
    outs = [dict(np.load(os.path.join(tmp, f"out_{r}.npz"))) for r in range(4)]
    return cases, tp, outs


@pytest.mark.parametrize("n,label", [(4, "m4"), (2, "m2")])
@pytest.mark.parametrize("case", ["a", "b"])
def test_ring_matches_jax(ring_run, n, label, case):
    cases, _, outs = ring_run
    want = _jax_ring(cases[case], n)
    for rank, out in enumerate(outs):
        got = [out[f"{label}_{case}_{k}"] for k in ("o", "dq", "dk", "dv")]
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {rank} output")
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {rank} {name}")
    if case == "a":
        # the fully masked row gives exactly 0, and its q gets no gradient
        assert not outs[0][f"{label}_a_o"][2].any()
        assert not outs[0][f"{label}_a_dq"][2].any()


@pytest.mark.parametrize("n,label", [(4, "m4"), (2, "m2")])
def test_ring_matches_jax_in_bf16(ring_run, n, label):
    """bf16 operands (the bench configuration): the merge runs in f32 on
    both sides and the output is rounded to bf16 once, so they agree within
    one bf16 ulp of the largest entry; the gradients within two."""
    cases, _, outs = ring_run
    want = _jax_ring(cases["c"], n, jnp.bfloat16)
    for rank, out in enumerate(outs):
        got = [out[f"{label}_c_{k}"] for k in ("o", "dq", "dk", "dv")]
        for name, g, w, ulps in zip(("o", "dq", "dk", "dv"), got, want, (1, 2, 2, 2)):
            tol = ulps * 2.0 ** -8 * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"rank {rank} {name}")


def test_ring_without_mesh_is_the_reference():
    rng = np.random.RandomState(1)
    c = _case(rng, 2, 2, 9, 8, [9, 4])
    q, k, v = (torch.tensor(c[n]) for n in ("q", "k", "v"))
    mask = torch.tensor(c["mask"])
    torch.testing.assert_close(ring_mha(q, k, v, mask), mha_reference(q, k, v, mask),
                               rtol=0, atol=0)


def test_collectives_differentiate_twice(ring_run):
    """The row-parallel product's penalty gradient on two model ranks equals
    plain PyTorch's on one process (the model-axis pair is twice
    differentiable)."""
    _, tp, outs = ring_run
    x = torch.tensor(tp["tp_x"], requires_grad=True)
    W = torch.tensor(tp["tp_w"], requires_grad=True)
    y = torch.tanh(x @ W.T)
    (dx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    pen = ((dx.norm(dim=1) - 1) ** 2).mean()
    (dW,) = torch.autograd.grad(pen, W)
    for out in outs:
        np.testing.assert_allclose(out["tp_pen"], pen.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["tp_dx"], dx.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["tp_dW"], dW.numpy(), rtol=1e-5, atol=1e-6)
