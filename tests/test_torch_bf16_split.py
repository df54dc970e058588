"""The arithmetic of the single-block backward's bf16-ref modes on the
warpgroup-MMA tile (csrc/flash_bwd_wg.cuh), emulated in numpy.

`flash_bwd_ble_bf16` (Q2) and `flash_bwd_bhld_fused_bf16` (Q6) take their
products on wgmma m64nNk16 with bf16 operands and f32 accumulation. q, k,
v and dO are bf16 already; P and dS are f32, and go in as three bf16 terms
(`bf16mma::split`: hi = rne(x), mid = rne(x - hi), lo = rne(x - hi - mid));
the `_mxu` modes on bf16 refs take one term (P and dS rounded once, as the
JAX package's `mxu_bf16`). Each wgmma k16 step adds 16 products, exact in
f32 (bf16 x bf16), to the f32 accumulator; the small terms of a step go in
first; dK, dV and dQ accumulate across the streamed steps in the same
accumulators. The outputs are rounded to bf16 once at the store. These
tests emulate exactly that in numpy (no card needed) and pin:

(a) hi + mid + lo gives back x exactly for f32 normals, and each term is a
    bf16 value;
(b) at B 2, H 4, L 257, D 64 with a ragged mask whose first sample has no
    valid key, the emulated dq, dk and dv land within one bf16 ulp of each
    row's largest entry (chip_smoke.py's gate for these kernels on the
    card) of the JAX package's Pallas `_bwd_kernel_ble` (through
    `_flash_core_ble_bwd`) and `_bwd_fused_kernel` (through
    `_flash_core_bwd`), run in interpret mode on the same numpy inputs with
    bf16 refs, in the bf16 mode (three terms) and under `mxu_bf16` (one);
    the first sample's gradients and the masked keys' dk, dv are exactly 0.

The emulation takes the softmax statistics as the kernels get them: lse
from the JAX forward, delta = rowsum(dO * O) in f32 from that forward's o
(the ble tile computes it so from o and dO; the classic layout's wrapper
passes it so).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.kernels import flash_attention as jfa
from test_torch_bf16 import _assert_rows_within_ulps

B, H, L, D = 2, 4, 257, 64
K_STEP = 16  # wgmma's depth for 16-bit operands


def bf16_rne(x):
    """f32 -> the nearest bf16 value, ties to even (`__floats2bfloat162_rn`
    on finite values), returned as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32)


def split(x, terms):
    """x as `terms` bf16 terms, largest first: each term is the residual
    so far rounded to bf16 (`bf16mma::split`)."""
    x = np.asarray(x, np.float32)
    out = []
    for _ in range(terms):
        out.append(bf16_rne(x))
        x = (x - out[-1]).astype(np.float32)
    return out


def emulated_product(a_terms, b):
    """sum over the terms of a_term [M, K] @ b [K, N] as the wgmma tile
    takes it: per k16 step, each term's 16 products (the small terms first)
    summed exactly and added to the f32 accumulator with one rounding; one
    accumulator over all of K."""
    pad = -b.shape[0] % K_STEP
    b = np.pad(b.astype(np.float32), ((0, pad), (0, 0))).astype(np.float64)
    a_terms = [np.pad(a.astype(np.float32), ((0, 0), (0, pad))).astype(np.float64)
               for a in a_terms]
    acc = np.zeros((a_terms[0].shape[0], b.shape[1]), np.float32)
    for i in range(b.shape[0] // K_STEP):
        ks = slice(K_STEP * i, K_STEP * (i + 1))
        for a in reversed(a_terms):
            acc = (acc.astype(np.float64) + a[:, ks] @ b[ks]).astype(np.float32)
    return acc


def emulated_backward(q, k, v, valid, do, lse, delta, terms):
    """One (batch, head): q, do [Lq, D], k, v [Lk, D] (bf16 values), valid
    [Lk], lse, delta [Lq] -> (dq, dk, dv) rounded to bf16. The dk/dv tile
    computes S^T = K.Q^T and dP^T = V.dO^T, the dq tile S = Q.K^T and
    dP = dO.V^T: the same sums, transposed."""
    with np.errstate(over="ignore"):  # lse = -1e30 where no key is valid
        p = np.where(valid[None], np.exp(emulated_product([q], k.T) - lse[:, None]),
                     np.float32(0)).astype(np.float32)
    ds = (p * (emulated_product([do], v.T) - delta[:, None])).astype(np.float32)
    dq = emulated_product(split(ds, terms), k)
    dk = emulated_product(split(ds.T, terms), q)
    dv = emulated_product(split(p.T, terms), do)
    return tuple(bf16_rne(x) for x in (dq, dk, dv))


def _inputs(seed=9):
    rng = np.random.RandomState(seed)
    q = bf16_rne(rng.randn(B, H, L, D) * D ** -0.5)
    k, v, do = (bf16_rne(rng.randn(B, H, L, D)) for _ in range(3))
    lens = rng.randint(1, L + 1, B)
    lens[0] = 0  # sample 0 has no valid key
    mask = np.arange(L)[None, :] < lens[:, None]
    return q, k, v, do, mask


def _ble(x):  # [B, H, L, D] -> [B, L, H * D]
    return x.transpose(0, 2, 1, 3).reshape(B, L, H * D)


def _heads(x):  # [B, L, H * D] -> [B, H, L, D]
    return np.asarray(x, np.float32).reshape(B, L, H, D).transpose(0, 2, 1, 3)


def _case(layout, mxu):
    """The emulated gradients and the Pallas kernel's, [B, H, L, D] each."""
    q, k, v, do, mask = _inputs()
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    jmask = jnp.asarray(mask)
    if layout == "ble":
        o, res = jfa._flash_core_ble_fwd(*(jnp.asarray(_ble(np.asarray(x, np.float32)),
                                                       jnp.bfloat16) for x in bf[:3]),
                                         jmask, 1.0, H, mxu)
        lse = np.asarray(res[5])[:, :, ::jfa._LANES].transpose(0, 2, 1)
        want = [_heads(g) for g in jfa._flash_core_ble_bwd(
            1.0, H, mxu, res, jnp.asarray(_ble(do), jnp.bfloat16))[:3]]
        o = _heads(o.astype(jnp.float32))
    else:
        o, res = jfa._flash_core_fwd(*bf[:3], jmask, 1.0, 512, 256, mxu)
        lse = np.asarray(res[5])[:, :L, 0].reshape(B, H, L)
        want = [np.asarray(g.astype(jnp.float32))
                for g in jfa._flash_core_bwd(1.0, 512, 256, mxu, res, bf[3])[:3]]
        o = np.asarray(o.astype(jnp.float32))
    delta = (do * o).sum(-1, dtype=np.float32)
    terms = 1 if mxu else 3
    got = [[emulated_backward(q[b, h], k[b, h], v[b, h], mask[b], do[b, h], lse[b, h],
                              delta[b, h], terms) for h in range(H)] for b in range(B)]
    got = [np.array([[got[b][h][i] for h in range(H)] for b in range(B)]) for i in range(3)]
    return {"got": dict(zip(("dq", "dk", "dv"), got)),
            "want": dict(zip(("dq", "dk", "dv"), want)), "mask": mask}


@pytest.fixture(scope="module")
def cases():
    """Every (layout, mxu) case, the Pallas kernels in interpret mode (as the
    JAX package's own tests run them here), computed once."""
    interpret = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        return {(layout, mxu): _case(layout, mxu)
                for layout in ("ble", "bhld") for mxu in (False, True)}
    finally:
        jfa._INTERPRET = interpret


def test_bf16_rounding_is_to_nearest_even():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)  # bf16's unit in the last place at 1
    x = np.array([one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4], np.float32)
    np.testing.assert_array_equal(
        bf16_rne(x), np.array([one, one + 2 * ulp, -one, one, one + ulp], np.float32))


@pytest.mark.parametrize("scale", [1e-20, 1e-6, 1.0, 1e6, 1e20])
def test_three_terms_give_back_f32_exactly(scale):
    """(a): hi + mid + lo == x for f32 normals whose residuals stay normal
    (each term keeps the next 8 significant bits of the residual, which a
    bf16 rounding leaves exact); each term is a bf16 value; one term is x
    rounded to nearest even."""
    x = (np.random.RandomState(5).randn(200_000) * scale).astype(np.float32)
    hi, mid, lo = split(x, 3)
    for term in (hi, mid, lo):
        np.testing.assert_array_equal(bf16_rne(term), term)
    np.testing.assert_array_equal((hi.astype(np.float64) + mid + lo).astype(np.float32), x)
    assert np.all(hi.astype(np.float64) + mid + lo == x)
    np.testing.assert_array_equal(split(x, 1)[0], hi)


@pytest.mark.parametrize("mxu", [False, True], ids=["bf16", "mxu_bf16"])
@pytest.mark.parametrize("layout", ["ble", "bhld"])
@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_emulated_wgmma_tile_matches_pallas(name, layout, mxu, cases):
    """(b): the emulated tile against `_bwd_kernel_ble` (ble) or
    `_bwd_fused_kernel` (bhld), within one bf16 ulp of each row's largest
    entry; no valid key, or a masked key: exactly 0."""
    c = cases[layout, mxu]
    got, want = c["got"][name], c["want"][name]
    _assert_rows_within_ulps(torch.from_numpy(np.array(got)), torch.from_numpy(np.array(want)), 1,
                             f"{layout} {'mxu' if mxu else 'bf16'} {name}")
    assert np.all(got[0] == 0.0)
    if name != "dq":
        assert np.all(got.transpose(0, 2, 1, 3)[~c["mask"]] == 0.0)
