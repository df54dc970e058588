"""The precision argument of the tensor-core attention kernels (3xTF32).

All six attention kernels of gemm_gan_tpu_torch/kernels/csrc/ (the
forwards `flash_fwd_bhld` and `flash_fwd_ble`; the backwards `flash_bwd_ble`
(Q2), `flash_bwd_dq` (Q4), `flash_bwd_dkv` and `flash_bwd_bhld_fused`) run
every product on the tensor cores as mma.sync m16n8k8 with TF32 operands.
TF32 keeps 10 explicit mantissa bits, so each f32 operand x is split as
hi = rna_tf32(x), lo = rna_tf32(x - hi) and a.b is taken as lo.hi + hi.lo +
hi.hi, summed in f32 per k8 step (csrc/tf32x3.cuh). These tests emulate
exactly that arithmetic in numpy (no card needed) and pin:

(a) hi + lo gives back x to within 2^-21 relative;
(b) attention computed with the emulated products agrees with the JAX
    package, within chip_smoke.py's KERNEL_RTOL / KERNEL_ATOL, the
    tolerance the CUDA kernels are held to on the card: o with
    `mha_reference` and lse with the Pallas forward `_fwd_kernel` (classic
    layout), or both with `_fwd_kernel_ble` (the forward `flash_mha_ble`
    runs; the canonical case); dq, dk and dv with the Pallas backward that
    `_flash_core_bwd` takes (interpret mode, on the forward's own
    residuals): `_bwd_dq_kernel` (Q4's) / `_bwd_dkv_kernel` at the
    whole-slide length (B 1, H 1, L 4,097, D 64), `_bwd_fused_kernel` at
    the single-block lengths: a ragged case (L 200) and the canonical one
    (B 2, H 4, L 257), each with a ragged mask whose first sample has no
    valid key. The canonical case is the ble layout's: its emulated
    backward takes the ble forward's lse and delta = rowsum(dO * O) from
    that forward's o, as `flash_bwd_ble` computes it, and is held to
    `_bwd_kernel_ble` (Q2's, through `_flash_core_ble_bwd`) as well;
(c) the 3-term error is at least 10x smaller than that of single-pass TF32
    on the same inputs. Largest |error| against float64 at the whole-slide
    length, 3 terms vs 1: o 1.02e-7 vs 7.47e-5, dk 2.27e-7 vs 1.53e-4, dv
    1.37e-7 vs 1.07e-4, dq 1.41e-6 vs 1.31e-3 (printed by `PYTHONPATH=.
    python tests/test_torch_tf32x3.py`). That is why the kernels pay for
    three products.

The emulation takes the softmax as the plain version does (one pass, with
the row max), the products as the kernels do: the product of two TF32
values is exact in f32, and each mma adds its 8 products to the f32
accumulator with one round-to-nearest (the card's own accumulation is
coarser, PERF.md §6; chip_smoke.py's card check covers it). The sums over
keys (forward and dq) and over queries (dk/dv) are taken in a fresh
accumulator per tile, of the size the kernel at that case uses (CASES),
and added to the total in f32, as `tf32x3::weight_rows` does.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from gemm_gan_tpu.kernels import flash_attention as jfa

RTOL, ATOL = chip_smoke.KERNEL_RTOL, chip_smoke.KERNEL_ATOL
FWD_TILE_STEPS = 4   # 32-key tiles of the forward, in k8 steps
ROW_BLOCK = 1024     # rows emulated at a time (bounds the memory)


def tf32_rna(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    explicit mantissa bits (the low 13 bits of the f32 become 0)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(np.asarray(x, np.float32) - hi)


def emulated_matmul(a, b, terms=3, tile_steps=None):
    """a [M, K] @ b [K, N] as the kernels compute it: per k8 step, each
    product (lo.hi, hi.lo, hi.hi; or hi.hi alone for terms=1, single-pass
    TF32) summed exactly and added to the f32 accumulator with one
    rounding; with `tile_steps`, a fresh accumulator per tile of that many
    k8 steps, added to the total in f32."""
    pad = -a.shape[1] % 8
    a = np.pad(a.astype(np.float32), ((0, 0), (0, pad)))
    b = np.pad(b.astype(np.float32), ((0, pad), (0, 0)))
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = np.zeros_like(total)
    steps = a.shape[1] // 8
    for i in range(steps):
        ks = slice(8 * i, 8 * i + 8)
        for x, y in pairs:
            acc = (acc.astype(np.float64)
                   + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64)).astype(np.float32)
        if tile_steps and (i + 1) % tile_steps == 0 and i + 1 < steps:
            total += acc
            acc = np.zeros_like(total)
    return total + acc


def emulated_forward(q, k, v, valid, terms):
    """One (batch, head): q [Lq, D] (pre-scaled), k/v [Lk, D], valid [Lk]
    -> (o [Lq, D], lse [Lq]), the kernel's contract."""
    os_, lses = [], []
    for r in range(0, q.shape[0], ROW_BLOCK):
        s = np.where(valid[None], emulated_matmul(q[r:r + ROW_BLOCK], k.T, terms),
                     np.float32(-1e30))
        m = s.max(1, keepdims=True)
        p = np.exp(s - m)
        l = np.maximum(p.sum(1, keepdims=True), np.float32(1e-30))
        o = emulated_matmul(p, v, terms, FWD_TILE_STEPS) / l
        os_.append(np.where(m <= -0.5e30, np.float32(0), o))
        lses.append((m + np.log(l))[:, 0])
    return np.concatenate(os_), np.concatenate(lses)


def emulated_dkv(q, k, v, valid, do, lse, delta, terms, tile_steps):
    """One (batch, head) -> (dk, dv) [Lk, D], p by select on valid keys,
    the sums over queries with a fresh accumulator per tile of
    `tile_steps` k8 steps."""
    dks, dvs = [], []
    for r in range(0, k.shape[0], ROW_BLOCK):
        kv_valid = valid[r:r + ROW_BLOCK, None]
        s_t = emulated_matmul(k[r:r + ROW_BLOCK], q.T, terms)
        with np.errstate(over="ignore"):  # lse = -1e30 where no key is valid
            p_t = np.where(kv_valid, np.exp(s_t - lse[None]), np.float32(0))
        dvs.append(emulated_matmul(p_t, do, terms, tile_steps))
        ds_t = p_t * (emulated_matmul(v[r:r + ROW_BLOCK], do.T, terms) - delta[None])
        dks.append(emulated_matmul(ds_t, q, terms, tile_steps))
    return np.concatenate(dks), np.concatenate(dvs)


def emulated_dq(q, k, v, valid, do, lse, delta, terms, tile_steps):
    """One (batch, head) -> dq [Lq, D]: S and dP in 3xTF32, p by select on
    valid keys, dS.K with a fresh accumulator per key tile of `tile_steps`
    k8 steps."""
    dqs = []
    for r in range(0, q.shape[0], ROW_BLOCK):
        rows = slice(r, r + ROW_BLOCK)
        s = emulated_matmul(q[rows], k.T, terms)
        with np.errstate(over="ignore"):  # lse = -1e30 where no key is valid
            p = np.where(valid[None], np.exp(s - lse[rows, None]), np.float32(0))
        ds = p * (emulated_matmul(do[rows], v.T, terms) - delta[rows, None])
        dqs.append(emulated_matmul(ds, k, terms, tile_steps))
    return np.concatenate(dqs)


def _case(B, H, L, D, ragged, seed, layout, dq_steps, dkv_steps):
    """Inputs, the JAX package's results and both emulations for one case;
    the forward's reference is the `layout` kernel's, the backward's tiles
    (in k8 steps: keys per dq tile, queries per dk/dv tile) those of the
    kernel that the port runs there."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, L, D) * D ** -0.5).astype(np.float32)
    k, v, do = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(1, L + 1, B) if ragged else np.full(B, L)
    if ragged:
        lens[0] = 0
    mask = np.arange(L)[None, :] < lens[:, None]
    jq, jk, jv, jmask = map(jnp.asarray, (q, k, v, mask))
    _, res = jfa._flash_core_fwd(jq, jk, jv, jmask, 1.0, 512, 256, False)
    dq_ref, dk_ref, dv_ref, _ = jfa._flash_core_bwd(1.0, 512, 256, False, res,
                                                    jnp.asarray(do))
    lse = np.asarray(res[5])[:, :L, 0].reshape(B, H, L)
    if layout == "ble":  # [B, H, L, D] <-> [B, L, H * D]
        def ble(x):
            return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B, L, H * D))

        def heads(x):
            return np.asarray(x).reshape(B, L, H, D).transpose(0, 2, 1, 3)

        o_ble, res_ble = jfa._flash_core_ble_fwd(ble(q), ble(k), ble(v), jmask, 1.0, H, False)
        o_ref = heads(o_ble)
        lse_ref = np.asarray(res_ble[-1])[:, :, ::jfa._LANES].transpose(0, 2, 1)
        grads_ble = jfa._flash_core_ble_bwd(1.0, H, False, res_ble, ble(do))[:3]
        # flash_bwd_ble's inputs: the ble forward's lse, delta from its o
        lse, delta = lse_ref, (do * o_ref).sum(-1)
    else:
        o_ref = np.asarray(jfa.mha_reference(jq, jk, jv, jmask, scale=1.0))
        lse_ref = lse
        delta = (do * np.asarray(res[4])).sum(-1)
    got = {}
    for terms in (3, 1):
        fwd = [[emulated_forward(q[b, h], k[b, h], v[b, h], mask[b], terms)
                for h in range(H)] for b in range(B)]
        bwd = [[(emulated_dq(q[b, h], k[b, h], v[b, h], mask[b], do[b, h], lse[b, h],
                             delta[b, h], terms, dq_steps),
                 *emulated_dkv(q[b, h], k[b, h], v[b, h], mask[b], do[b, h], lse[b, h],
                               delta[b, h], terms, dkv_steps)) for h in range(H)]
               for b in range(B)]
        got[terms] = {name: np.array([[x[h][i] for h in range(H)] for x in part])
                      for part, names in ((fwd, ("o", "lse")), (bwd, ("dq", "dk", "dv")))
                      for i, name in enumerate(names)}
    want = {"o": o_ref, "lse": lse_ref, "dq": np.asarray(dq_ref), "dk": np.asarray(dk_ref),
            "dv": np.asarray(dv_ref)}
    if layout == "ble":
        want.update({name + "_ble": heads(x) for name, x in zip(("dq", "dk", "dv"), grads_ble)})
    return dict(q=q, k=k, v=v, mask=mask, do=do, got=got, want=want)


def _computed(label):
    """Case `label`, the Pallas kernels in interpret mode (as the JAX
    package's own tests run them here)."""
    interpret = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        return _case(*CASES[label])
    finally:
        jfa._INTERPRET = interpret


# (B, H, L, D, ragged, seed, layout, dq_steps, dkv_steps): flash_bwd_dq's
# 64-key and flash_bwd_dkv's 64-query tiles at the whole-slide length,
# flash_bwd_bhld_fused's 32-key and 64-query tiles, flash_bwd_ble's 32 and 32
CASES = {"whole_slide": (1, 1, 4097, 64, False, 0, "bhld", 8, 8),
         "ragged": (3, 2, 200, 64, True, 1, "bhld", 4, 8),
         "canonical": (2, 4, 257, 64, True, 3, "ble", 4, 4)}


@pytest.fixture(scope="module")
def whole_slide():
    return _computed("whole_slide")


@pytest.fixture(scope="module")
def ragged():
    return _computed("ragged")


@pytest.fixture(scope="module")
def canonical():
    return _computed("canonical")


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(x),
                                  np.array([one + ulp, -(one + ulp), one, one + ulp],
                                           np.float32))


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 1e3, 1e6])
def test_split_reconstructs_f32(scale):
    """(a): hi + lo is x to within 2^-21 relative (lo keeps 11 more bits)."""
    x = (np.random.RandomState(2).randn(100_000) * scale).astype(np.float32)
    hi, lo = split(x)
    assert np.all(tf32_rna(hi) == hi) and np.all(tf32_rna(lo) == lo)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_emulated_kernels_match_jax(label, name, request):
    """(b): o and lse vs the forward, dq, dk and dv vs the Pallas backward,
    within the kernels' card tolerance."""
    c = request.getfixturevalue(label)
    got, want = c["got"][3][name], c["want"][name]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=label)
    if CASES[label][4]:  # ragged: sample 0 has no valid key
        if name in ("dk", "dv"):
            assert np.all(got[0] == 0.0)
            assert np.all(got.transpose(0, 2, 1, 3)[~c["mask"]] == 0.0)
        if name in ("o", "dq"):
            assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_emulated_ble_backward_matches_pallas_ble(name, canonical):
    """(b) for Q2: the canonical case's emulated dq, dk and dv against
    `_bwd_kernel_ble`, on the ble forward's residuals, within the kernels'
    card tolerance; sample 0 (no valid key) and masked keys exactly 0."""
    got = canonical["got"][3][name]
    np.testing.assert_allclose(got, canonical["want"][name + "_ble"], rtol=RTOL, atol=ATOL)
    assert np.all(got[0] == 0.0)
    if name != "dq":
        assert np.all(got.transpose(0, 2, 1, 3)[~canonical["mask"]] == 0.0)


def _exact(c):
    """float64 o, dk, dv of the whole-slide case (all keys valid)."""
    q, k, v, do = (c[n][0, 0].astype(np.float64) for n in ("q", "k", "v", "do"))
    s = q @ k.T
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    o = p @ v
    ds = p * (do @ v.T - (do * o).sum(1, keepdims=True))
    return {"o": o, "dq": ds @ k, "dk": ds.T @ q, "dv": p.T @ do}


@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_three_terms_are_ten_times_closer_than_single_pass(name, whole_slide):
    """(c): against float64 at the whole-slide length, the 3-term
    products' largest error is at least 10x below single-pass TF32's."""
    c = whole_slide
    exact = _exact(c)[name]
    err3 = np.abs(c["got"][3][name][0, 0] - exact).max()
    err1 = np.abs(c["got"][1][name][0, 0] - exact).max()
    assert err3 * 10 <= err1, (name, err3, err1)


if __name__ == "__main__":  # print the errors quoted in the docstring
    c = _computed("whole_slide")
    for name, exact in _exact(c).items():
        print(name, *(f"{np.abs(c['got'][t][name][0, 0] - exact).max():.2e}" for t in (3, 1)))
