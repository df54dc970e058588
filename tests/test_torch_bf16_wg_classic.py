"""The arithmetic of the bf16-ref modes of Q1, Q3, Q4 and Q5 on the
warpgroup-MMA tiles, emulated in numpy.

`flash_fwd_bhld_bf16` / `flash_fwd_bhld_mxu` (Q3) and `flash_fwd_ble_mxu`
(Q1, the same tile in the [B, L, H*D] strides; both csrc/flash_fwd_wg.cuh;
Q1's bf16 mode ships on the mma.sync tile, and its route onto this one is
a variant of scripts/torch_kernel_variants.py, emulated here too),
`flash_bwd_dq_bf16` / `flash_bwd_dq_mxu` (Q4, the
dq tile of csrc/flash_bwd_wg.cuh) and `flash_bwd_dkv_bf16` /
`flash_bwd_dkv_mxu` (Q5, its dk/dv tile) take their products on wgmma
m64nNk16: bf16 operands, each k16 step's 16 products exact in f32 and added
to the f32 accumulator with one rounding (test_torch_bf16_split's
`emulated_product`). q, k, v and dO are bf16 already; P (and dS) are f32
and go in as three bf16 terms in the bf16 mode, rounded once under
`mxu_bf16`.

The forward tile streams 128-key steps: S = Q.K^T, masked keys -1e30 by
select, the online softmax (m, l in f32) and O += P.V into the same
accumulator, o rounded once at the store. Under `mxu_bf16` P is rounded
per key block (ROADMAP F4): 256 keys from key 0 when the 128-padded Lk
exceeds 512, else one block of every key; a block of more than one tile is
taken twice (its K alone, 256 keys a step, for its row max, then K and V
with P = exp(s - the running max at the block's end), l summing the
unrounded p). The ble kernel rounds P in one block of every key (its Lk is
at most 512), so under `mxu_bf16` the tile takes each row's max over all
keys first, as `_fwd_kernel_ble`'s exp(s - max over all keys). The dk/dv
tile streams 64-query steps in 32-query sub-steps into dK, dV, and the dq
tile (Q4) DQ_KEYS-key steps in DQ_SUB-key sub-steps into dQ: the sums over
the queries (keys) in k16 order, as `emulated_backward` takes them, which a
step size of whole k16 steps leaves as they are.

The emulations are held against the JAX package's Pallas kernels in
interpret mode (as its own tests run them here) on the same seeded numpy
inputs with bf16 refs, D 64: `_fwd_kernel` through `_flash_core_fwd` with
`flash_mha`'s blocking (512 query rows, 256 keys) at L 600 (three key
blocks, the last one short) and L 257 (one block), `_bwd_dq_kernel` and
`_bwd_dkv_kernel` through `_flash_core_bwd` at L 600 (ten key and ten query
steps), and `_fwd_kernel_ble` through `_flash_core_ble_fwd` at L 257 and at
Lq 300 / Lk 257, within the card's gate: one bf16 ulp of each row's largest
entry, lse within 1e-5. The mask is ragged and its first sample has no
valid key: that sample's o, dq, dk and dv, and every masked key's dk and
dv, are exactly 0.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.kernels import flash_attention as jfa
from test_torch_bf16 import LSE_ATOL, _assert_rows_within_ulps
from test_torch_bf16_split import K_STEP, bf16_rne, emulated_backward, emulated_product, split

B, H, D = 2, 2, 64
KEYS = 128      # keys per step of the forward tile (flash_fwd_wg::kKeys)
DQ_KEYS = 64    # keys per step of Q4's dq tile (flash_bwd_wg::kKeys)
DQ_SUB = 64     # keys per product sub-step of a dq step (flash_bwd_dq.cuh kWgSubKeys)
PASS1_TILES = 2  # key tiles per first-pass step (flash_fwd_wg::kPass1Tiles)
BLOCK_K = 256   # keys per block of mxu_bf16's rounded P, long Lk
NEG_INF = np.float32(-1e30)
F32_ATOL, FLIP_SHARE = 1e-5, 5e-3  # test_torch_bf16_bhld's, for an f32 o under mxu_bf16
BLE_LENGTHS = ((257, 257), (300, 257))
ONE_PASS_MISS = 0.5  # the share of entries P from each step's running max misses F32_ATOL on  # Q1's (Lq, Lk): the patch self-attention; text over patches


def block_tiles(lk: int, mxu: bool, ble: bool = False) -> int:
    """Key tiles per block of mxu_bf16's rounded P (every tile if one block:
    always in the ble layout)."""
    n_tiles = -(-lk // KEYS)
    return BLOCK_K // KEYS if mxu and not ble and -(-lk // 128) * 128 > 512 else n_tiles


def forward_steps(lk: int, mxu: bool, ble: bool = False):
    """The forward tile's steps (flash_fwd_wg::tile's step_of) in order:
    (its key tiles, whether it takes V). A first-pass step takes the K of
    up to PASS1_TILES tiles of its block, a P.V step one tile."""
    n_tiles, bt = -(-lk // KEYS), block_tiles(lk, mxu, ble)
    if not (mxu and bt > 1):
        return [((tile,), True) for tile in range(n_tiles)]
    steps = []
    for b0 in range(0, n_tiles, bt):
        block = tuple(range(b0, min(b0 + bt, n_tiles)))
        steps += [(block[i:i + PASS1_TILES], False) for i in range(0, len(block), PASS1_TILES)]
        steps += [((tile,), True) for tile in block]
    return steps


def _accumulate(acc, a_terms, b):
    """acc + sum over the terms of a_term [M, K] @ b [K, N], per k16 step
    each term's products (the small terms first) added with one rounding."""
    pad = -b.shape[0] % K_STEP
    b = np.pad(b.astype(np.float32), ((0, pad), (0, 0))).astype(np.float64)
    a_terms = [np.pad(a.astype(np.float32), ((0, 0), (0, pad))).astype(np.float64)
               for a in a_terms]
    for i in range(b.shape[0] // K_STEP):
        ks = slice(K_STEP * i, K_STEP * (i + 1))
        for a in reversed(a_terms):
            acc = (acc.astype(np.float64) + a[:, ks] @ b[ks]).astype(np.float32)
    return acc


def emulated_forward(q, k, v, valid, mxu, ble=False, one_pass=False):
    """One (batch, head): q [Lq, D], k, v [Lk, D] (bf16 values), valid [Lk]
    -> (o rounded to bf16, lse, o in f32 before that rounding). `ble`: the
    ble kernel's key blocks; `one_pass` (not a tile's rule, a foil): under
    mxu_bf16 no first pass, P rounded from each step's running max."""
    lq, lk = q.shape[0], k.shape[0]
    terms = 1 if mxu else 3
    s_all = np.where(valid[None], emulated_product([q], k.T), NEG_INF).astype(np.float32)
    o = np.zeros((lq, D), np.float32)
    m = np.full(lq, NEG_INF, np.float32)
    l = np.zeros(lq, np.float32)
    bm = np.full(lq, NEG_INF, np.float32)
    bt = block_tiles(lk, mxu, ble)
    two_pass = mxu and bt > 1 and not one_pass
    for tiles, pv in forward_steps(lk, mxu and not one_pass, ble):
        tile = tiles[0]
        keys = slice(tile * KEYS, min((tiles[-1] + 1) * KEYS, lk))
        if two_pass and pv and tile % bt == 0:  # the block's row max is known
            mx = np.maximum(m, bm)
            alpha = np.exp(m - mx).astype(np.float32)
            m, l, o = mx, (l * alpha).astype(np.float32), (o * alpha[:, None]).astype(np.float32)
            bm = np.full(lq, NEG_INF, np.float32)
        if not valid[keys].any():
            continue  # a step whose keys are all masked is skipped
        s = s_all[:, keys]
        if not pv:
            bm = np.maximum(bm, s.max(1))
            continue
        if not two_pass:  # the online softmax
            mx = np.maximum(m, s.max(1))
            alpha = np.exp(m - mx).astype(np.float32)
            m, l, o = mx, (l * alpha).astype(np.float32), (o * alpha[:, None]).astype(np.float32)
        p = np.exp(s - m[:, None]).astype(np.float32)
        l = (l + p.sum(1, dtype=np.float32)).astype(np.float32)
        o = _accumulate(o, split(p, terms), v[keys])
    lc = np.maximum(l, np.float32(1e-30))
    empty = m <= NEG_INF / 2
    o = np.where(empty[:, None], np.float32(0), o / lc[:, None])
    return bf16_rne(o), (m + np.log(lc)).astype(np.float32), o.astype(np.float32)


def emulated_dq_tile(q, k, v, valid, do, lse, delta, terms, keys=DQ_KEYS, sub=DQ_SUB):
    """One (batch, head) of the dq tile, step by step: keys in steps of
    `keys` (a step whose keys are all masked skipped), each in sub-steps of
    `sub` keys past Lk left out: S = Q.K^T and dP = dO.V^T of the sub-step,
    P = exp(S - lse) on valid keys (else 0), dS = P (dP - delta), dQ += dS.K
    with dS in `terms` bf16 terms, into one accumulator; dq rounded to bf16
    once."""
    lq, lk = q.shape[0], k.shape[0]
    acc = np.zeros((lq, D), np.float32)
    for s0 in range(0, lk, keys):
        if not valid[s0:s0 + keys].any():
            continue
        for c0 in range(s0, min(s0 + keys, lk), sub):
            ks = slice(c0, min(c0 + sub, lk))
            with np.errstate(over="ignore"):  # lse = -1e30 where no key is valid
                p = np.where(valid[None, ks], np.exp(emulated_product([q], k[ks].T) - lse[:, None]),
                             np.float32(0)).astype(np.float32)
            ds = (p * (emulated_product([do], v[ks].T) - delta[:, None])).astype(np.float32)
            acc = _accumulate(acc, split(ds, terms), k[ks])
    return bf16_rne(acc)


def _inputs(L, seed):
    rng = np.random.RandomState(seed)
    q = bf16_rne(rng.randn(B, H, L, D) * D ** -0.5)
    k = rng.randn(B, H, L, D).astype(np.float32)
    k[:, :, 300:] *= 1.8  # the running max grows past the first key block
    k, v, do = bf16_rne(k), bf16_rne(rng.randn(B, H, L, D)), bf16_rne(rng.randn(B, H, L, D))
    lens = rng.randint(1, L + 1, B)
    lens[0] = 0  # sample 0 has no valid key
    mask = np.arange(L)[None, :] < lens[:, None]
    return q, k, v, do, mask


def _case(L, mxu):
    """The emulated tiles' outputs and the Pallas kernels', [B, H, L, ...]."""
    q, k, v, do, mask = _inputs(L, L)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    o, res = jfa._flash_core_fwd(*bf[:3], jnp.asarray(mask), 1.0, 512, 256, mxu)
    lse = np.asarray(res[5])[:, :L, 0].reshape(B, H, L)
    want = {"o": np.asarray(o.astype(jnp.float32)), "lse": lse}
    fwd = [[emulated_forward(q[b, h], k[b, h], v[b, h], mask[b], mxu) for h in range(H)]
           for b in range(B)]
    got = {"o": np.array([[x[0] for x in row] for row in fwd]),
           "lse": np.array([[x[1] for x in row] for row in fwd]),
           "o_f32": np.array([[x[2] for x in row] for row in fwd])}
    if mxu:  # the same bf16 values as f32 refs: `_mxu_in` rounds nothing but P, o stays f32
        want["o_f32"] = np.asarray(jfa._flash_core_fwd(
            *(jnp.asarray(x, jnp.float32) for x in (q, k, v)), jnp.asarray(mask), 1.0, 512,
            256, True)[0])
    if -(-L // 128) * 128 > 512:  # the blocked backward: the dq and dk/dv kernels
        dq, dk, dv = jfa._flash_core_bwd(1.0, 512, 256, mxu, res, bf[3])[:3]
        want.update(dq=np.asarray(dq.astype(jnp.float32)), dk=np.asarray(dk.astype(jnp.float32)),
                    dv=np.asarray(dv.astype(jnp.float32)))
        delta = (do * want["o"]).sum(-1, dtype=np.float32)
        terms = 1 if mxu else 3
        grads = [[emulated_backward(q[b, h], k[b, h], v[b, h], mask[b], do[b, h], lse[b, h],
                                    delta[b, h], terms) for h in range(H)] for b in range(B)]
        got.update({name: np.array([[x[i] for x in row] for row in grads])
                    for i, name in enumerate(("dq_all_keys", "dk", "dv"))})
        got["dq"] = np.array([[emulated_dq_tile(q[b, h], k[b, h], v[b, h], mask[b], do[b, h],
                                                lse[b, h], delta[b, h], terms) for h in range(H)]
                              for b in range(B)])
    return {"got": got, "want": want, "mask": mask}


def _ble(x):  # [B, H, L, D] -> [B, L, H * D]
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1))


def _ble_case(lq, lk, mxu):
    """Q1: the emulated tile in the ble layout's key blocks and
    `_fwd_kernel_ble`'s outputs, [B, H, Lq, ...]; keys from 130 on are
    larger, and every sample but the first (no valid key) has valid keys
    past them, so that a row's running max grows after the first 128-key
    step."""
    rng = np.random.RandomState(lq + lk)
    q = bf16_rne(rng.randn(B, H, lq, D) * D ** -0.5)
    k = rng.randn(B, H, lk, D).astype(np.float32)
    k[:, :, 130:] *= 1.8
    k, v = bf16_rne(k), bf16_rne(rng.randn(B, H, lk, D))
    lens = rng.randint(131, lk + 1, B)
    lens[0] = 0  # sample 0 has no valid key
    mask = np.arange(lk)[None, :] < lens[:, None]

    def pallas(dtype):
        o, res = jfa._flash_core_ble_fwd(*(jnp.asarray(_ble(x), dtype) for x in (q, k, v)),
                                         jnp.asarray(mask), 1.0, H, mxu)
        o = np.asarray(o.astype(jnp.float32)).reshape(B, lq, H, D).transpose(0, 2, 1, 3)
        return o, np.asarray(res[5])[:, :, ::jfa._LANES].transpose(0, 2, 1)

    o, lse = pallas(jnp.bfloat16)
    want = {"o": o, "lse": lse}
    if mxu:  # f32 refs holding the same bf16 values: P is rounded, o stays f32
        want["o_f32"] = pallas(jnp.float32)[0]
    got = {}
    for key, one_pass in (("", False), ("_one_pass", True)):
        fwd = [[emulated_forward(q[b, h], k[b, h], v[b, h], mask[b], mxu, ble=True,
                                 one_pass=one_pass) for h in range(H)] for b in range(B)]
        got.update({name + key: np.array([[x[i] for x in row] for row in fwd])
                    for i, name in enumerate(("o", "lse", "o_f32"))})
    return {"got": got, "want": want, "mask": mask}


@pytest.fixture(scope="module")
def cases():
    """Every (L, mxu) case of the classic layout and every ((Lq, Lk), mxu)
    one of the ble layout, the Pallas kernels in interpret mode, computed
    once."""
    interpret = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        return {**{(L, mxu): _case(L, mxu) for L in (257, 600) for mxu in (False, True)},
                **{(lengths, mxu): _ble_case(*lengths, mxu)
                   for lengths in BLE_LENGTHS for mxu in (False, True)}}
    finally:
        jfa._INTERPRET = interpret


def test_forward_steps_follow_the_key_blocks():
    """L 600 under mxu_bf16: blocks of 2, 2 and 1 tiles of 128 keys, each
    block's K first (one step), then its tiles' K and V; L 257 (128-padded
    384 <= 512): one block of 3 tiles, its K in two steps; the bf16 mode
    takes each tile once."""
    assert forward_steps(600, True) == [
        ((0, 1), False), ((0,), True), ((1,), True), ((2, 3), False), ((2,), True),
        ((3,), True), ((4,), False), ((4,), True)]
    assert forward_steps(257, True) == [
        ((0, 1), False), ((2,), False), ((0,), True), ((1,), True), ((2,), True)]
    assert forward_steps(600, False) == [((t,), True) for t in range(5)]
    assert forward_steps(100, True) == [((0,), True)]  # one tile: the online softmax's step


@pytest.mark.parametrize("mxu", [False, True], ids=["bf16", "mxu_bf16"])
@pytest.mark.parametrize("L", [257, 600])
def test_emulated_forward_tile_matches_pallas(L, mxu, cases):
    """o within one bf16 ulp of each row's largest entry of `_fwd_kernel`'s,
    lse within LSE_ATOL; the sample with no valid key: o exactly 0."""
    c = cases[L, mxu]
    got, want = c["got"], c["want"]
    _assert_rows_within_ulps(torch.tensor(got["o"]), torch.tensor(want["o"]), 1,
                             f"L {L} {'mxu' if mxu else 'bf16'} o")
    np.testing.assert_allclose(got["lse"], want["lse"], rtol=0, atol=LSE_ATOL)
    assert np.all(got["o"][0] == 0.0)


@pytest.mark.parametrize("L", [257, 600])
def test_emulated_forward_rounds_p_per_key_block(L, cases):
    """F4 at the tile's own steps: under `mxu_bf16` the emulated o before
    its bf16 rounding against `_fwd_kernel` on f32 refs holding the same
    bf16 values (o in f32) within F32_ATOL on all but FLIP_SHARE of the
    entries (a P within an f32 ulp of a bf16 rounding boundary may round to
    the neighbouring value on either side, as in test_torch_bf16_bhld);
    rounding exp(s - the running max of each 128-key step) instead misses
    F32_ATOL on most entries at L 600."""
    c = cases[L, True]
    beyond = np.abs(c["got"]["o_f32"] - c["want"]["o_f32"]) > F32_ATOL
    assert beyond.mean() <= FLIP_SHARE, beyond.mean()


@pytest.mark.parametrize("mxu", [False, True], ids=["bf16", "mxu_bf16"])
@pytest.mark.parametrize("name", ["dk", "dv"])
def test_emulated_dkv_tile_matches_pallas(name, mxu, cases):
    """L 600 (ten 64-query steps): dk and dv within one bf16 ulp of each
    row's largest entry of `_bwd_dkv_kernel`'s; the sample with no valid key
    and every masked key: exactly 0."""
    c = cases[600, mxu]
    got, want = c["got"][name], c["want"][name]
    _assert_rows_within_ulps(torch.tensor(got), torch.tensor(want), 1,
                             f"{'mxu' if mxu else 'bf16'} {name}")
    assert np.all(got[0] == 0.0)
    assert np.all(got.transpose(0, 2, 1, 3)[~c["mask"]] == 0.0)


def test_dq_tile_steps_keep_the_sums_of_all_keys(cases):
    """Q4's steps of DQ_KEYS keys in sub-steps of DQ_SUB, at L 600 (ten
    steps, the last of 24 keys; masked steps skipped), give the dq of one
    pass over all keys in k16 order bit for bit, in both modes."""
    for mxu in (False, True):
        got = cases[600, mxu]["got"]
        np.testing.assert_array_equal(got["dq"], got["dq_all_keys"])


@pytest.mark.parametrize("mxu", [False, True], ids=["bf16", "mxu_bf16"])
def test_emulated_dq_tile_matches_pallas(mxu, cases):
    """L 600: the dq tile's dq within one bf16 ulp of each row's largest
    entry of `_bwd_dq_kernel`'s; the sample with no valid key: exactly 0."""
    c = cases[600, mxu]
    got, want = c["got"]["dq"], c["want"]["dq"]
    _assert_rows_within_ulps(torch.tensor(got), torch.tensor(want), 1,
                             f"{'mxu' if mxu else 'bf16'} dq")
    assert np.all(got[0] == 0.0)


def test_ble_forward_steps_take_one_block_of_every_key():
    """The ble kernel's key blocks: under mxu_bf16 every Lk up to 512 is one
    block, its K in first-pass steps of 256 keys, then each 128-key tile."""
    assert forward_steps(257, True, ble=True) == forward_steps(257, True)
    assert forward_steps(512, True, ble=True) == [
        ((0, 1), False), ((2, 3), False), ((0,), True), ((1,), True), ((2,), True), ((3,), True)]
    assert forward_steps(512, False, ble=True) == [((t,), True) for t in range(4)]


@pytest.mark.parametrize("mxu", [False, True], ids=["bf16", "mxu_bf16"])
@pytest.mark.parametrize("lengths", BLE_LENGTHS, ids=lambda x: f"Lq{x[0]}-Lk{x[1]}")
def test_emulated_ble_forward_tile_matches_pallas(lengths, mxu, cases):
    """Q1: o within one bf16 ulp of each row's largest entry of
    `_fwd_kernel_ble`'s, lse within LSE_ATOL; the sample with no valid
    key: o exactly 0."""
    c = cases[lengths, mxu]
    got, want = c["got"], c["want"]
    _assert_rows_within_ulps(torch.tensor(got["o"]), torch.tensor(want["o"]), 1,
                             f"ble {lengths} {'mxu' if mxu else 'bf16'} o")
    np.testing.assert_allclose(got["lse"], want["lse"], rtol=0, atol=LSE_ATOL)
    assert np.all(got["o"][0] == 0.0)


@pytest.mark.parametrize("lengths", BLE_LENGTHS, ids=lambda x: f"Lq{x[0]}-Lk{x[1]}")
def test_emulated_ble_forward_rounds_p_from_the_max_over_all_keys(lengths, cases):
    """Under mxu_bf16, o before its bf16 rounding against `_fwd_kernel_ble`
    on f32 refs holding the same bf16 values (o in f32): within F32_ATOL on
    all but FLIP_SHARE of the entries (as the classic tile's F4 test), while
    P rounded from each 128-key step's running max (no first pass) misses
    F32_ATOL on most entries: the first pass over every key is what makes
    the tile's P the kernel's exp(s - max over all keys)."""
    c = cases[lengths, True]
    want = c["want"]["o_f32"]
    valid_rows = c["mask"].any(1)
    beyond = np.abs(c["got"]["o_f32"] - want) > F32_ATOL
    assert beyond.mean() <= FLIP_SHARE, beyond.mean()
    foil = np.abs(c["got"]["o_f32_one_pass"] - want) > F32_ATOL
    assert foil[valid_rows].mean() >= ONE_PASS_MISS, foil[valid_rows].mean()
