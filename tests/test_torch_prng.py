"""`gemm_gan_tpu_torch.utils.prng` against the contract of
`gemm_gan_tpu.utils.prng` (threefry's numbers cannot be matched): fresh
independent streams from one seed, one stream per leaf of a tree in JAX's
leaf order and structure, and a step's stream from (seed, step) alone.
Exact checks (integers and bitwise draws), no tolerance."""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import hashlib

import jax
import pytest
import torch

import gemm_gan_tpu.utils as jutils
from gemm_gan_tpu.utils import prng as jprng
from gemm_gan_tpu_torch import utils as tutils
from gemm_gan_tpu_torch.utils import prng

TREE = {"b": [1, None, (2, 3)], "a": {"y": 4, "x": 5}, "c": None, "d": ()}


def _draw(g: torch.Generator) -> torch.Tensor:
    return torch.randn(8, generator=g, device=g.device)


def test_utils_export_what_the_jax_package_exports():
    for name in ("key_seq", "split_like"):
        assert hasattr(jutils, name) and getattr(tutils, name) is getattr(prng, name)


def test_key_seq_is_deterministic_and_its_streams_are_fresh():
    a = [_draw(next(it)) for it in [prng.key_seq(3, device="cpu")] for _ in range(4)]
    b = [_draw(g) for g, _ in zip(prng.key_seq(3, device="cpu"), range(4))]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i in range(4):  # distinct streams within one sequence and across seeds
        assert all(not torch.equal(a[i], a[j]) for j in range(i))
    other = _draw(next(prng.key_seq(4, device="cpu")))
    assert not any(torch.equal(other, x) for x in a)


def test_split_like_keeps_jax_structure_and_leaf_order():
    g = torch.Generator().manual_seed(11)
    out = prng.split_like(g, TREE)
    want = jax.tree_util.tree_structure(jprng.split_like(jax.random.key(0), TREE))
    assert jax.tree_util.tree_structure(out) == want
    leaves = jax.tree_util.tree_leaves(out)
    assert len(leaves) == len(jax.tree_util.tree_leaves(TREE)) == 5
    # leaf i takes the i-th seed drawn from the parent, in JAX's flatten order
    seeds = torch.randint(2 ** 62, (5,), generator=torch.Generator().manual_seed(11)).tolist()
    assert [leaf.initial_seed() for leaf in leaves] == seeds
    assert out["c"] is None and out["b"][1] is None and out["d"] == ()
    # the parent advanced: a second split gives other streams
    again = jax.tree_util.tree_leaves(prng.split_like(g, TREE))
    assert not any(torch.equal(_draw(x), _draw(y)) for x, y in zip(leaves, again))


def test_step_key_reads_only_seed_and_step():
    g = torch.Generator().manual_seed(7)
    first = _draw(prng.step_key(g, 3))
    _draw(g)  # consuming the generator's state changes nothing
    assert torch.equal(_draw(prng.step_key(g, 3)), first)
    assert torch.equal(_draw(prng.step_key(7, 3, device="cpu")), first)
    assert not torch.equal(_draw(prng.step_key(7, 4, device="cpu")), first)
    assert not torch.equal(_draw(prng.step_key(8, 3, device="cpu")), first)
    # the stated hash: BLAKE2b-64 of "seed:step", little-endian
    digest = hashlib.blake2b(b"7:3", digest_size=8).digest()
    assert prng.step_key(7, 3, device="cpu").initial_seed() == int.from_bytes(digest, "little")


def test_streams_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.key_seq(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.step_key(0, 1)
