"""`jax.random`'s threefry-2x32 streams, in numpy.

The sampling contract of the sharded bank (`data.device_cache.
ShardedDeviceCache`) is the JAX package's, bit for bit: each shard's epoch
permutation and each batch's patch-subsampling scores come from keys folded
out of one seed. This module reproduces the few `jax.random` functions that
contract uses, with JAX's default implementation (threefry 2x32, the
`jax_threefry_partitionable` bit layout): `key`, `fold_in`, `split`,
`random_bits` (32-bit), `uniform` (float32 in [0, 1)) and `permutation`
(of `arange(n)`: rounds of stable sorts by fresh 32-bit keys). A key is a
pair of uint32. The work is a few vector passes over uint32 arrays on the
host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray):
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> Key:
    """`jax.random.key(seed)`'s data for a seed in [0, 2**31)."""
    return (_U32(0), _U32(seed & 0xFFFFFFFF))


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(k, data)`."""
    a, b = threefry2x32(k, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return (a[0], b[0])


def _counters(n: int):
    """A 64-bit iota of n as (high, low) uint32 halves."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: Key, num: int = 2):
    """`jax.random.split(k, num)` as a list of keys."""
    a, b = threefry2x32(k, *_counters(num))
    return [(a[i], b[i]) for i in range(num)]


def random_bits(k: Key, shape) -> np.ndarray:
    """32-bit `jax.random.bits(k, shape)`."""
    a, b = threefry2x32(k, *_counters(math.prod(shape)))
    return (a ^ b).reshape(shape)


def uniform(k: Key, shape) -> np.ndarray:
    """`jax.random.uniform(k, shape)` in float32: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(k, shape) >> _U32(9)) | _U32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0), np.float32(0.0))


def permutation(k: Key, n: int) -> np.ndarray:
    """`jax.random.permutation(k, n)`: arange(n) through
    ceil(3 ln n / ln(2**32 - 1)) stable sorts by fresh 32-bit keys."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x
