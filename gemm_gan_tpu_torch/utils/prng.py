"""Explicit random streams over `torch.Generator`.

Counterpart of `gemm_gan_tpu/utils/prng.py`. Threefry's numbers cannot be
reproduced, so the contract is kept: fresh streams from one seed, one per
leaf of a tree (JAX's leaf order: dict keys sorted, `None` an empty
subtree), and a step's stream from (seed, step) alone. Generators live on
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import hashlib

import torch

from gemm_gan_tpu_torch.utils.device import resolve_device


def _child(parent: torch.Generator) -> torch.Generator:
    """A fresh generator on `parent`'s device, seeded by one draw from it."""
    seed = int(torch.randint(2 ** 62, (1,), generator=parent, device=parent.device))
    return torch.Generator(parent.device).manual_seed(seed)


def key_seq(seed: int, device=None):
    """Infinite iterator of fresh generators, children of one seeded parent."""
    parent = torch.Generator(resolve_device(device)).manual_seed(seed)
    return iter(lambda: _child(parent), None)


def split_like(generator: torch.Generator, tree):
    """One fresh generator per leaf of `tree` (dicts, lists, tuples), drawn
    from `generator` in JAX's leaf order, returned as a matching tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: split_like(generator, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(split_like(generator, x) for x in tree)
    return _child(generator)


def step_key(generator_or_seed, step: int, device=None) -> torch.Generator:
    """Deterministic per-step generator: seeded with the first 8 bytes
    (little-endian) of BLAKE2b over "seed:step", the seed a generator's
    `initial_seed()`; consumes no generator state."""
    if isinstance(generator_or_seed, torch.Generator):
        seed, dev = generator_or_seed.initial_seed(), generator_or_seed.device
    else:
        seed, dev = int(generator_or_seed), resolve_device(device)
    digest = hashlib.blake2b(f"{seed}:{int(step)}".encode(), digest_size=8).digest()
    return torch.Generator(dev).manual_seed(int.from_bytes(digest, "little"))
