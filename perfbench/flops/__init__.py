"""The floating-point operations of the benchmark's work, from a
configuration's shapes: one module per architecture,
`flops/<architecture>.py`, found by the name a configuration file gives
(`spec.architecture_flops`). Each gives what its cells' kinds need (a
training cell: `train_step_flops(cfg, traffic)`) and `kernel_sites(cfg,
traffic)`, the attentions that the port routes to its flash kernels. The
arithmetic they share is here."""

from __future__ import annotations

from typing import Sequence


def mm(rows: int, n_in: int, n_out: int) -> int:
    """A [rows, n_in] x [n_in, n_out] product: 2 FLOP a multiply-add."""
    return 2 * rows * n_in * n_out


def dims(n_in: int, hidden: Sequence[int], n_out: int):
    """(in, out) of each Linear of a trunk."""
    d = [n_in, *hidden, n_out]
    return list(zip(d[:-1], d[1:]))


def expected_valid(lo: int, hi: int, take: int) -> float:
    """E[min(V, take)] for V uniform over the integers lo..hi: the valid
    patches a case keeps when `take` of its V valid slots are subsampled."""
    return sum(min(v, take) for v in range(lo, hi + 1)) / (hi - lo + 1)
