"""The collectives of the mesh paths, with their autograd rules.

Where XLA inserts the collectives that sharding annotations imply, the port
calls them itself, on the process group of one mesh axis
(`Mesh.groups`): all-reduce and all-gather, NCCL on the card and gloo on
the CPU. A one-rank axis without a process group (`groups[axis]` None) is
an identity.

Differentiable forms, for values replicated over `model` (every rank of
the axis computes the same loss from them, as JAX's global arrays are one
value):

* `copy_to(x)`: identity forward, all-reduce backward: a replicated input
  that each rank uses a different part of (Megatron's f);
* `reduce_from(x)`: all-reduce forward, identity backward: the sum of
  each rank's partial result (Megatron's g);
* `gather(x, dim)`: all-gather forward, this rank's slice backward.

Each backward calls the other Function, so the gradient penalty's second
derivative goes through them too. `all_reduce_sum` is the plain sum of
values that differ per rank with an all-reduce backward (BatchNorm's batch
statistics over `data`, whose losses differ per rank and are averaged with
the gradients).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    return mesh.groups.get(axis)


def _size(mesh, axis: str) -> int:
    return mesh.shape[axis]


def all_reduce_(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """In-place sum over `axis` (no autograd)."""
    g = _group(mesh, axis)
    if g is not None:
        dist.all_reduce(x, group=g)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in axis order (no autograd);
    every rank's `x` has the same shape."""
    g = _group(mesh, axis)
    if g is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def mean_over(tensors: Sequence[torch.Tensor], mesh, axis: str) -> List[torch.Tensor]:
    """`tensors` averaged over `axis`, in one all-reduce of a flat buffer:
    they are copied into views of it with one `_foreach_copy_` (on an H100,
    `chip_smoke.py` phase 17 (c): `torch.cat` of a step's gradients took
    0.98 ms a step, the foreach copy 0.17), and the averaged views are
    returned."""
    g = _group(mesh, axis)
    if g is None:
        return list(tensors)
    flat = torch.empty(sum(t.numel() for t in tensors), dtype=tensors[0].dtype,
                       device=tensors[0].device)
    views = [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
    torch._foreach_copy_(views, list(tensors))
    dist.all_reduce(flat, group=g)
    flat.div_(_size(mesh, axis))
    return views


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFrom.apply(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _CopyTo.apply(g, ctx.mesh, ctx.axis), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axis) if _group(mesh, axis) is not None else x


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axis) if _group(mesh, axis) is not None else x


def all_reduce_sum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    return _AllReduceSum.apply(x, mesh, axis) if _group(mesh, axis) is not None else x


def gather(x: torch.Tensor, mesh, axis: str = "model", dim: int = -1) -> torch.Tensor:
    dim = dim % x.dim()
    return _Gather.apply(x, mesh, axis, dim) if _group(mesh, axis) is not None else x


class _Rotate(torch.autograd.Function):
    """Send each tensor to the next rank of the axis and receive the
    previous rank's (ring order); the backward sends the gradients the
    other way round, as `lax.ppermute`'s transpose."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(rotate(list(xs), mesh, axis, +1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *rotate(list(gs), ctx.mesh, ctx.axis, -1))


def rotate(xs: List[torch.Tensor], mesh, axis: str, step: int) -> List[torch.Tensor]:
    """Each of `xs` from the rank `step` places back on the axis' ring (no
    autograd)."""
    ranks = mesh.ranks[axis]
    n, i = len(ranks), mesh.index(axis)
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    g = _group(mesh, axis)
    xs = [x.contiguous() for x in xs]
    out = [torch.empty_like(x) for x in xs]
    ops = []
    for x, o in zip(xs, out):
        ops.append(dist.P2POp(dist.isend, x, dst, g))
        ops.append(dist.P2POp(dist.irecv, o, src, g))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def rotate_ring(xs: Sequence[torch.Tensor], mesh, axis: str = "model"):
    """Differentiable `rotate(xs, +1)` of float tensors."""
    return _Rotate.apply(mesh, axis, *xs)


def broadcast_object(obj, mesh):
    """Rank 0's `obj` (a picklable host value) on every rank of the mesh."""
    if mesh is None or not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
