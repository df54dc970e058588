"""Sharding rules: batch over `data`, the gene-dimension matmuls over `model`.

Counterpart of `gemm_gan_tpu/parallel/sharding.py`. The two matmuls that
touch the gene dimension, the generator's output projection and the
critic's input projection [n_genes (+ cond)] -> hidden, are sharded over
`model`; everything else is replicated, and the batch is split over
`data`. A spec is JAX's `PartitionSpec` as a tuple, one entry per
dimension: `("model", None)` shards dimension 0 over `model`, `()` is
replicated.

The rule is JAX's `_spec_for_param` over the port's names and layout: a
torch `Linear.weight` is [out, in] where a Flax kernel is [in, out], so the
generator's output projection is `weight.shape[0] == n_genes` (its rows,
and its bias, sharded: column-parallel, the gene outputs all-gathered) and
the critic's input projection `weight.shape[1] >= n_genes` (its columns
sharded: row-parallel, each rank's partial product all-reduced, the bias
added after). As in JAX, the rule reads shapes, so at tiny widths it may
pick another Linear whose input is at least as wide as the genes; that one
is computed the same way.

`shard_module_` turns a model's full parameters into this rank's shards in
place (`ops.linear.Linear.parallel`); optimizer moments and the EMA made
afterwards are sharded like them. `shard_state_dict` / `gather_state_dict`
go between a full state dict and this rank's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gemm_gan_tpu_torch.ops.linear import Linear
from gemm_gan_tpu_torch.parallel import comm

Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()


def spec_for_param(name: str, ndim: int, gene_dim: int, shape) -> Spec:
    """Tensor-parallel rule keyed on a Linear parameter's name and shape."""
    if name.endswith("weight") and ndim == 2:
        if shape[0] == gene_dim:   # generator output projection: shard the out rows
            return ("model", None)
        if shape[1] >= gene_dim:   # critic input projection: shard the in columns
            return (None, "model")
    if name.endswith("bias") and ndim == 1 and shape[0] == gene_dim:
        return ("model",)
    return REPLICATED


def param_shardings(mesh, module: nn.Module, gene_dim: int) -> Dict[str, Spec]:
    """The spec of every parameter of a full (unsharded) module: the rule
    for the Linears' weights and biases, replicated for the rest. (`mesh`
    is JAX's argument; a spec names its axes itself.)"""
    specs = {name: REPLICATED for name, _ in module.named_parameters()}
    for mname, mod in module.named_modules():
        if isinstance(mod, Linear):
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mname}.{pname}" if mname else pname
                specs[name] = spec_for_param(name, p.dim(), gene_dim, tuple(p.shape))
    return specs


def replicated(mesh) -> Spec:
    return REPLICATED


def batch_sharding(mesh) -> Spec:
    """Leading-axis batch sharding over the data axis."""
    return ("data",)


def _dim(spec: Spec) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == "model"), None)


def shard_tensor(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of `full` under `spec`."""
    d = _dim(spec)
    if d is None:
        return full
    M = mesh.shape["model"]
    if full.shape[d] % M:
        raise ValueError(f"dimension {d} of a {tuple(full.shape)} parameter is not "
                         f"divisible by the model axis ({M})")
    n = full.shape[d] // M
    return full.narrow(d, mesh.index("model") * n, n)


def gather_tensor(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (a collective over `model`)."""
    d = _dim(spec)
    return local if d is None else comm.all_gather(local, mesh, "model", d)


def shard_module_(module: nn.Module, mesh, gene_dim: int) -> nn.Module:
    """Replace, in place, the parameters the rule shards by this rank's
    blocks and mark their Linears column- or row-parallel. A one-rank
    `model` axis shards nothing (a one-rank shard is the whole tensor)."""
    if mesh.shape["model"] == 1:
        return module
    for mname, mod in module.named_modules():
        if not isinstance(mod, Linear):
            continue
        wspec = spec_for_param("weight", 2, gene_dim, tuple(mod.weight.shape))
        if wspec == REPLICATED:
            continue
        column = wspec == ("model", None)
        with torch.no_grad():
            mod.weight = nn.Parameter(shard_tensor(mod.weight, wspec, mesh).clone())
            if column:
                mod.bias = nn.Parameter(shard_tensor(mod.bias, ("model",), mesh).clone())
        mod.parallel = ("column" if column else "row", mesh)
    return module


def tp_specs(module: nn.Module) -> Dict[str, Spec]:
    """The spec of every parameter of a module after `shard_module_`."""
    specs = {name: REPLICATED for name, _ in module.named_parameters()}
    for mname, mod in module.named_modules():
        if isinstance(mod, Linear) and mod.parallel is not None:
            prefix = f"{mname}." if mname else ""
            column = mod.parallel[0] == "column"
            specs[prefix + "weight"] = ("model", None) if column else (None, "model")
            if column:
                specs[prefix + "bias"] = ("model",)
    return specs


def sharded_flags(module: nn.Module):
    """For each of `module.parameters()`, in order: is it sharded?"""
    specs = tp_specs(module)
    return [specs[name] != REPLICATED for name, _ in module.named_parameters()]


def shard_state_dict(full: Mapping[str, torch.Tensor], module: nn.Module,
                     mesh) -> Dict[str, torch.Tensor]:
    """This rank's state dict of `module` (sharded) from a full one."""
    specs = tp_specs(module)
    return {k: shard_tensor(v, specs.get(k, REPLICATED), mesh) for k, v in full.items()}


def gather_state_dict(module: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded `module` (a collective over
    `model`: every rank calls it)."""
    specs = tp_specs(module)
    return {k: gather_tensor(v, specs.get(k, REPLICATED), mesh)
            for k, v in module.state_dict().items()}


def load_full_state_dict_(module: nn.Module, full: Mapping[str, torch.Tensor],
                          mesh=None) -> nn.Module:
    """Load a full state dict into `module`, sharded when it is."""
    module.load_state_dict(full if mesh is None else shard_state_dict(full, module, mesh))
    return module


def batch_rows(x, mesh, dim: int = 0):
    """This rank's rows of a global batch (a tensor or an array): the
    `data` index's contiguous block along `dim`."""
    D = mesh.shape["data"]
    n = x.shape[dim]
    if n % D:
        raise ValueError(f"a batch of {n} rows does not split over the data axis ({D})")
    b, d = n // D, mesh.index("data")
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, d * b, b)
    return np.take(np.asarray(x), np.arange(d * b, (d + 1) * b), axis=dim)


def place_batch(mesh, batch: Mapping[str, Any], local: bool = True,
                expected_global_rows: Optional[int] = None) -> Dict[str, Any]:
    """This rank's part of a batch dict.

    `local=True`: `batch` is already this rank's shard (from
    `Batches(process_index=data index, process_count=D)`), kept as it is;
    with `expected_global_rows` it must not assemble more global rows than
    that: feeding the FULL global batch as a shard would silently
    duplicate every sample D times. `local=False`: `batch` is the global
    batch and this rank takes its rows (`batch_rows`)."""
    if not local:
        return {k: batch_rows(v, mesh) for k, v in batch.items()}
    if expected_global_rows is not None:
        n = mesh.shape["data"]
        for k, v in batch.items():
            rows = getattr(v, "shape", (None,))[0]
            # strictly greater: a ragged epoch tail assembles fewer rows
            if rows is not None and rows * n > expected_global_rows:
                raise ValueError(
                    f"batch[{k!r}] has {rows} local rows on each of {n} data ranks -> "
                    f"{rows * n} global, expected at most {expected_global_rows}. On a "
                    "mesh pass each rank its OWN shard (Batches(process_index=..., "
                    "process_count=...)), not the full global batch.")
    return dict(batch)
