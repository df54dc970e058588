"""A (data, model) mesh of `torch.distributed` ranks, and distributed init.

Counterpart of `gemm_gan_tpu/parallel/mesh.py`. One JAX mesh device is one
rank here: one process per card, its collectives on NCCL, or gloo ranks on
the CPU when the caller asks for the CPU. Ranks are laid out (data, model)
row-major, as JAX's `devices.reshape(data, model)`: rank r sits at data
index r // model and model index r % model. Each rank holds one process
group per axis, the ranks that share its other coordinate, and every
collective of the port's mesh paths (`parallel/comm.py`) is an explicit
call on one of them. Nothing falls back from NCCL to gloo on a card, and a
mesh is never quietly reduced to one rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from gemm_gan_tpu_torch.utils.device import DeviceLike

AXES = ("data", "model")


def _local_device(device: DeviceLike) -> torch.device:
    """This rank's device: "cpu" when asked for, else cuda:LOCAL_RANK, which
    must exist."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo "
                           "ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is not None and torch.device(device).index is not None:
        local = torch.device(device).index
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} has no card: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s), one rank per card")
    return torch.device("cuda", local)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None) -> bool:
    """Join the process group if this run is one of several ranks.

    Safe to call unconditionally; returns whether a process group is up.
    Two launch modes, as the JAX package's:

    - managed: torchrun (or any launcher) exports RANK, WORLD_SIZE,
      MASTER_ADDR, MASTER_PORT and LOCAL_RANK; they are read from there;
    - manual: `coordinator_address` ("host:port" of rank 0, or a
      "tcp://..." / "file://..." init method), `num_processes` and this
      rank's `process_id`.

    Without either (one process, no such variables) it does nothing. The
    backend is NCCL on the card `cuda:LOCAL_RANK` (made the current device),
    gloo only when `device="cpu"`."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world,
                                rank=rank, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world,
                                rank=rank)
    return True


@dataclass(eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh.

    `shape` is {"data": D, "model": M} (JAX's `mesh.shape`), `coords` this
    rank's index on each axis, `device` its device, `groups[axis]` the
    process group of the ranks that differ from it only on `axis` (None
    when no process group is up: a one-rank mesh, whose collectives are
    identities) and `ranks[axis]` their global ranks in axis order."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Optional[object]] = field(repr=False)
    ranks: Dict[str, List[int]] = field(repr=False)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    # modules that hold the mesh are deep-copied (the EMA generator): the
    # copy shares the process groups
    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


def make_mesh(data: int = -1, model: int = 1, device: DeviceLike = None) -> Mesh:
    """Build a (data, model) mesh over the process group's ranks (one rank
    without one). data=-1 takes all the ranks model leaves. Every rank must
    call it, in the same order as any other group-making call.

    On a card (an NCCL group) a mesh needs one card per rank on this
    machine's count of ranks that share it: a world size above
    `torch.cuda.device_count()` raises when the group is local."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    if dist.is_initialized():
        rank = dist.get_rank()
        backend = dist.get_backend()
        if backend == "nccl":
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", n))
            if local_world > torch.cuda.device_count():
                raise RuntimeError(
                    f"a mesh of {local_world} NCCL ranks on this machine needs as many "
                    f"cards; it has {torch.cuda.device_count()} (NCCL refuses two ranks "
                    f"on one card)")
            dev = torch.device("cuda", torch.cuda.current_device())
        elif backend == "gloo":
            dev = torch.device("cpu")
        else:
            raise RuntimeError(f"unsupported process-group backend {backend!r}")
    else:
        from gemm_gan_tpu_torch.utils.device import resolve_device

        rank, dev = 0, resolve_device(device)
    coords = {"data": rank // model, "model": rank % model}
    groups, ranks = {}, {}
    # every rank creates every group, in one order
    for axis in AXES:
        if axis == "data":
            members = [[d * model + m for d in range(data)] for m in range(model)]
        else:
            members = [[d * model + m for m in range(model)] for d in range(data)]
        for ms in members:
            g = dist.new_group(ms) if dist.is_initialized() else None
            if rank in ms:
                groups[axis], ranks[axis] = g, ms
    return Mesh({"data": data, "model": model}, rank, coords, dev, groups, ranks)
