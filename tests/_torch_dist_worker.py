"""Rank functions of the port's multi-rank tests, and the spawner.

The torch twin of `tests/_multihost_worker.py`: each test spawns gloo ranks
on the CPU (`torch.multiprocessing`, start method "spawn", a `FileStore` in
the test's tmp dir, so no port can race), one rank per JAX mesh device.
The ranks import neither JAX nor the JAX package: the parent computes the
JAX side and passes arrays in through `.npz` files; each rank writes what
it computed to `out_{rank}.npz` (or `.pt`) for the parent to compare.

`run_ranks(name, world, tmp, **kw)` runs `name(rank, world, tmp, **kw)`
(a function of this module) on `world` ranks and raises if one fails or
the ranks outlive `timeout` seconds.
"""

from __future__ import annotations

import os
import time

import numpy as np


def run_ranks(name: str, world: int, tmp, timeout: float = 600, **kw) -> None:
    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.start_processes(_entry, args=(name, world, str(tmp), kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{name} on {world} ranks outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _entry(rank: int, name: str, world: int, tmp: str, kw: dict) -> None:
    import _torch_test_threads  # noqa: F401  (one torch thread per rank)
    import torch.distributed as dist

    from gemm_gan_tpu_torch.parallel.mesh import distributed_init

    distributed_init(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        globals()[name](rank, world, tmp, **kw)
    finally:
        dist.destroy_process_group()


def _load(tmp, name="inputs.npz"):
    return dict(np.load(os.path.join(tmp, name), allow_pickle=False))


def _save(tmp, rank, **arrays):
    np.savez(os.path.join(tmp, f"out_{rank}.npz"), **arrays)


# ------------------------------------------------------------- ring attention
def ring(rank, world, tmp):
    """ring_mha's output and q/k/v gradients over model = 4 (a 1x4 mesh) and
    model = 2 (a 2x2 mesh), on the parent's inputs; and the collectives'
    double derivative (the row-parallel all-reduce under a penalty)."""
    import torch

    from gemm_gan_tpu_torch.kernels.ring_attention import ring_mha
    from gemm_gan_tpu_torch.parallel import comm
    from gemm_gan_tpu_torch.parallel.mesh import make_mesh

    x = _load(tmp)
    out = {}
    for label, mesh in (("m4", make_mesh(1, 4, device="cpu")),
                        ("m2", make_mesh(2, 2, device="cpu"))):
        for case, dtype in (("a", torch.float32), ("b", torch.float32),
                            ("c", torch.bfloat16)):
            q, k, v = (torch.tensor(x[f"{case}_{n}"]).to(dtype).requires_grad_(True)
                       for n in ("q", "k", "v"))
            o = ring_mha(q, k, v, torch.tensor(x[f"{case}_mask"]), mesh=mesh)
            assert o.dtype == dtype
            (o.float() * torch.tensor(x[f"{case}_w"])).sum().backward()
            out[f"{label}_{case}_o"] = o.detach().float().numpy()
            for n, t in (("dq", q), ("dk", k), ("dv", v)):
                out[f"{label}_{case}_{n}"] = t.grad.float().numpy()
        if label == "m2":
            # y = (x W^T) summed over the model ranks' column blocks, and the
            # gradient of a penalty on dy/dx w.r.t. W: twice through the pair
            xin = torch.tensor(x["tp_x"], requires_grad=True)
            W = torch.tensor(x["tp_w"])
            kk = W.shape[1] // 2
            Wl = W[:, mesh.index("model") * kk:(mesh.index("model") + 1) * kk].clone()
            Wl.requires_grad_(True)
            xs = comm.copy_to(xin, mesh).narrow(1, mesh.index("model") * kk, kk)
            y = torch.tanh(comm.reduce_from(xs @ Wl.T, mesh))
            (dx,) = torch.autograd.grad(y.sum(), xin, create_graph=True)
            pen = ((dx.norm(dim=1) - 1) ** 2).mean()
            (dW,) = torch.autograd.grad(pen, Wl)
            out["tp_pen"] = pen.detach().numpy()
            out["tp_dx"] = dx.detach().numpy()
            out["tp_dW"] = comm.all_gather(dW, mesh, "model", dim=1).numpy()
    _save(tmp, rank, **out)


# ------------------------------------------------------------ the mesh steps
def _pickled(tmp, name="inputs.pkl"):
    import pickle

    with open(os.path.join(tmp, name), "rb") as f:
        return pickle.load(f)


def _mesh_step(x, data, model):
    """One engine step on a (data, model) mesh from the parent's Flax
    params, global batch and global draws; returns (state, metrics, mesh)."""
    from gemm_gan_tpu_torch.config import config_from_dict
    from gemm_gan_tpu_torch.parallel.mesh import make_mesh
    from gemm_gan_tpu_torch.parallel.sharding import place_batch
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    mesh = make_mesh(data, model, device="cpu")
    eng = WGANGPEngine(config_from_dict(x["cfg"]), steps_per_epoch=2, mesh=mesh)
    state = eng.state_from_flax(x["g_params"], x["d_params"])
    state, metrics = eng.step(state, place_batch(mesh, x["batch"], local=False),
                              draws=x["draws"])
    return eng, state, metrics, mesh


def _full(state, mesh):
    from gemm_gan_tpu_torch.parallel.sharding import gather_state_dict

    full = {"gen": gather_state_dict(state.gen, mesh),
            "critic": gather_state_dict(state.critic, mesh)}
    if state.g_ema is not None:
        full["g_ema"] = gather_state_dict(state.g_ema, mesh)
    return full


def flagship(rank, world, tmp):
    """The 2x2 step (sequence parallel), its sharded optimizer state, a
    checkpoint of it, and sharded sampling."""
    import torch

    from gemm_gan_tpu_torch.parallel.sharding import gather_tensor, tp_specs
    from gemm_gan_tpu_torch.train.checkpoint import save_state

    x = _pickled(tmp)
    eng, state, metrics, mesh = _mesh_step(x, 2, 2)
    nu = [gather_tensor(t, tp_specs(net)[name], mesh)
          for net, opt in ((state.gen, state.g_opt), (state.critic, state.d_opt))
          for (name, _), t in zip(net.named_parameters(), opt.nu)]
    shapes = {
        "params": [tuple(p.shape) for p in state.gen.parameters()]
        + [tuple(p.shape) for p in state.critic.parameters()],
        "nu": [tuple(t.shape) for t in state.g_opt.nu + state.d_opt.nu],
        "sharded": state.g_opt.sharded + state.d_opt.sharded,
    }
    save_state(os.path.join(tmp, "ckpt"), state)
    fakes = eng.generate_samples_all(state, [x["batch"]], 2, torch.Generator().manual_seed(5))
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "full": _full(state, mesh), "nu": nu, "shapes": shapes,
                "fake": fakes["fake"],
                "coords": mesh.coords, "mesh_shape": mesh.shape},
               os.path.join(tmp, f"out_{rank}.pt"))


def small_meshes(rank, world, tmp):
    """A (2, 1) and a (1, 2) step, and a BatchNorm trunk under data = 2."""
    import torch

    from gemm_gan_tpu_torch.config import config_from_dict
    from gemm_gan_tpu_torch.models.gan import Generator
    from gemm_gan_tpu_torch.parallel import comm
    from gemm_gan_tpu_torch.parallel.mesh import make_mesh
    from gemm_gan_tpu_torch.parallel.sharding import batch_rows

    x = _pickled(tmp)
    out = {}
    for data, model in ((2, 1), (1, 2)):
        _, state, metrics, mesh = _mesh_step(x, data, model)
        out[f"{data}x{model}"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                                  "full": _full(state, mesh)}
    # one graphed-path epoch from a replicated DeviceCache over data = 2
    from gemm_gan_tpu_torch.data.device_cache import DeviceCache
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    mesh = make_mesh(2, 1, device="cpu")
    eng = WGANGPEngine(config_from_dict(x["cfg"]), steps_per_epoch=1, mesh=mesh)
    state = eng.state_from_flax(x["g_params"], x["d_params"])
    cache = DeviceCache(x["batch"], batch_size=len(x["batch"]["genes"]), seed=0, device="cpu")
    state, metrics = eng.step_many_cached(state, cache, 0)
    out["cached"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "full": _full(state, mesh)}
    # BatchNorm statistics over data = 2
    gen = Generator(config_from_dict(x["bn_cfg"]).model, device="cpu", mesh=mesh)
    gen.load_state_dict(x["bn_state"])
    z = batch_rows(torch.tensor(x["bn_z"]), mesh)
    w = batch_rows(torch.tensor(x["bn_w"]), mesh)
    y = gen(z, None, train=True)
    (y * w).sum().backward()
    grads = [p.grad.clone() for p in gen.parameters()]
    for g in grads:
        comm.all_reduce_(g, mesh, "data")
    out["bn"] = {"y": comm.all_gather(y.detach(), mesh, "data"),
                 "buffers": {k: v.clone() for k, v in gen.named_buffers()},
                 "grads": dict(zip([n for n, _ in gen.named_parameters()], grads))}
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))


# -------------------------------------------------------- the sharded bank
def sharded_cache(rank, world, tmp):
    """Each rank's batches of two epochs from `ShardedDeviceCache` on a 2x2
    mesh, case-sharded, patch-sharded, and patch-sharded with resampling;
    and its epoch-0 index table."""
    import torch

    from gemm_gan_tpu_torch.data.device_cache import ShardedDeviceCache
    from gemm_gan_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, device="cpu")
    out = {}
    for name, kw in (("case", {}), ("patch", {"shard_patches": True}),
                     ("resample", {"shard_patches": True, "num_patches": 8})):
        data = _load(tmp, f"{'resample' if name == 'resample' else 'full'}.npz")
        cache = ShardedDeviceCache(data, batch_size=8, mesh=mesh, seed=0, **kw)
        for e in (0, 1):
            for k, batch in enumerate(cache.epoch(e)):
                for key, v in batch.items():
                    out[f"{name}/{e}/{k}/{key}"] = v.numpy()
        idx, _ = cache.epoch_spec(0)
        out[f"{name}/idx"] = idx.numpy()
        out[f"{name}/len"] = np.asarray(len(cache))
        out[f"{name}/local_patches"] = np.asarray(cache.arrays["patches"].shape[1])
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))


# ---------------------------------------------------------- the experiment
def experiment(rank, world, tmp):
    """`Experiment.fit()` then `evaluate("last")` on a (2, 1) mesh; each
    rank writes what the two calls returned."""
    import json

    import torch

    from gemm_gan_tpu_torch.cli.experiment import Experiment
    from gemm_gan_tpu_torch.config import config_from_dict
    from gemm_gan_tpu_torch.parallel.mesh import make_mesh

    x = _pickled(tmp)
    torch.manual_seed(0)
    exp = Experiment(config_from_dict(x["cfg"]), x["splits"], mesh=make_mesh(2, 1, device="cpu"))
    fit = exp.fit()
    fit_dumps = {}
    if exp.is_main:
        run = os.path.join(exp.out_dir, "test_0_epoch_2")
        fit_dumps = {n: np.load(os.path.join(run, n)) for n in sorted(os.listdir(run))}
    ev = exp.evaluate("last")
    with open(os.path.join(tmp, f"mp_{rank}.json"), "w") as f:
        json.dump({"fit": fit, "eval": ev}, f, default=float)
    np.savez(os.path.join(tmp, f"fit_dumps_{rank}.npz"), **fit_dumps)


def cli_train(rank, world, tmp, argv):
    """`cli.train.main(argv)` on every rank (the process group is up, as
    under torchrun); each rank writes what it returned."""
    import json

    from gemm_gan_tpu_torch.cli.train import main

    results = main(list(argv))
    with open(os.path.join(tmp, f"cli_{rank}.json"), "w") as f:
        json.dump(results, f, default=float)
