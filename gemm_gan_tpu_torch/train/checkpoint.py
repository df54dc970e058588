"""Checkpoint / restore of the FULL training state.

Counterpart of `gemm_gan_tpu/train/checkpoint.py` (Orbax there). A
checkpoint is `<dir>/<step>/state.pt`, one `torch.save` of the whole
`GANTrainState`:

* `step`; the `gen`, `critic` and (when on) `g_ema` state dicts;
* each `ScheduledOptimizer`'s host `count`, device `count_t` and moments
  (`nu`, and Adam's `mu`);
* `rng`, the state of the run's z / alpha / noise generator;
* `dropout_rng`, the state of the default generator of the state's device,
  which the nets' dropout draws from (the JAX state's one key covers both).

A `VAETrainState` (`train/vae.py`) is saved the same way, as `step`, the
`model` state dict, its optimizer's counts and Adam moments (`opt`) and
`rng` (the VAE has no dropout).

A save writes a temporary directory and renames it into place; a step that
exists is replaced; the newest `MAX_TO_KEEP` (5, as Orbax keeps) are kept.
A restore copies every tensor into the target state in place, so the target
keeps its tensors' addresses.

Under a mesh (the nets' `mesh`) every rank calls `save_state` and
`restore_state`: the save gathers the full state (the `model`-sharded
parameters and their moments all-gathered, a collective) and rank 0 writes
it, with every rank's dropout generator state; a restore reads the full
state on every rank and each keeps its shards. So a checkpoint does not
depend on the mesh: one saved on a 2x2 mesh restores on one rank, and the
reverse.

The state a save sees after graphed epochs is what the replays left: the
parameters and moments are updated in place by each replay, the host counts
are advanced by the engine, and each replay advances the host offsets of the
generators the graph registered.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from gemm_gan_tpu_torch.parallel.sharding import (gather_state_dict, gather_tensor,
                                                  load_full_state_dict_, shard_tensor,
                                                  tp_specs)
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer
from gemm_gan_tpu_torch.train.state import GANTrainState, TrainState, VAETrainState

STATE_FILE = "state.pt"
MAX_TO_KEEP = 5


def dropout_generator(device: torch.device) -> torch.Generator:
    """The default generator of `device`, which dropout draws from."""
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


def _device_of(state: GANTrainState) -> torch.device:
    return next(state.gen.parameters()).device


def _mesh_of(state: TrainState):
    return getattr(state.gen, "mesh", None) if isinstance(state, GANTrainState) else None


def _param_specs(module, mesh):
    """The spec of each of `module.parameters()`, in order (None without a
    mesh)."""
    if mesh is None:
        return None
    specs = tp_specs(module)
    return [specs[name] for name, _ in module.named_parameters()]


def _moments(xs, specs, mesh, fn):
    return xs if specs is None or xs is None else [fn(x, s, mesh) for x, s in zip(xs, specs)]


def _opt_state(opt: ScheduledOptimizer, specs=None, mesh=None) -> dict:
    return {"count": opt.count, "count_t": opt.count_t,
            "nu": _moments(opt.nu, specs, mesh, gather_tensor),
            "mu": _moments(opt.mu, specs, mesh, gather_tensor)}


def _load_opt(opt: ScheduledOptimizer, saved: dict, specs=None, mesh=None) -> None:
    opt.count = int(saved["count"])
    opt.count_t.copy_(saved["count_t"])
    for dst, src in zip(opt.nu, _moments(saved["nu"], specs, mesh, shard_tensor)):
        dst.copy_(src)
    if opt.mu is not None:
        for dst, src in zip(opt.mu, _moments(saved["mu"], specs, mesh, shard_tensor)):
            dst.copy_(src)


def _module_state(module, mesh) -> dict:
    return module.state_dict() if mesh is None else gather_state_dict(module, mesh)


def _load_module(module, full: dict, mesh) -> None:
    load_full_state_dict_(module, full, mesh)


def _steps(path: str) -> list:
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.exists(os.path.join(path, d, STATE_FILE)))


def _payload(state: TrainState) -> dict:
    if isinstance(state, VAETrainState):
        return {"step": int(state.step), "model": state.model.state_dict(),
                "opt": _opt_state(state.opt), "rng": state.rng.get_state()}
    mesh = _mesh_of(state)
    dropout = dropout_generator(_device_of(state)).get_state()
    payload = {
        "step": int(state.step),
        "gen": _module_state(state.gen, mesh),
        "critic": _module_state(state.critic, mesh),
        "g_ema": None if state.g_ema is None else _module_state(state.g_ema, mesh),
        "g_opt": _opt_state(state.g_opt, _param_specs(state.gen, mesh), mesh),
        "d_opt": _opt_state(state.d_opt, _param_specs(state.critic, mesh), mesh),
        "rng": state.rng.get_state(),
        "dropout_rng": dropout,
    }
    if mesh is not None and dist.is_initialized():
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, dropout)
        payload["dropout_rng_ranks"] = ranks
    return payload


def save_state(path: str, state: TrainState, step: Optional[int] = None) -> int:
    """Write `state` as checkpoint `step` (default: `state.step`) under
    `path`; returns the step."""
    step = int(state.step if step is None else step)
    payload = _payload(state)
    if dist.is_initialized() and _mesh_of(state) is not None:
        if dist.get_rank() == 0:
            _write(path, payload, step)
        dist.barrier()  # the checkpoint is on disk before any rank reads it
        return step
    _write(path, payload, step)
    return step


def _write(path: str, payload: dict, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=path)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        final = os.path.join(path, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    for old in _steps(path)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(path, str(old)))


def restore_state(path: str, target: TrainState, step: Optional[int] = None
                  ) -> TrainState:
    """Copy checkpoint `step` (default: the newest) under `path` into
    `target` (a state of the same configuration, e.g. a fresh
    `init_state`) and return it."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    file = os.path.join(path, str(int(step)), STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint for step {step} under {path}")
    saved = torch.load(file, map_location="cpu", weights_only=True)
    if ("model" in saved) != isinstance(target, VAETrainState):
        raise ValueError(f"the checkpoint under {path} and the target state are of "
                         "different engines")
    if isinstance(target, VAETrainState):
        with torch.no_grad():
            target.model.load_state_dict(saved["model"])
            _load_opt(target.opt, saved["opt"])
        target.step = int(saved["step"])
        target.rng.set_state(saved["rng"])
        return target
    mesh = _mesh_of(target)
    with torch.no_grad():
        _load_module(target.gen, saved["gen"], mesh)
        _load_module(target.critic, saved["critic"], mesh)
        if (saved["g_ema"] is None) != (target.g_ema is None):
            raise ValueError("the checkpoint and the target state disagree on the EMA "
                             "generator (train.ema_decay)")
        if target.g_ema is not None:
            _load_module(target.g_ema, saved["g_ema"], mesh)
        _load_opt(target.g_opt, saved["g_opt"], _param_specs(target.gen, mesh), mesh)
        _load_opt(target.d_opt, saved["d_opt"], _param_specs(target.critic, mesh), mesh)
    target.step = int(saved["step"])
    target.rng.set_state(saved["rng"])
    dropout = saved["dropout_rng"]
    ranks = saved.get("dropout_rng_ranks")
    if ranks is not None and dist.is_initialized() and len(ranks) == dist.get_world_size():
        dropout = ranks[dist.get_rank()]  # the same world: each rank its own stream
    dropout_generator(_device_of(target)).set_state(dropout)
    return target


def resolve_ckpt_dir(ckpt_dir: str, which: str = "last"):
    """Map (a run's checkpoint dir, which in {'last','best'}) -> (dir, step).

    `which="best"` swaps the directory for the sibling `ckpt_best/` (the
    gate-best validation checkpoint `Experiment._maybe_save_best` tracks)
    and pins the restore step to the one `best.json` records, so that a
    stale higher-step checkpoint left in `ckpt_best/` by an earlier run in
    the same out_dir can never win over the recorded best."""
    if which not in ("last", "best"):
        raise ValueError(f"which must be 'last' or 'best', got {which!r}")
    if which == "last":
        return ckpt_dir, None
    run_dir = os.path.dirname(os.path.normpath(ckpt_dir))
    best_dir = os.path.join(run_dir, "ckpt_best")
    if not os.path.isdir(best_dir):
        raise FileNotFoundError(
            f"no best checkpoint under {best_dir}: gate-best tracking needs "
            "periodic validation during fit (train.freq_compute_test < "
            "train.epochs); use which='last'")
    step = None
    best_json = os.path.join(run_dir, "best.json")
    if os.path.exists(best_json):
        with open(best_json) as f:
            step = json.load(f).get("step")
    return best_dir, step


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def resume_or_fresh(ckpt_dir: str, template_state: TrainState, steps_per_epoch: int,
                    epochs: int, loader=None):
    """Restore the newest checkpoint into `template_state` and recover the
    epochs done from its step; position `loader`'s no-arg epoch stream
    there. Returns `(state, start_epoch)`, `(template_state, 0)` with a
    warning when there is no checkpoint (mid-run saves need
    `train.checkpoint_every_eval`)."""
    step = latest_step(ckpt_dir)
    if step is None:
        logging.getLogger(__name__).warning(
            "resume requested but no checkpoint under %s — starting fresh "
            "(mid-run checkpoints need train.checkpoint_every_eval)", ckpt_dir)
        return template_state, 0
    state = restore_state(ckpt_dir, template_state, step)
    start_epoch = min(int(step) // max(steps_per_epoch, 1), epochs)
    if loader is not None:
        loader.seek(start_epoch)
    return state, start_epoch
