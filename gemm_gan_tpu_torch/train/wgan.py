"""The fused WGAN-GP training step on the card, and the epoch loop.

Counterpart of `gemm_gan_tpu/train/wgan.py::WGANGPEngine`. One step is
`n_critic` critic updates (the same real batch, fresh z and α each, the
gradient penalty taken w.r.t. the interpolated expression only) and one
generator update, each followed by its optimizer's update, then the
generator's EMA (`train.ema_decay` > 0). With `train.p_aug` > 0 each critic
update draws a gate ~ Bernoulli(p_aug) and adds gate * N(0, 1) *
`norm_scale` to its real and fake batches (instance noise). Every attention
backward goes through the CUDA kernels of `kernels/flash_attention.py`.

Two embedding paths, as in the JAX package:

* `train.cond_embed_reuse="per_update"` (the production setting): the
  generator embeds the conditioning once per step (no grad: its params are
  constant across the critic updates); each critic update embeds it once
  with grad and scores real, fake and the penalty's interpolates through
  that one vector, with `batched_scores` as one [3B] trunk call; the
  generator update embeds the critic's side once without grad.
* `"per_call"` (the library default): every forward embeds afresh.

The penalty's inner gradient reaches only the critic's trunk, so attention
is differentiated once (the kernels' autograd Functions are first order).

Three ways to run steps, one body (`_fused_step`, which reads device
tensors only and changes no host state):

* `step(state, batch)`: one step, eagerly;
* `step_many(state, stacked)`: the JAX `step_many` (`lax.scan` over [K, B,
  ...] batches): the stack is copied once into static device buffers
  (through pinned memory) and a device step index selects row k;
* `step_many_cached(state, cache, epoch)`: one epoch from a `DeviceCache`,
  each batch gathered and patch-subsampled from the resident bank inside
  the step; only the epoch's [K, B] index table and subsampling scores are
  copied in.

On the card the last two capture one step as a CUDA graph (`_StepGraph`)
after one eager warm-up step on the capture stream (the first of the K,
which also builds and loads the kernels), and replay it; on the CPU they
run the same body in a loop. Nothing falls back: a capture that fails
raises. A replay launches no wrapper, so each graph records the kernel
launches its capture made and adds them to the counters per replay
(`flash_attention.recorded_launches`, `count_replays`). With the tracer on
(`utils/metrics.py`'s `TRACER`), `fit` and the step record spans, each
replay is timed by events, and a second graph of the step, captured with
an event at each stage boundary, replays as each run's last step.

Randomness: z, α and the instance noise come from `state.rng`, or from
`draws` when the caller passes them (the tests rebuild them from the JAX key
schedule). Dropout masks come from PyTorch's default generator of the
device; seed it with `torch.manual_seed` for a repeatable run. Both are
registered with a captured graph, so a replayed step draws what the same
step run eagerly would.

The bench configuration, `compute_dtype="bfloat16"` (and
`fusion.flash_mxu_bf16`), runs the same step: the nets compute in bf16
(`ops/linear.py`) around the bf16 modes of the ble kernels, while params,
optimizer state, z, alpha, the interpolates, the noise and the penalty's
norm stay f32 (the penalty's gradient reaches the interpolates in f32
through the trunk's casts), as in the JAX engine.

`train.grad_accum` = M > 1 accumulates, as the JAX engine does: each
update takes its batch in M strided microbatches (sample i in microbatch
i % M), every per-sample draw (z, alpha, the instance noise) made once at
full batch and sliced the same way, the generator's (and, for the
generator update, the critic's) per_update embedding made once at full
batch; gradients and metrics are averaged over the M, then the optimizer
updates once. At dropout 0 that is the full-batch step up to the
summation order. The microbatches are a loop inside the step, so a CUDA
graph captures them all; a batch that M does not divide raises
`ValueError`.

`train.hoist_fakes=True` on the per_update batched path (and
`grad_accum` 1; elsewhere it changes nothing, as in JAX) makes all
n_critic fake batches in one generator trunk forward over [n_critic * B]
rows, from the same per-update z rows (`draws["z"][i]`) and the tiled
generator embedding, before the critic loop; each update takes its slice
(and its instance noise, as before). The trunk is dropout-free, so the
fakes are those of the per-update path up to the product's summation
order. It is part of `_fused_step`, so `step`, `step_many` and
`step_many_cached` (and their CUDA graphs) all take it.

Under a mesh (`mesh`, a `parallel.mesh.Mesh`: one rank per JAX device),
each rank runs the step on its share, as JAX's `WGANGPEngine(mesh=...)` on
its global arrays: the nets are sharded (`models.gan`: the gene matmuls
over `model`, ring attention with `fusion.sequence_parallel`), each rank
takes its rows of the batch over `data` (`step` and `step_many` take this
rank's shard, as from `Batches(process_index=data index, process_count=D,
shard_mode="batch")`), the draws are made for the GLOBAL batch on every
rank from the same generator and each rank takes its rows (so they do not
depend on the mesh), the gradients are averaged over `data` after
`grad_accum`'s microbatches and before clipping (`ScheduledOptimizer`),
and the metrics are averaged over `data` (the global batch's). The
optimizer moments and the EMA are sharded like their parameters.
`step_many_cached` takes a `DeviceCache` (the bank replicated, each rank
gathering its rows of every batch) or a `ShardedDeviceCache` on the same
mesh (each rank gathering from its own shard), and stays one CUDA graph per
epoch with the collectives captured in it. Sampling splits each batch's
rows over `data` and all-gathers them (`GeneratorServer`).

`critic_scan` changes nothing here: the critic updates are a Python loop
either way.
"""

from __future__ import annotations

import copy
import weakref
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.kernels import flash_attention as fa
from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.parallel import comm
from gemm_gan_tpu_torch.parallel.sharding import (batch_rows, load_full_state_dict_,
                                                  place_batch, sharded_flags)
from gemm_gan_tpu_torch.serving import GeneratorServer, cond_keys_for, to_device
from gemm_gan_tpu_torch.train import losses
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer
from gemm_gan_tpu_torch.train.state import GANTrainState
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device
from gemm_gan_tpu_torch.utils.metrics import TRACER, GraphTiming, StageMarks

Batch = Mapping[str, Any]
Inputs = Callable[[torch.Tensor], tuple]
# the batch dimension of each of a step's draws (`WGANGPEngine._draws`)
DRAW_BATCH_DIM = {"z": 1, "alpha": 1, "z_gen": 0, "noise_real": 1, "noise_fake": 1}


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _buffer_dtype(x: torch.Tensor) -> torch.dtype:
    """Floating arrays are held as float32 (`serving.to_device`)."""
    return torch.float32 if x.is_floating_point() else x.dtype


def _row(buffer: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row `i` (a one-element device index) of `buffer`, on the device."""
    return buffer.index_select(0, i)[0]


def _micro(x, m: int, M: int):
    """Microbatch `m` of `M` of a batch-leading tensor (or a dict of them,
    or None): the strided samples m, m + M, m + 2M, ..., as the JAX engine
    regroups them; the batch itself when M is 1."""
    if M == 1 or x is None:
        return x
    if isinstance(x, dict):
        return {k: v[m::M] for k, v in x.items()}
    return x[m::M]


def _accumulate(total, part):
    """Element-wise sums of two equal-length sequences of tensors (`total`
    None at the first part)."""
    return list(part) if total is None else [a + b for a, b in zip(total, part)]


class _StepGraph:
    """One fused step of `state` that takes its inputs from
    `inputs(step_idx)`, a function of a one-element device index that reads
    static buffers and returns the arguments of `engine._fused_step` after
    the state; each run advances the index. On the card it is captured once
    as a CUDA graph and replayed; on the CPU the body is called. Any engine
    whose `_fused_step` reads device tensors only and whose state draws from
    `state.rng` can use it (`train/vae.py` does)."""

    def __init__(self, engine, state,
                 buffers: Dict[str, torch.Tensor], inputs: Inputs):
        self.engine = engine
        self.state = state
        self.buffers = buffers  # what `inputs` reads; the caller fills them
        self.inputs = inputs
        self.step_idx = torch.zeros(1, dtype=torch.long, device=engine.device)
        self.graph = None
        self.outputs = None   # the captured step's metrics, rewritten by each replay
        self.recorded = {}    # kernel launches one replay makes
        self.timing = None    # what the tracer reads (`utils/metrics.py`), once it is on

    def _body(self, marks: Optional[StageMarks] = None) -> Dict[str, torch.Tensor]:
        with TRACER.marking(marks):
            args = self.inputs(self.step_idx)
            TRACER.stage("gather")
            metrics = self.engine._fused_step(self.state, *args)
        self.step_idx.add_(1)
        return metrics

    def _capture(self) -> Dict[str, torch.Tensor]:
        """Run one step eagerly on a side stream (it warms up the autograd
        engine and cuBLAS on that stream, builds and loads the kernels and
        allocates what the optimizers hold), then capture the next on the
        same stream. Returns the eager step's metrics. With the tracer on,
        a second graph of the step marks its stages (`_record`)."""
        device = self.engine.device
        TRACER.count("captures")
        with TRACER.span("graph.capture"):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with TRACER.span("graph.eager_step"), torch.cuda.stream(stream):
                metrics = self._body()
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph, self.outputs, self.recorded = self._record(stream)
            if TRACER.on:
                # an event node costs the step ~5 us, so only each run's
                # last step replays the graph that holds them
                marks = StageMarks(device)
                marked, outputs, _ = self._record(stream, marks)
                self.timing = GraphTiming(device, marks, marked, outputs)
        return metrics

    def _record(self, stream, marks: Optional[StageMarks] = None):
        """Capture one step on `stream`, its stages marked into `marks`:
        (graph, its metrics, the kernel launches one replay makes)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.rng)
        with TRACER.span("graph.record"), fa.recorded_launches() as recorded:
            with torch.cuda.graph(graph, stream=stream):
                outputs = self._body(marks)
        return graph, outputs, recorded

    def run(self, n: int) -> Dict[str, torch.Tensor]:
        """`n` steps from row 0; returns the last step's metrics."""
        self.step_idx.zero_()
        device = self.engine.device
        if device.type == "cpu":
            if TRACER.on and self.timing is None:
                self.timing = GraphTiming(device, StageMarks(device))
            marks = self.timing.marks if TRACER.on else None
            for _ in range(n):
                metrics = self._body(marks)
            if TRACER.on:
                TRACER.ran(self.timing, n)
            return metrics
        done = 0
        if self.graph is None:
            metrics = self._capture()
            done = 1
        replays, outputs = n - done, self.outputs
        if TRACER.on:
            if self.timing is None:  # captured with the tracer off: no stages
                self.timing = GraphTiming(device)
            graphs = [self.graph] * replays
            if replays and self.timing.marked is not None:
                graphs[-1], outputs = self.timing.marked, self.timing.outputs
            TRACER.replay(graphs, self.timing)
        else:
            for _ in range(replays):
                self.graph.replay()
        fa.count_replays(self.recorded, replays)
        if replays:
            metrics = {k: v.clone() for k, v in outputs.items()}
        return metrics


class WGANGPEngine:
    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int = 1,
                 device: DeviceLike = None, mesh=None):
        t = cfg.train
        if t.n_critic < 1:
            raise ValueError(f"train.n_critic must be >= 1, got {t.n_critic}")
        if cfg.model.use_batchnorm:
            raise ValueError("model.use_batchnorm=True is not supported by the "
                             "WGAN-GP engine: the per-sample gradient penalty "
                             "needs a critic without batch statistics")
        if t.cond_embed_reuse not in ("per_call", "per_update"):
            raise ValueError(f"cond_embed_reuse must be 'per_call' or 'per_update', "
                             f"got {t.cond_embed_reuse!r}")
        self.reuse = t.cond_embed_reuse == "per_update"
        if t.grad_accum < 1:
            raise ValueError(f"train.grad_accum must be >= 1, got {t.grad_accum}")
        self.hoist = (t.hoist_fakes and self.reuse and t.batched_scores
                      and t.grad_accum == 1)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.mesh = mesh
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.keys = cond_keys_for(cfg.model.fusion)
        self.history: Dict[str, list] = {"d_loss": [], "g_loss": []}
        # step_many's graph per batch layout; step_many_cached's per cache
        # (weak keys: a dropped cache releases its graph and bank)
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._cached_graphs = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------------ state
    def _state(self, gen: Generator, critic: Critic, seed: int) -> GANTrainState:
        t, mesh = self.cfg.train, self.mesh
        g_opt = ScheduledOptimizer(gen.parameters(), t, t.lr_gen, self.steps_per_epoch,
                                   t.clip_grad_gen, mesh=mesh,
                                   sharded=None if mesh is None else sharded_flags(gen))
        d_opt = ScheduledOptimizer(critic.parameters(), t, t.lr_disc, self.steps_per_epoch,
                                   t.clip_grad_disc, mesh=mesh,
                                   sharded=None if mesh is None else sharded_flags(critic))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        g_ema = copy.deepcopy(gen).requires_grad_(False) if t.ema_decay > 0 else None
        return GANTrainState(0, gen, critic, g_opt, d_opt, rng, g_ema)

    def init_state(self, seed: int, sample_batch: Batch) -> GANTrainState:
        """Fresh nets (Flax-like random init from `seed`) and optimizers.
        `sample_batch` is checked for the keys a step reads."""
        self._tensors(sample_batch)
        m = self.cfg.model
        init = torch.Generator().manual_seed(seed)
        gen = Generator(m, device=self.device, generator=init, mesh=self.mesh)
        critic = Critic(m, device=self.device, generator=init, mesh=self.mesh)
        return self._state(gen, critic, seed)

    def state_from_flax(self, g_params: Mapping, d_params: Mapping,
                        seed: Optional[int] = None) -> GANTrainState:
        """A state whose nets carry a JAX run's Flax params (numpy trees, e.g.
        `jax.device_get(state.g_params)`), with fresh optimizers; the EMA
        (if on) starts from the generator's params."""
        m, mesh = self.cfg.model, self.mesh
        gen = Generator(m, device=self.device, mesh=mesh)
        load_full_state_dict_(gen, flax_to_state_dict(g_params), mesh)
        critic = Critic(m, device=self.device, mesh=mesh)
        load_full_state_dict_(critic, flax_to_state_dict(d_params), mesh)
        return self._state(gen, critic, self.cfg.train.seed if seed is None else seed)

    def _advance(self, state: GANTrainState, n: int) -> None:
        """Host bookkeeping of `n` steps run on the device."""
        state.step += n
        state.g_opt.count += n
        state.d_opt.count += n * self.cfg.train.n_critic

    # ------------------------------------------------------------- the step
    def _check_batch_size(self, B: int) -> None:
        M = self.cfg.train.grad_accum
        if B % M:
            raise ValueError(f"batch size {B} is not divisible by train.grad_accum={M}")

    def _tensors(self, batch: Batch):
        """(real [B, n_genes] f32, cond dict or None) on the device."""
        missing = [k for k in ("genes", *self.keys) if k not in batch]
        if missing:
            raise ValueError(f"batch lacks keys {missing}")
        self._check_batch_size(len(batch["genes"]))
        if self.mesh is not None:
            batch = place_batch(self.mesh, batch,
                                expected_global_rows=self.cfg.train.batch_size)
        real = torch.as_tensor(batch["genes"], dtype=torch.float32, device=self.device)
        cond = ({k: to_device(batch[k], self.device) for k in self.keys}
                if self.keys else None)
        return real, cond

    def _draw_keys(self):
        keys = ("z", "alpha", "z_gen")
        return keys + ("gate", "noise_real", "noise_fake") if self.cfg.train.p_aug > 0 else keys

    def _rows(self, draws: Dict[str, torch.Tensor], stacked: int = 0
              ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch's draws (all of them without
        a mesh); `stacked` leading axes come before each draw's own."""
        if self.mesh is None:
            return draws
        return {k: (v if k not in DRAW_BATCH_DIM else
                    batch_rows(v, self.mesh, DRAW_BATCH_DIM[k] + stacked))
                for k, v in draws.items()}

    def _draws(self, state: GANTrainState, B: int) -> Dict[str, torch.Tensor]:
        """One step's random draws from `state.rng` (the keys of `step`'s
        `draws`; the noise unscaled) for a batch of B rows on this rank:
        drawn for the global batch (B times the data axis) and cut to this
        rank's rows under a mesh."""
        t, m = self.cfg.train, self.cfg.model
        if self.mesh is not None:
            B *= self.mesh.shape["data"]
        g, dev, n = state.rng, self.device, t.n_critic
        draws = {"z": torch.randn(n, B, m.latent_dim, generator=g, device=dev),
                 "alpha": torch.rand(n, B, 1, generator=g, device=dev),
                 "z_gen": torch.randn(B, m.latent_dim, generator=g, device=dev)}
        if t.p_aug > 0:
            draws["gate"] = (torch.rand(n, generator=g, device=dev) < t.p_aug).float()
            for k in ("noise_real", "noise_fake"):
                draws[k] = torch.randn(n, B, m.n_genes, generator=g, device=dev)
        return self._rows(draws)

    def embed_generator(self, state: GANTrainState, cond) -> Optional[torch.Tensor]:
        """per_update: the generator's condition embedding for the step's
        fakes (no grad). None on the per_call path."""
        if not self.reuse or cond is None:
            return None
        with torch.no_grad():
            return state.gen.embed_cond(cond)

    def _critic_scores(self, critic: Critic, real, fake, cond, alpha):
        """(d_real, d_fake, gp) of one critic update, on the graph."""
        t = self.cfg.train
        if self.reuse:
            cvec = critic.embed_cond(cond)
            if t.batched_scores:
                cv = None if cvec is None else torch.cat([cvec, cvec, cvec], dim=0)
                return losses.batched_scores_and_gp(
                    lambda x: critic.score(x, cv), real, fake, alpha)
            d_real = critic.score(real, cvec)
            d_fake = critic.score(fake, cvec)
        else:
            d_real = critic(real, cond)
            d_fake = critic(fake, cond)
            cvec = critic.embed_cond(cond)
        gp = losses.gradient_penalty(lambda x: critic.score(x, cvec), real, fake, alpha)
        return d_real, d_fake, gp

    def hoisted_fakes(self, state: GANTrainState, g_cvec, z) -> torch.Tensor:
        """`hoist_fakes`: the fakes of every critic update, [n_critic, B,
        n_genes], from one generator trunk forward over the stacked z
        [n_critic, B, latent] and the embedding tiled to match (no grad)."""
        n, B = z.shape[:2]
        cv = None if g_cvec is None else g_cvec.repeat(n, 1)
        with torch.no_grad():
            return state.gen.score(z.reshape(n * B, -1), cv).reshape(n, B, -1)

    def critic_update(self, state: GANTrainState, real, cond, g_cvec, z, alpha,
                      noise=None, fake=None):
        """One critic update on fakes made from `z` (or on `fake`, already
        made: `hoisted_fakes`); returns the detached
        (Wasserstein loss E[D(fake)] - E[D(real)], gp, mean D(real), mean
        D(fake)). The update descends that loss + gp_weight * gp (+ drift).
        `noise` = (gate, noise_real, noise_fake) adds instance noise, gate *
        noise * norm_scale, to real and fake. Advances the critic
        optimizer's device count only (`_advance` does the host's).

        With `train.grad_accum` = M > 1 the batch is taken in M strided
        microbatches (`_micro`), each with its slice of the full-batch draws
        and of `g_cvec`; their gradients and the returned terms are averaged,
        then the optimizer updates once."""
        t = self.cfg.train
        M = t.grad_accum
        grads = aux = None
        for m in range(M):
            real_m, cond_m, g_cvec_m, z_m = (_micro(x, m, M) for x in (real, cond, g_cvec, z))
            fake_m = _micro(fake, m, M)
            if fake_m is None:
                with torch.no_grad():
                    fake_m = (state.gen.score(z_m, g_cvec_m) if g_cvec_m is not None
                              else state.gen(z_m, cond_m))
            if noise is not None:
                gate, noise_real, noise_fake = noise
                fake_m = fake_m + gate * (_micro(noise_fake, m, M) * t.norm_scale)
                real_m = real_m + gate * (_micro(noise_real, m, M) * t.norm_scale)
            d_real, d_fake, gp = self._critic_scores(state.critic, real_m, fake_m, cond_m,
                                                     _micro(alpha, m, M))
            loss = losses.d_loss(d_real, d_fake)[0]
            total = loss + t.gp_weight * gp
            if t.drift_epsilon > 0:
                total = total + t.drift_epsilon * losses.drift_penalty(d_real, d_fake)
            TRACER.stage("critic_forward")
            grads = _accumulate(grads, torch.autograd.grad(total, state.d_opt.params))
            aux = _accumulate(aux, (x.detach() for x in (loss, gp, d_real.mean(),
                                                           d_fake.mean())))
            TRACER.stage("critic_backward")
        if M > 1:
            grads, aux = [g / M for g in grads], [a / M for a in aux]
        state.d_opt.update(grads)
        TRACER.stage("optimizer")
        return tuple(aux)

    def generator_update(self, state: GANTrainState, cond, z) -> torch.Tensor:
        """One generator update; returns the detached generator loss. With
        `train.grad_accum` = M > 1, M strided microbatches of `z` (and
        `cond`), gradients and loss averaged; under per_update the critic
        embeds the full batch once, sliced per microbatch."""
        critic = state.critic
        M = self.cfg.train.grad_accum
        d_cvec = None
        if self.reuse and cond is not None:
            # no generator gradient flows through the critic's fusion
            with torch.no_grad():
                d_cvec = critic.embed_cond(cond)
        grads = gl = None
        for m in range(M):
            cond_m = _micro(cond, m, M)
            fake = state.gen(_micro(z, m, M), cond_m)
            scores = (critic.score(fake, _micro(d_cvec, m, M)) if d_cvec is not None
                      else critic(fake, cond_m))
            loss = losses.g_loss(scores)
            grads = _accumulate(grads, torch.autograd.grad(loss, state.g_opt.params))
            gl = loss.detach() if gl is None else gl + loss.detach()
        if M > 1:
            grads, gl = [g / M for g in grads], gl / M
        TRACER.stage("generator")
        state.g_opt.update(grads)
        return gl

    @torch.no_grad()
    def _update_ema(self, state: GANTrainState) -> None:
        """e = d e + (1 - d) p over the generator's params."""
        d = self.cfg.train.ema_decay
        ema = list(state.g_ema.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(state.gen.parameters()), alpha=1.0 - d)

    def _fused_step(self, state: GANTrainState, real: torch.Tensor, cond,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """The step's device work on device inputs; no host state changes
        and no host synchronisation, so a CUDA graph can capture it."""
        t = self.cfg.train
        self._check_batch_size(real.shape[0])
        if draws is None:
            draws = self._draws(state, real.shape[0])
        state.gen.train()
        state.critic.train()
        g_cvec = self.embed_generator(state, cond)
        fakes = self.hoisted_fakes(state, g_cvec, draws["z"]) if self.hoist else None
        TRACER.stage("embed")
        aux = None
        for i in range(t.n_critic):
            noise = (None if t.p_aug <= 0 else
                     (draws["gate"][i], draws["noise_real"][i], draws["noise_fake"][i]))
            aux = self.critic_update(state, real, cond, g_cvec, draws["z"][i],
                                     draws["alpha"][i], noise,
                                     None if fakes is None else fakes[i])
        gl = self.generator_update(state, cond, draws["z_gen"])
        if state.g_ema is not None:
            self._update_ema(state)
        TRACER.stage("optimizer")
        d_loss, gp, d_real, d_fake = aux
        metrics = {"d_loss": d_loss, "g_loss": gl, "gp": gp,
                   "d_real": d_real, "d_fake": d_fake}
        if self.mesh is not None:
            # the global batch's means: each rank's over its rows, averaged
            vals = comm.mean_over([torch.stack(list(metrics.values()))], self.mesh, "data")[0]
            metrics = dict(zip(metrics, vals.unbind(0)))
        return metrics

    def step(self, state: GANTrainState, batch: Batch,
             draws: Optional[Mapping[str, Any]] = None):
        """One fused step. Returns (state, metrics), metrics as 0-d tensors
        on the device, as the JAX engine reports them: d_loss (the
        Wasserstein part, without the penalty), gp, d_real, d_fake of the
        last critic update, and g_loss.

        `draws` replaces the step's random draws: "z" [n_critic, B, latent]
        and "alpha" [n_critic, B, 1] for the critic updates, "z_gen"
        [B, latent] for the generator update, and with `p_aug` > 0 "gate"
        [n_critic] (0/1) and the unscaled N(0, 1) "noise_real" and
        "noise_fake" [n_critic, B, n_genes]. Under a mesh `batch` is this
        rank's shard and `draws` the global batch's (B = the global rows)."""
        real, cond = self._tensors(batch)
        if draws is not None:
            draws = self._rows({k: torch.tensor(np.asarray(draws[k]), dtype=torch.float32,
                                                device=self.device)
                                for k in self._draw_keys()})
        metrics = self._fused_step(state, real, cond, draws)
        self._advance(state, 1)
        return state, metrics

    # ------------------------------------------------------------ many steps
    def _copy_in(self, buffer: torch.Tensor, x: torch.Tensor) -> None:
        """Copy `x` into the first rows of the static `buffer`; a host array
        goes through pinned memory and does not block the host."""
        if x.device.type == "cpu" and buffer.device.type == "cuda":
            x = x.pin_memory()
        buffer[:len(x)].copy_(x, non_blocking=True)

    def step_many(self, state: GANTrainState, stacked: Mapping[str, Any],
                  draws: Optional[Mapping[str, Any]] = None):
        """K fused steps over batches stacked on a leading axis [K, B, ...]
        (numpy or torch; `draws` likewise stacked [K, ...] per key of
        `step`'s). Returns (state, metrics of the last step), with
        `state.step` and both optimizers' counts advanced by K.

        The stack is copied once into static device buffers; the graph
        reads row k through a device step index. One graph is kept per
        batch layout (keys, per-batch shapes and dtypes, draws or not) and
        state, and reused for any K up to its buffers' rows."""
        arrays = {k: _host_tensor(stacked[k]) for k in ("genes", *self.keys)}
        if draws is not None:
            arrays.update({f"draw:{k}": v.float() for k, v in self._rows(
                {k: _host_tensor(draws[k]) for k in self._draw_keys()}, stacked=1).items()})
        K = len(arrays["genes"])
        if K < 1 or any(len(x) != K for x in arrays.values()):
            raise ValueError(f"step_many needs K >= 1 batches on every key's leading "
                             f"axis, got {[tuple(x.shape) for x in arrays.values()]}")
        layout = tuple((k, tuple(x.shape[1:]), _buffer_dtype(x)) for k, x in arrays.items())
        graph = self._graphs.get(layout)
        if graph is None or graph.state is not state or len(graph.buffers["genes"]) < K:
            buffers = {k: torch.empty((K, *shape), dtype=dtype, device=self.device)
                       for k, shape, dtype in layout}
            graph = _StepGraph(self, state, buffers, self._stacked_inputs(buffers))
            self._graphs[layout] = graph
        for k, x in arrays.items():
            self._copy_in(graph.buffers[k], x)
        metrics = graph.run(K)
        self._advance(state, K)
        return state, metrics

    def _stacked_inputs(self, buffers: Dict[str, torch.Tensor]) -> Inputs:
        keys = self.keys

        def inputs(i):
            real = _row(buffers["genes"], i)
            cond = {k: _row(buffers[k], i) for k in keys} if keys else None
            draws = {k[5:]: _row(b, i) for k, b in buffers.items() if k.startswith("draw:")}
            return real, cond, draws or None

        return inputs

    def step_many_cached(self, state: GANTrainState, cache, epoch: Optional[int] = None):
        """One epoch of fused steps streaming batches from a `DeviceCache`
        (or a `ShardedDeviceCache`):
        each step gathers (and patch-subsamples) its batch from the resident
        bank inside the step, as the JAX `step_many_cached` does inside its
        scan. The same training as `step_many(state,
        cache.stacked_epoch(e))`, but device memory stays O(bank + one
        batch). One graph per cache (and state); each epoch copies in only
        the [K, B] index table and the subsampling scores."""
        if cache.device != self.device:
            raise ValueError(f"the cache is on {cache.device}, the engine on {self.device}")
        missing = [k for k in ("genes", *self.keys) if k not in cache.arrays]
        if missing:
            raise ValueError(f"the cache lacks keys {missing}")
        sharded = getattr(cache, "mesh", None) is not None
        if sharded and cache.mesh is not self.mesh:
            raise ValueError(
                "step_many_cached with a ShardedDeviceCache needs the engine and the "
                "cache to share one mesh (engine mesh "
                f"{None if self.mesh is None else self.mesh.shape}, cache mesh "
                f"{cache.mesh.shape})")
        with TRACER.span("fit.epoch_spec"):
            idx, scores = cache.epoch_spec(epoch)
            if self.mesh is not None and not sharded:
                # the bank is replicated: this rank gathers its rows of each batch
                idx = batch_rows(idx, self.mesh, 1)
                scores = None if scores is None else batch_rows(scores, self.mesh, 1)
        graph = self._cached_graphs.get(cache)
        if graph is None or graph.state is not state:
            buffers = {"idx": torch.empty_like(idx)}
            if scores is not None:
                buffers["scores"] = torch.empty_like(scores)
            graph = _StepGraph(self, state, buffers, self._cached_inputs(
                cache.arrays, cache.assemble_fn, buffers))
            self._cached_graphs[cache] = graph
        with TRACER.span("fit.feed"):
            graph.buffers["idx"].copy_(idx)
            if scores is not None:
                graph.buffers["scores"].copy_(scores)
        with TRACER.span("fit.replays"):
            metrics = graph.run(len(idx))
        self._advance(state, len(idx))
        return state, metrics

    def _cached_inputs(self, arrays, assemble, buffers) -> Inputs:
        # closes over the bank and the assembler, not the cache, so the
        # weak-keyed entry dies with the cache
        keys = self.keys

        def inputs(i):
            scores = _row(buffers["scores"], i) if "scores" in buffers else None
            batch = assemble(arrays, _row(buffers["idx"], i), scores)
            return batch["genes"], ({k: batch[k] for k in keys} if keys else None), None

        return inputs

    # -------------------------------------------------------------- the loop
    def fit(self, state: GANTrainState, epochs: int,
            batches_fn: Optional[Callable[[], Iterable[Batch]]] = None,
            on_epoch_end: Optional[Callable] = None, logger=None,
            stacked_fn: Optional[Callable] = None, start_epoch: int = 0,
            scan_cache=None) -> GANTrainState:
        """Epochs [start_epoch, epochs), as the JAX `fit`: `scan_cache` (a
        `DeviceCache`) runs each epoch through `step_many_cached`,
        `stacked_fn(epoch)` (a [K, B, ...] stack) through `step_many`, else
        `batches_fn()` through `step`. `history` keeps each epoch's last
        d_loss and g_loss; `logger.log(step, **metrics)` gets them too.
        `on_epoch_end(engine, state, epoch)` may return a replacement state.

        Resuming from a restored state with `start_epoch` trains on the
        batches the uninterrupted run would have: both loaders draw epoch
        e's order from `RandomState(seed + e)`, and the cache's subsampling
        scores from (seed, e)."""
        if batches_fn is None and stacked_fn is None and scan_cache is None:
            raise ValueError("fit() needs batches_fn, stacked_fn, or scan_cache")
        history = {"d_loss": [], "g_loss": []}
        for epoch in range(start_epoch, epochs):
            with TRACER.span("fit.epoch"):
                TRACER.count("epochs")
                metrics = None
                if scan_cache is not None:
                    state, metrics = self.step_many_cached(state, scan_cache, epoch)
                elif stacked_fn is not None:
                    state, metrics = self.step_many(state, stacked_fn(epoch))
                else:
                    for batch in batches_fn():
                        state, metrics = self.step(state, batch)
                if metrics is not None:
                    with TRACER.span("fit.sync"):  # the host waits for the epoch here
                        history["d_loss"].append(float(metrics["d_loss"]))
                        history["g_loss"].append(float(metrics["g_loss"]))
                    TRACER.read()
                    if logger is not None:
                        with TRACER.span("fit.log"):
                            logger.log(state.step, **metrics)
                if on_epoch_end is not None:
                    with TRACER.span("fit.on_epoch_end"):
                        state = on_epoch_end(self, state, epoch) or state
        self.history = history
        return state

    # -------------------------------------------------------------- sampling
    def _sampler(self, state: GANTrainState, use_ema: Optional[bool]) -> GeneratorServer:
        """The EMA generator when `use_ema` (default: whenever the state
        tracks one), else the trained one, as the JAX `_gen_params`."""
        use_ema = state.g_ema is not None if use_ema is None else use_ema
        if use_ema and state.g_ema is None:
            raise ValueError("use_ema=True but the state has no EMA generator "
                             "(set train.ema_decay > 0 before init_state)")
        return GeneratorServer.for_module(state.g_ema if use_ema else state.gen)

    def generate_samples(self, state: GANTrainState, generator: torch.Generator,
                         batch: Batch, use_ema: Optional[bool] = None) -> torch.Tensor:
        """Fakes [B, n_genes] (on the device) for one batch's conditioning,
        one embedding per batch, z drawn from `generator`."""
        return self._sampler(state, use_ema).sample(
            batch if self.keys else None, generator,
            n=None if self.keys else batch["genes"].shape[0])

    def generate_samples_all(self, state: GANTrainState, batches, num_repeats: int,
                             generator: torch.Generator, use_ema: Optional[bool] = None,
                             device_out: bool = False, scan: bool = False,
                             host_dtype=None) -> Dict[str, Any]:
        """`GeneratorServer.sample_all` with the state's generator (its EMA
        by default when it tracks one). `batches` may be a callable returning
        a fresh iterable (streamed one batch at a time off a `DeviceCache`);
        `device_out=True` keeps "real" and "fake" as device tensors;
        `scan=True` replays one CUDA graph per batch shape (the same
        profiles, bit for bit); `host_dtype` (e.g. float16) casts "real" and
        "fake" on the device before the copy to the host."""
        return self._sampler(state, use_ema).sample_all(batches, num_repeats, generator,
                                                        device_out=device_out, scan=scan,
                                                        host_dtype=host_dtype)
