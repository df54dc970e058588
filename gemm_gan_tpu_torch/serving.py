"""Serving a trained generator on the card.

Counterpart of `gemm_gan_tpu/serving.py` and of the engine's sampling paths
(`WGANGPEngine.generate_samples` / `generate_samples_all`). A run dir holds
the JAX run's `config.json` and the generator's Flax params as
`generator_params.npz` (written by `convert.save_params_npz`);
:meth:`GeneratorServer.load` rebuilds the generator from them.

The server is the pure function ``(z, cond) -> profiles`` of the JAX
artifact: the caller draws z, or hands a `torch.Generator` to
:meth:`GeneratorServer.sample`. Everything runs under
`torch.inference_mode()`. A BatchNorm trunk (`model.use_batchnorm`) is
served from its running statistics, which the weights must carry: the JAX
serving path applies params alone and fails without them, so
`from_flax(cfg, params)` and `load(run_dir)` raise `ValueError` for such a
generator, as does a state dict without them.

Serving artifacts (`export_generator`, `export_vae_decoder`,
`GeneratorArtifact`), the counterparts of the JAX package's `jax.export`
ones: the sampling computation with the trained weights inside, traced by
`torch.export` and saved with `torch.export.save`. Loading needs no model
code, config or checkpoint, only torch and the port's kernel module, which
registers the attention op the program calls (`kernels.flash_attention.
masked_mha_op`). Layout on disk (a directory):

    <path>/generator.pt2     the ExportedProgram (graph + weights)
    <path>/manifest.json     input signature: cond keys in call order,
                             shapes and dtypes, latent dim, variant, device

The program is ``(z, *cond_tensors) -> profiles`` with the cond tensors in
``manifest["cond_spec"]`` order; z is an input, so the artifact is pure.
The batch dim and the token and patch sequence lengths are symbolic by
default (`torch.export.Dim`): one artifact serves any batch size and any
patch count, and with `fusion.use_pallas` its attention op chooses the
kernel from the real shapes at every call (Q1 at 256 patches, Q3 above 512
tokens). Unlike the JAX artifact, which lowers for several platforms, the
program's weights live on one device, the one it was exported on
(``manifest["platforms"]``: ``["cuda"]`` or ``["cpu"]``).
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig, ModelConfig, load_config
from gemm_gan_tpu_torch.convert import flax_to_state_dict, load_params_npz
from gemm_gan_tpu_torch.kernels import flash_attention  # also registers the attention op
from gemm_gan_tpu_torch.models.gan import Generator
from gemm_gan_tpu_torch.utils.device import DeviceLike, host

CONFIG_FILE = "config.json"
PARAMS_FILE = "generator_params.npz"
ARTIFACT_FILE = "generator.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT_VERSION = 1

# conditioning keys each fusion kind reads, in call order
_KIND_KEYS = {
    "none": (),
    "concat": None,  # depends on condition_type, resolved below
    "attention": ("text_emb", "patches", "patch_mask"),
    "img_transformer": ("patches", "patch_mask"),
    "film": ("text_emb", "patches", "patch_mask"),
    "xattn": ("tokens", "token_mask", "patches", "patch_mask"),
    "film_xattn": ("tokens", "token_mask", "patches", "patch_mask"),
    "labels": ("disease", "site"),
}


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A conditioning array (numpy or torch) on `device`. Floating arrays go
    as float32, whatever their dtype, as the JAX package (64-bit off) takes
    them; masks and labels keep theirs."""
    t = torch.as_tensor(x, device=device)
    return t.float() if t.is_floating_point() else t


def cond_keys_for(fusion_cfg) -> Tuple[str, ...]:
    """The conditioning keys a fusion config consumes, in call order."""
    keys = _KIND_KEYS.get(fusion_cfg.kind)
    if keys is not None:
        return keys
    if fusion_cfg.kind == "concat":
        return (("text_emb",) if fusion_cfg.condition_type == "text"
                else ("patches", "patch_mask"))
    raise ValueError(f"unknown fusion kind {fusion_cfg.kind!r}")


class GeneratorServer:
    """A generator with fixed weights on one device.

    `__call__(z, cond)` -> profiles [B, n_genes] (a tensor on the device);
    `sample` draws z; `sample_all` serves a list of batches, embedding each
    batch's conditioning once for all its repeats."""

    def __init__(self, cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor],
                 device: DeviceLike = None):
        gen = Generator(cfg, device=device)
        stats = [k for k, _ in gen.named_buffers() if k.endswith(("running_mean", "running_var"))]
        missing = [k for k in stats if k not in state_dict]
        if missing:
            # JAX's serving applies {"params": ...} alone, which a BatchNorm
            # trunk refuses for want of its batch_stats collection
            raise ValueError(
                f"model.use_batchnorm=True: the generator's BatchNorm statistics (Flax's "
                f"batch_stats collection) are missing from its weights: {missing}; JAX's "
                f"serving applies the params alone and fails without them. Pass them "
                f"(convert.flax_to_state_dict(params, batch_stats)) rather than serving the "
                f"initial statistics")
        gen.load_state_dict(state_dict)
        self._wrap(cfg, gen)

    def _wrap(self, cfg: ModelConfig, gen: Generator) -> None:
        self.cfg = cfg
        self.gen = gen.eval()
        self.mesh = gen.mesh
        self.device = next(gen.parameters()).device
        self.keys = cond_keys_for(cfg.fusion)
        self._graphs: Dict[tuple, "_SampleGraph"] = {}  # sample_all(scan=True)

    @classmethod
    def for_module(cls, gen: Generator) -> "GeneratorServer":
        """Serve an existing generator (a training run's) as it stands,
        sharing its weights (and a BatchNorm trunk's running statistics).
        Switches it to eval mode. A generator on a mesh (a training run's
        under a mesh, `gen.mesh`) is served by every rank at once, on the
        same batches and z generator: each batch's rows are split over the
        mesh's `data` axis (padded to a multiple of it with copies of the
        last row) and the profiles all-gathered, so every rank returns
        them all, as JAX's sharded sampling."""
        server = cls.__new__(cls)
        server._wrap(gen.cfg, gen)
        return server

    def _split(self, c: Optional[Dict[str, torch.Tensor]], zs):
        """This rank's rows of a batch's conditioning and z draws."""
        D = 1 if self.mesh is None else self.mesh.shape["data"]
        if D == 1:
            return c, zs
        from gemm_gan_tpu_torch.parallel.sharding import batch_rows

        def rows(x):
            pad = -len(x) % D
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            return batch_rows(x, self.mesh)

        return (None if c is None else {k: rows(v) for k, v in c.items()},
                [rows(z) for z in zs])

    def _gather(self, f: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's profiles [..., rows, n_genes] of one batch, the
        first `n` rows."""
        if self.mesh is None or self.mesh.shape["data"] == 1:
            return f
        from gemm_gan_tpu_torch.parallel import comm

        return comm.all_gather(f, self.mesh, "data", dim=-2).narrow(-2, 0, n)

    @classmethod
    def from_flax(cls, cfg: ModelConfig, params: Mapping,
                  device: DeviceLike = None) -> "GeneratorServer":
        return cls(cfg, flax_to_state_dict(params), device=device)

    @classmethod
    def load(cls, run_dir: str, device: DeviceLike = None) -> "GeneratorServer":
        """Read `config.json` and `generator_params.npz` from `run_dir`."""
        cfg: ExperimentConfig = load_config(os.path.join(run_dir, CONFIG_FILE))
        params = load_params_npz(os.path.join(run_dir, PARAMS_FILE))
        return cls.from_flax(cfg.model, params, device=device)

    def cond_tensors(self, cond: Optional[Mapping[str, Any]]
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """The conditioning arrays this generator reads (numpy or torch), as
        tensors on its device (`to_device`); None when it reads none."""
        if not self.keys:
            return None
        if cond is None:
            raise ValueError(f"the generator requires conditioning inputs "
                             f"{list(self.keys)}, got none")
        missing = [k for k in self.keys if k not in cond]
        if missing:
            raise ValueError(f"conditioning lacks keys {missing}")
        return {k: to_device(cond[k], self.device) for k in self.keys}

    def _z(self, n: int, generator: torch.Generator) -> torch.Tensor:
        z = torch.randn(n, self.cfg.latent_dim, generator=generator,
                        device=generator.device)
        return z.to(self.device)

    def __call__(self, z, cond: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """z [B, latent] (+ cond dict) -> profiles [B, n_genes]."""
        with torch.inference_mode():
            z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
            return self.gen(z, self.cond_tensors(cond))

    def sample(self, cond: Optional[Mapping[str, Any]], generator: torch.Generator,
               n: Optional[int] = None) -> torch.Tensor:
        """Draw z ~ N(0, 1) from `generator` and generate. `n` defaults to the
        conditioning batch size (required when the generator is
        unconditional)."""
        with torch.inference_mode():
            c = self.cond_tensors(cond)
            if n is None:
                if c is None:
                    raise ValueError("unconditional generator: pass n")
                n = next(iter(c.values())).shape[0]
            c, (z,) = self._split(c, [self._z(n, generator)])
            return self._gather(self.gen(z, c), n)

    def sample_all(self, batches, num_repeats: int, generator: torch.Generator,
                   device_out: bool = False, scan: bool = False,
                   host_dtype=None) -> Dict[str, Any]:
        """Fakes for every batch and repeat: each batch's condition
        embedding is computed once and reused by all `num_repeats` z draws,
        as the JAX engine's scan path does. z for (batch k, repeat r) is
        drawn in batch-major order from `generator`.

        `batches`: an iterable of batches, or a callable returning one; they
        are consumed one at a time, so a device-resident loader's epoch
        (`lambda: cache.epoch(e)`) is never held whole on the device.

        `scan=True` amortizes the dispatch, as the JAX engine's `lax.map`:
        every batch of the first batch's shape runs one CUDA graph (the
        embedding, then the R scores, z copied into a static buffer from
        `generator` outside the graph), captured once per shape; a smaller
        (ragged) batch runs eagerly. The graph computes what the per-call
        path computes, bit for bit. On the CPU nothing is captured.

        Returns arrays ordered repeat-major (all batches of repeat 0, then
        repeat 1, ...): "fake" [R * N, n_genes], plus "real", "disease" and
        "site" when the batches carry "genes", "disease" and "site". With
        `device_out` "real" and "fake" are float32 tensors on the device,
        else numpy arrays, cast on the device to `host_dtype` (a torch or
        numpy dtype, e.g. float16: half the bytes over the wire) when given;
        labels are numpy either way."""
        if callable(batches):
            batches = batches()
        dtype = None if device_out or host_dtype is None else _torch_dtype(host_dtype)

        def fetch(x):
            if device_out:
                return x
            x = torch.as_tensor(x, device=self.device) if dtype is not None else x
            return host(x if dtype is None else x.to(dtype))

        fakes = []
        extras = {"real": [], "disease": [], "site": []}
        n_batches, full = 0, None
        with torch.inference_mode():
            for batch in batches:
                n_batches += 1
                c = self.cond_tensors(batch)
                n = (next(iter(c.values())).shape[0] if c is not None
                     else batch["genes"].shape[0])
                full = n if full is None else full
                c_rank, zs = self._split(c, [self._z(n, generator)
                                             for _ in range(num_repeats)])
                if scan and n == full:
                    f = self._sample_graph(c_rank, zs).run(c_rank, zs)
                else:
                    cvec = self.gen.embed_cond(c_rank)
                    f = torch.stack([self.gen.score(z, cvec) for z in zs])  # [R, n, n_genes]
                fakes.append(fetch(self._gather(f, n)))
                if "genes" in batch:
                    extras["real"].append(
                        torch.as_tensor(batch["genes"], dtype=torch.float32, device=self.device)
                        if device_out else fetch(batch["genes"]))
                for key in ("disease", "site"):
                    if key in batch:
                        extras[key].append(host(batch[key]))
            cat = torch.cat if device_out else np.concatenate
            out = {"fake": cat([f[r] for r in range(num_repeats) for f in fakes])}
            for name, parts in extras.items():
                if n_batches and len(parts) == n_batches:
                    out[name] = (cat if name == "real" else np.concatenate)(
                        [p for _ in range(num_repeats) for p in parts])
        return out

    def _sample_graph(self, cond: Optional[Dict[str, torch.Tensor]], zs) -> "_SampleGraph":
        key = (len(zs), tuple(zs[0].shape),
               None if cond is None else tuple((k, tuple(v.shape), v.dtype)
                                               for k, v in cond.items()))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _SampleGraph(self.gen, cond, zs)
        return graph


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class _SampleGraph:
    """The scan path's body for one batch shape: `embed_cond` of static
    cond buffers, then one `score` per static z buffer, stacked
    [R, n, n_genes]. On the card the first run runs it eagerly on a side
    stream (which warms cuBLAS there), then captures it as a CUDA graph on
    that stream; later runs copy their inputs into the buffers and replay
    it. On the CPU the body is called."""

    def __init__(self, gen: Generator, cond: Optional[Dict[str, torch.Tensor]], zs):
        self.gen = gen
        self.cond = None if cond is None else {k: torch.empty_like(v) for k, v in cond.items()}
        self.zs = [torch.empty_like(z) for z in zs]
        self.graph = None
        self.out = None       # the captured body's output, rewritten by each replay
        self.recorded = {}    # kernel launches one replay makes

    def _body(self) -> torch.Tensor:
        cvec = self.gen.embed_cond(self.cond)
        return torch.stack([self.gen.score(z, cvec) for z in self.zs])

    def run(self, cond: Optional[Dict[str, torch.Tensor]], zs) -> torch.Tensor:
        if cond is not None:
            for k, v in cond.items():
                self.cond[k].copy_(v)
        for buf, z in zip(self.zs, zs):
            buf.copy_(z)
        device = self.zs[0].device
        if device.type == "cpu":
            return self._body()
        if self.graph is not None:
            self.graph.replay()
            flash_attention.count_replays(self.recorded, 1)
            return self.out.clone()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = self._body()
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with flash_attention.recorded_launches() as recorded:
            with torch.cuda.graph(graph, stream=stream):
                self.out = self._body()
        self.graph, self.recorded = graph, recorded
        return out


# ------------------------------------------------------------------ artifacts
# keys whose axis 1 is a sequence length, and the symbolic dim that models it
_SEQ_AXIS = {"tokens": "t", "token_mask": "t", "patches": "p", "patch_mask": "p"}
# torch.export specializes dims of size 0 or 1: trace at 2 or more
_MIN_TRACE = 2


def _example(a: torch.Tensor, batch: int, seq: bool) -> torch.Tensor:
    """`a` with `batch` rows (its rows repeated) and, for a sequence key,
    at least `_MIN_TRACE` positions (zero-padded: a padded mask is False)."""
    a = a[torch.arange(batch, device=a.device) % a.shape[0]]
    if seq and a.shape[1] < _MIN_TRACE:
        pad = torch.zeros((batch, _MIN_TRACE - a.shape[1], *a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        a = torch.cat([a, pad], dim=1)
    return a


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _signature(keys, sample_batch, latent_dim: int, batch_size: Optional[int],
               dynamic_seq: bool, device: torch.device):
    """The export's example inputs, their `dynamic_shapes`, the manifest's
    cond_spec and batch descriptor. One `Dim` per symbolic name: b (unless
    `batch_size` fixes it) and, with `dynamic_seq`, t and p for the
    sequence keys present."""
    from torch.export import Dim

    dims = {"b": Dim("b", min=1), "t": Dim("t", min=1), "p": Dim("p", min=1)}
    conds = {k: to_device(sample_batch[k], device) for k in keys}
    n = len(next(iter(conds.values()))) if conds else _MIN_TRACE
    batch = max(n, _MIN_TRACE) if batch_size is None else int(batch_size)
    batch_desc: Any = "dynamic" if batch_size is None else int(batch_size)

    def spec(key: str, a: torch.Tensor):
        shapes, names = {}, [batch_desc if batch_size is not None else "b"]
        names += [int(d) for d in a.shape[1:]]
        if batch_size is None:
            shapes[0] = dims["b"]
        if dynamic_seq and key in _SEQ_AXIS:
            shapes[1] = dims[_SEQ_AXIS[key]]
            names[1] = _SEQ_AXIS[key]
        return shapes or None, names

    z = torch.zeros((batch, latent_dim), device=device)
    z_shape, _ = spec("z", z)
    cond_args, cond_shapes, cond_spec = [], [], []
    for k in keys:
        a = _example(conds[k], batch, dynamic_seq and k in _SEQ_AXIS)
        shapes, names = spec(k, a)
        cond_args.append(a)
        cond_shapes.append(shapes)
        cond_spec.append({"key": k, "shape": names, "dtype": _dtype_name(a.dtype)})
    shapes = (z_shape, tuple(cond_shapes)) if keys else (z_shape,)
    return (z, *cond_args), shapes, cond_spec, batch_desc


class _Sampling(torch.nn.Module):
    """The exported computation: ``score(z, embed_cond(cond))`` of a
    generator, or ``decode(z[, disease, site])`` of a VAE / CVAE."""

    def __init__(self, net: torch.nn.Module, keys: Tuple[str, ...], vae: bool):
        super().__init__()
        self.net, self.keys, self.vae = net, keys, vae

    def forward(self, z, *cond):
        if self.vae:
            return self.net.decode(z, *cond)
        cvec = self.net.embed_cond(dict(zip(self.keys, cond))) if self.keys else None
        return self.net.score(z, cvec)


def _export(net: torch.nn.Module, keys, vae: bool, sample_batch, latent_dim: int,
            batch_size, dynamic_seq: bool, manifest: Dict[str, Any]) -> "GeneratorArtifact":
    missing = [k for k in keys if k not in sample_batch]
    if missing:
        raise ValueError(f"sample_batch lacks conditioning keys {missing}")
    # a copy in eval mode: the artifact keeps its own weights, as the JAX
    # one bakes them in, whatever later happens to the training state's
    net = copy.deepcopy(net).eval()
    device = next(net.parameters()).device
    args, shapes, cond_spec, batch_desc = _signature(keys, sample_batch, latent_dim,
                                                     batch_size, dynamic_seq, device)
    with torch.no_grad():
        program = torch.export.export(_Sampling(net, keys, vae), args,
                                      dynamic_shapes=shapes, strict=False)
    manifest = {"format_version": FORMAT_VERSION, **manifest,
                "latent_dim": int(latent_dim), "batch": batch_desc,
                "platforms": [device.type], "cond_spec": cond_spec}
    return GeneratorArtifact(program=program, manifest=manifest)


@dataclass
class GeneratorArtifact:
    """A loaded (or just-exported) serving artifact: ``program`` is the
    `torch.export.ExportedProgram`, ``manifest`` its input signature. Call
    it with ``(z, cond_dict)`` or draw latents with :meth:`sample`; inputs
    (numpy or torch) go to the program's device and the manifest's dtypes,
    and the output is a tensor on that device."""

    program: Any
    manifest: Dict[str, Any]

    def __post_init__(self):
        self._module = None

    @property
    def device(self) -> torch.device:
        return torch.device(self.manifest["platforms"][0])

    def _cond_tuple(self, cond: Optional[Mapping[str, Any]]) -> tuple:
        spec = self.manifest["cond_spec"]
        if not spec:
            return ()
        if cond is None:
            raise ValueError(f"artifact requires conditioning inputs "
                             f"{[s['key'] for s in spec]}, got none")
        out = []
        for s in spec:
            if s["key"] not in cond:
                raise ValueError(f"conditioning missing key {s['key']!r} "
                                 f"(artifact needs {[t['key'] for t in spec]})")
            out.append(torch.as_tensor(cond[s["key"]], device=self.device,
                                       dtype=getattr(torch, s["dtype"])))
        return tuple(out)

    def _run(self, z, cond_tensors: tuple):
        if self._module is None:
            self._module = self.program.module()
        with torch.inference_mode():
            z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
            return self._module(z, *cond_tensors)

    def __call__(self, z, cond: Optional[Mapping[str, Any]] = None):
        """z [B, latent] (+ cond dict) -> profiles [B, n_genes]."""
        return self._run(z, self._cond_tuple(cond))

    def sample(self, generator: torch.Generator, n: Optional[int] = None,
               cond: Optional[Mapping[str, Any]] = None):
        """Draw z ~ N(0, 1) from `generator` and generate. `n` defaults to
        the conditioning batch size (required when the artifact is
        unconditional)."""
        ct = self._cond_tuple(cond)
        if n is None:
            if not ct:
                raise ValueError("unconditional artifact: pass n")
            n = ct[0].shape[0]
        z = torch.randn(n, self.manifest["latent_dim"], generator=generator,
                        device=generator.device)
        return self._run(z, ct)

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        torch.export.save(self.program, os.path.join(path, ARTIFACT_FILE))
        with open(os.path.join(path, MANIFEST_FILE), "w") as f:
            json.dump(self.manifest, f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "GeneratorArtifact":
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"artifact format {manifest.get('format_version')} != "
                             f"{FORMAT_VERSION}")
        if "cuda" in manifest["platforms"] and not torch.cuda.is_available():
            raise RuntimeError(f"the artifact at {path} was exported on CUDA and its "
                               "weights live there; no CUDA device is available")
        return cls(program=torch.export.load(os.path.join(path, ARTIFACT_FILE)),
                   manifest=manifest)


def export_generator(engine, state, sample_batch: Mapping[str, Any], *,
                     batch_size: Optional[int] = None, dynamic_seq: bool = True,
                     use_ema: Optional[bool] = None) -> GeneratorArtifact:
    """Export a trained generator as a serving artifact.

    ``engine`` / ``state``: a `WGANGPEngine` and its state; the generator
    is the EMA one with ``use_ema``, by default whenever the state tracks
    one (the engine's rule), and the program runs on its device.
    ``sample_batch``: any batch of the run's data; only the conditioning
    keys' trailing shapes and dtypes are read. ``batch_size``: a static
    batch, or None (default) for a symbolic one; ``dynamic_seq`` (default
    True): symbolic token and patch lengths.

    The program is ``score(z, embed_cond(cond))``, the sampling forward of
    ``generate_samples`` with z an input. With ``fusion.use_pallas`` every
    attention is the op ``gemm_gan_tpu_torch::masked_mha`` (its route taken
    at run time, from the real shapes); without it, the plain reference in
    ATen ops."""
    server = engine._sampler(state, use_ema)
    cfg = engine.cfg
    manifest = {"variant": cfg.variant, "fusion_kind": cfg.model.fusion.kind,
                "n_genes": int(cfg.model.n_genes),
                "ema": bool(use_ema if use_ema is not None else state.g_ema is not None)}
    return _export(server.gen, server.keys, False, sample_batch, cfg.model.latent_dim,
                   batch_size, dynamic_seq, manifest)


def export_vae_decoder(engine, state, sample_batch: Mapping[str, Any], *,
                       batch_size: Optional[int] = None) -> GeneratorArtifact:
    """Export a trained VAE / CVAE decoder as a serving artifact: the
    program is ``decode(z[, disease, site])`` with z [B, vae_latent_dim],
    so :meth:`GeneratorArtifact.sample` reproduces the engine's
    decode-from-prior sampling given the same z."""
    cfg = engine.cfg
    keys = ("disease", "site") if engine.conditional else ()
    manifest = {"variant": cfg.variant,
                "fusion_kind": "labels" if engine.conditional else "none",
                "n_genes": int(cfg.model.n_genes), "ema": False}
    return _export(state.model, keys, True, sample_batch, cfg.model.vae_latent_dim,
                   batch_size, False, manifest)
