"""Serving a trained generator on the card.

Counterpart of `gemm_gan_tpu/serving.py` and of the engine's sampling paths
(`WGANGPEngine.generate_samples` / `generate_samples_all`). A run dir holds
the JAX run's `config.json` and the generator's Flax params as
`generator_params.npz` (written by `convert.save_params_npz`);
:meth:`GeneratorServer.load` rebuilds the generator from them.

The server is the pure function ``(z, cond) -> profiles`` of the JAX
artifact: the caller draws z, or hands a `torch.Generator` to
:meth:`GeneratorServer.sample`. Everything runs under
`torch.inference_mode()`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig, ModelConfig, load_config
from gemm_gan_tpu_torch.convert import flax_to_state_dict, load_params_npz
from gemm_gan_tpu_torch.models.gan import Generator
from gemm_gan_tpu_torch.utils.device import DeviceLike, host

CONFIG_FILE = "config.json"
PARAMS_FILE = "generator_params.npz"

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
        gen.load_state_dict(state_dict)
        self._wrap(cfg, gen)

    def _wrap(self, cfg: ModelConfig, gen: Generator) -> None:
        self.cfg = cfg
        self.gen = gen.eval()
        self.device = next(gen.parameters()).device
        self.keys = cond_keys_for(cfg.fusion)

    @classmethod
    def for_module(cls, gen: Generator) -> "GeneratorServer":
        """Serve an existing generator (a training run's) as it stands,
        sharing its weights. Switches it to eval mode."""
        server = cls.__new__(cls)
        server._wrap(gen.cfg, gen)
        return server

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
            return self.gen(self._z(n, generator), c)

    def sample_all(self, batches, num_repeats: int, generator: torch.Generator,
                   device_out: bool = False) -> Dict[str, Any]:
        """Fakes for every batch and repeat, as the JAX engine's
        `generate_samples_all(scan=True)`: each batch's condition embedding
        is computed once and reused by all `num_repeats` z draws. z for
        (batch k, repeat r) is drawn in batch-major order from `generator`.

        `batches`: an iterable of batches, or a callable returning one; they
        are consumed one at a time, so a device-resident loader's epoch
        (`lambda: cache.epoch(e)`) is never held whole on the device.

        Returns arrays ordered repeat-major (all batches of repeat 0, then
        repeat 1, ...): "fake" [R * N, n_genes], plus "real", "disease" and
        "site" when the batches carry "genes", "disease" and "site". With
        `device_out` "real" and "fake" are float32 tensors on the device,
        else numpy arrays; labels are numpy either way."""
        if callable(batches):
            batches = batches()
        fakes = []
        extras = {"real": [], "disease": [], "site": []}
        n_batches = 0
        with torch.inference_mode():
            for batch in batches:
                n_batches += 1
                c = self.cond_tensors(batch)
                n = (next(iter(c.values())).shape[0] if c is not None
                     else batch["genes"].shape[0])
                cvec = self.gen.embed_cond(c)
                f = torch.stack([self.gen.score(self._z(n, generator), cvec)
                                 for _ in range(num_repeats)])  # [R, n, n_genes]
                fakes.append(f if device_out else f.cpu().numpy())
                if "genes" in batch:
                    extras["real"].append(
                        torch.as_tensor(batch["genes"], dtype=torch.float32, device=self.device)
                        if device_out else host(batch["genes"]))
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
