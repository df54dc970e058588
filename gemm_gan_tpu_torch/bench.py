"""The flagship's training-step rate on the card.

    python -m gemm_gan_tpu_torch.bench [--dtype bfloat16|float32]
                                       [--scan_len 100] [--n_calls 4]

Counterpart of `bench.py`'s step measurement (`jax_steps_per_sec`, `main`),
with its constants copied (nothing of `bench.py` is imported): the
flagship `film_cross_attention` at batch 8, 18,868 genes, 256 x 1024
patches, 300 x 768 tokens, latent 256, n_critic 5, in the bench
configuration (`cond_embed_reuse="per_update"`, batched scores,
`compute_dtype="bfloat16"` by default) from a random init of seed 0. The
seeded batch of `bench.py` (numpy `RandomState(0)`) is broadcast to
`scan_len` rows and placed on the card once, before timing, as JAX's
`device_put`; `WGANGPEngine.step_many` then copies it device to device
into its static buffers and replays one CUDA graph of the fused step per
row. Each of `n_calls` calls is synchronised by reading `d_loss` to the
host; the first (the eager warm-up step and the graph's capture) is
dropped, and the best of the rest is reported as steps/s.

Prints one JSON line: `metric` ("wgan_gp_flagship_steps_per_sec"),
`value`, `unit`, `compute_dtype`, `scan_len`, `n_calls`, each call's
seconds, and the card's `name` and `power_limit` (from `nvidia-smi`).
`bench.py`'s PyTorch-CPU "reference" denominator and its `vs_baseline*`
keys are left out: they time the host's CPU, not the port. It runs on
the card unless `--device cpu` is asked for (a check of the harness,
not a measurement of the card), raises without one, and writes no file.
`measure` is the same measurement as a function, for callers that have
already built the kernels (`chip_smoke.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.config import ExperimentConfig, variant_config
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device

B = 8
N_GENES = 18868
N_PATCHES = 256
PATCH_DIM = 1024
N_TOKENS = 300
TEXT_DIM = 768
LATENT = 256
N_CRITIC = 5
METRIC = "wgan_gp_flagship_steps_per_sec"


def bench_config(dtype: str = "bfloat16") -> ExperimentConfig:
    """The flagship at the published widths in the bench configuration."""
    cfg = variant_config("film_cross_attention", n_genes=N_GENES)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype, latent_dim=LATENT),
        train=dataclasses.replace(cfg.train, cond_embed_reuse="per_update",
                                  n_critic=N_CRITIC))


def bench_batch(rng: np.random.RandomState) -> dict:
    """`bench.py`'s batch: N(0, 1) genes, tokens and patches, all valid."""
    return {
        "genes": rng.randn(B, N_GENES).astype(np.float32),
        "tokens": rng.randn(B, N_TOKENS, TEXT_DIM).astype(np.float32),
        "token_mask": np.ones((B, N_TOKENS), dtype=bool),
        "patches": rng.randn(B, N_PATCHES, PATCH_DIM).astype(np.float32),
        "patch_mask": np.ones((B, N_PATCHES), dtype=bool),
    }


def device_name(dev: torch.device) -> dict:
    """{"name", "power_limit"} of the card, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them (the CUDA runtime's
    name and "not measured" where nvidia-smi cannot be run); the CPU's is
    "cpu" with no power limit."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True,
            timeout=30).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name, power = torch.cuda.get_device_name(dev), "not measured"
    return {"name": name, "power_limit": power}


def measure(dtype: str = "bfloat16", scan_len: int = 100, n_calls: int = 4,
            device: DeviceLike = None, cfg: Optional[ExperimentConfig] = None,
            batch: Optional[dict] = None) -> dict:
    """Steps/s of `step_many` over `scan_len` copies of the batch (module
    docstring); `cfg` / `batch` replace the bench's (smaller shapes, for
    a check of the harness). Returns the JSON record."""
    from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

    if n_calls < 2:
        raise ValueError(f"n_calls must be >= 2 (the first is dropped), got {n_calls}")
    dev = resolve_device(device)
    cfg = bench_config(dtype) if cfg is None else cfg
    batch = bench_batch(np.random.RandomState(0)) if batch is None else batch
    engine = WGANGPEngine(cfg, steps_per_epoch=100, device=dev)
    state = engine.init_state(0, batch)
    stacked = {k: torch.as_tensor(v, device=dev).expand(scan_len, *v.shape).contiguous()
               for k, v in batch.items()}
    times = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        state, metrics = engine.step_many(state, stacked)
        float(metrics["d_loss"])  # the host waits for the device
        times.append(time.perf_counter() - t0)
    return {"metric": METRIC, "value": scan_len / min(times[1:]), "unit": "steps/s",
            "compute_dtype": cfg.model.compute_dtype, "scan_len": scan_len,
            "n_calls": n_calls, "call_seconds": times, **device_name(dev)}


def main(argv=None, cfg: Optional[ExperimentConfig] = None,
         batch: Optional[dict] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--scan_len", type=int, default=100)
    ap.add_argument("--n_calls", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' checks the harness on the host (default: the card)")
    args = ap.parse_args(argv)
    record = measure(args.dtype, args.scan_len, args.n_calls, args.device, cfg, batch)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
