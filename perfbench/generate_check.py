"""Whether a generate run's profiles are the ones its generator makes: the
plain reference recomputes the profiles of the batches the run kept, and
two numbers compare them.

The reference (`reference/<architecture>.py`'s `Net`, eval mode: no
dropout) gets what the benchmark handed the program: the generator's
weights and each checked batch's conditioning, a copy of the bank's rows,
its embeddings widened to float32 as the serving path takes them
(`serving.to_device`). It computes in the configuration's compute dtype,
bfloat16 as Flax's Dense computes, with TF32 off. It works z out again as
the program drew it: batch-major from a device generator seeded as the
window's, `num_repeats` draws of [rows, latent] a batch, pass after pass.
It runs once the window has closed and the program's state is freed, one
batch at a time.

The numbers, over the profiles of every checked batch and repeat:

* `gen_rel_gap`: sum |run - reference| / sum |reference|;
* `gen_profile_gap`: the same ratio for each profile alone, the worst
  profile: one profile made wrong (a z row swapped, an answer altered)
  moves the pooled gap by a few hundredths of its own.

A number that is not finite, or profiles of the wrong shape, read inf.

`FAULTS` plants a fault in the reference put in the program's place, for
the limits' calibration (`calibrate_generate.py`) and the tests: FiLM's
beta zeroed (its half of the projection's rows), the text
cross-attention skipped (its output projection zeroed, so the condition
vector is the patch side alone), the token mask or the patch mask ignored
(every slot valid), z's first two rows of each batch swapped, and the
training-mode dropout left on. The control computes the reference in the
precision below the configuration's (`check.CONTROL`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.check import _allow_tf32
from perfbench.reference import model
from perfbench.reference.numerics import Dropout, Precision
from perfbench.traffic import DTYPES

NUMBERS = ("gen_rel_gap", "gen_profile_gap")
FAULTS = ("film_beta_zero", "no_text_xattn", "token_mask_ignored", "patch_mask_ignored",
          "z_rows_swapped", "dropout_on")
DROPOUT_SEED = 0  # the default generator's seed for the dropout fault's masks


def window_z(inputs: dict, picks: list, cases: int, device) -> Dict[tuple, torch.Tensor]:
    """{pick: z [R, rows, latent]} of each checked (pass, batch), drawn
    again as the window drew them."""
    B, R, n_batches = inputs["rows"], inputs["repeats"], inputs["batches_per_pass"]
    latent = inputs["latent_dim"]
    g = torch.Generator(device=device).manual_seed(inputs["z_seed"])
    want, out = set(picks), {}
    last = max(p * n_batches + b for p, b in picks)
    for i in range(last + 1):
        p, b = divmod(i, n_batches)
        rows = min(B, cases - b * B)
        z = [torch.randn(rows, latent, generator=g, device=device) for _ in range(R)]
        if (p, b) in want:
            out[(p, b)] = torch.stack(z)
    return out


def _planted(cfg: dict, weights: dict, cond: dict, z: torch.Tensor, fault: Optional[str]):
    """(weights, cond, z, dropout rate) with `fault` planted."""
    params, cond, z, rate = dict(weights), dict(cond), z, 0.0
    f = cfg["fusion"]
    if fault is None:
        pass
    elif fault == "film_beta_zero":
        P = f["patch_dim"]
        for k in ("fusion.film.film_proj.weight", "fusion.film.film_proj.bias"):
            params[k] = params[k].clone()
            params[k][P:] = 0
    elif fault == "no_text_xattn":
        for k in ("weight", "bias"):
            name = f"fusion.text2patch_attention.out_proj.{k}"
            params[name] = torch.zeros_like(params[name])
    elif fault in ("token_mask_ignored", "patch_mask_ignored"):
        key = fault.split("_mask")[0] + "_mask"
        cond[key] = torch.ones_like(cond[key])
    elif fault == "z_rows_swapped":
        z = z.clone()
        z[:, [0, 1]] = z[:, [1, 0]]
    elif fault == "dropout_on":
        rate = f["dropout"]
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    return params, cond, z, rate


def reference_profiles(cfg: dict, inputs: dict, picks: list, cases: int, device,
                       precision: Optional[str] = None, fault: Optional[str] = None
                       ) -> Dict[tuple, np.ndarray]:
    """{pick: profiles [R, rows, n_genes]} of the reference, one batch at a
    time; `precision` rounds every product's operands (the control),
    `fault` is one of `FAULTS`."""
    _allow_tf32(False)
    dtype = DTYPES[cfg["model"]["compute_dtype"]]
    zs = window_z(inputs, picks, cases, device)
    torch.manual_seed(DROPOUT_SEED)
    out = {}
    with torch.no_grad():
        for pick in picks:
            cond = {k: v.float() if v.is_floating_point() else v
                    for k, v in inputs["conds"][pick[1]].items()}
            params, cond, z, rate = _planted(cfg, inputs["weights"], cond, zs[pick], fault)
            net = model(cfg["architecture"]).Net(cfg, params, Dropout(rate, dtype),
                                                 Precision(precision), dtype)
            cvec = net.embed(cond)
            out[pick] = torch.stack([net.score(zr, cvec) for zr in z]).float().cpu().numpy()
    return out


def numbers(run: Dict[tuple, np.ndarray], ref: Dict[tuple, np.ndarray]) -> Dict[str, float]:
    """The module's numbers of `run`'s profiles against `ref`'s."""
    if set(run) != set(ref) or any(run[k].shape != ref[k].shape for k in ref):
        return {k: math.inf for k in NUMBERS}
    n_genes = next(iter(ref.values())).shape[-1]
    a = np.concatenate([run[k].reshape(-1, n_genes) for k in sorted(ref)]).astype(np.float64)
    b = np.concatenate([ref[k].reshape(-1, n_genes) for k in sorted(ref)]).astype(np.float64)
    diff, mag = np.abs(a - b).sum(axis=1), np.abs(b).sum(axis=1)
    out = {"gen_rel_gap": float(diff.sum() / max(mag.sum(), 1e-300)),
           "gen_profile_gap": float(np.max(diff / np.maximum(mag, 1e-300)))}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def compared(limits: dict) -> List[str]:
    """The numbers a cell compares: those with a limit."""
    return [k for k in NUMBERS if limits.get(k, {}).get("limit") is not None]


def verdict(values: Dict[str, float], limits: dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]["limit"]
               for k in compared(limits))
