"""Whether a training run computed what it should: the plain reference
follows the run's first three steps, and five numbers compare the two.

The reference (`reference/`, plain PyTorch in the configuration's compute
dtype, float32 with TF32 off or bfloat16 as Flax's Dense computes) gets
what the benchmark handed the program: the weights, the three batches'
bank rows and the seeds. It works out again what the program derived from
them: each step's batch order and patch subsampling (the `DeviceCache`
rule), z and alpha (the engine's generator, seeded as the program's), and
the dropout masks (the default generator, seeded as before the program's
first step). It runs once the window has closed and the program's state is
freed.

A run's state is kept at the four boundaries of its three steps (a
`snapshot`: generator, critic, EMA generator and both optimizers' second
moments). From the run's own state at a step's start, the reference
computes the step's critic updates (a critic stage); from the run's
generator at the start and its critic at the end, the step's generator
update (a generator stage). RMSprop's first move is +-10 lr for every
entry whose gradient is not nought, whatever its size, so two
computations that round differently part after it; a stage starts each
step from the run's own state and so follows it only as far as the step.

The numbers:

* `loss1_gap`: over the first step's metrics (d_loss, gp, d_real, d_fake
  of its last critic update, and g_loss), |run - reference| over the
  larger of |reference| and the median |reference| of the five;
* `gen_elem_gap`: the generator's gradient magnitudes entry by entry, the
  run's from its optimizer's second moments (nu_t - decay nu_(t-1)), the
  reference's from its generator stage; per parameter the norm of the
  difference over the larger of the reference's norm and the median
  parameter's; each step's worst parameter, the median of the steps (one
  step's worst swings with the trunks' ReLUs);
* `gen_move_gap`, `critic_move_gap`: each net's move over a step, the
  run's against its stage's, per parameter sum w |run - stage| / sum w
  |stage|, each entry weighted by w = sqrt(nu) of the stage's optimizer
  after it (an entry whose gradient is rounding moves by a rounding sign,
  with a weight near nought); the worst parameter of the worst step. A
  parameter whose sqrt(sum nu) is under a thousandth of the median
  parameter's is left out (`SMALL_GRAD`: a key projection's bias, whose
  gradient under softmax is rounding alone). A net left unmoved reads 1,
  a move of the wrong sign 2;
* `critic_net_move_gap`: the critic's move gap pooled over its parameters
  (the same sums, each over every parameter that is not left out), the
  worst step: the critic as a whole, which a few small parameters whose
  gradients bf16 rounds away do not swing;
* `ema_gap`: the EMA generator from the run's own state, e_t = d e_(t-1)
  + (1 - d) g_t (g_t the run's generator after step t): per parameter the
  norm of the run's e_t less that over the larger of the norm of the EMA's
  move and the median parameter's; the worst parameter of the worst
  step. An EMA left unmoved reads 1.

A cell compares the numbers whose program readings its control's and
faults' readings clear (`limits/<workload>.json`: a number with a `limit`
of null is reported and not compared); `PERF.md` gives why.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference.wgan_step import (WGANGPReference, assemble, epoch_order,
                                           epoch_scores, step_draws)
from perfbench.train_cell import (CHECK_STEPS, SEED_CHECK_CACHE, SEED_DRAWS, SEED_DROPOUT,
                                  RMSPROP_DECAY)

NUMBERS = ("loss1_gap", "gen_elem_gap", "gen_move_gap", "critic_move_gap", "critic_net_move_gap",
           "ema_gap")
# the control's precision, the step below the configuration's compute
# dtype: TF32 products (operands rounded, f32 accumulation and results) for
# f32; fp8 products (e4m3 operands, one scale per tensor) for bf16
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
SMALL_GRAD = 1e-3  # of the median parameter's sqrt(sum nu): left out of the move gaps
CONDITIONING = ("tokens", "token_mask", "patches", "patch_mask")


def _allow_tf32(flag: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flag
    torch.backends.cudnn.allow_tf32 = flag


class Feed:
    """Step t's batch and draws, worked out again as the program's
    `DeviceCache` and engine made them; `seek_dropout(embeds)` sets the
    default generator where the program's step had drawn the masks of
    `embeds` embeddings."""

    def __init__(self, cfg: dict, traffic: dict, check_rows: List[dict], seeds: dict, device):
        self.cfg, self.traffic, self.rows, self.seeds = cfg, traffic, check_rows, seeds
        self.device = device
        self.B = cfg["train"]["batch_size"]
        self.n_critic = cfg["train"]["n_critic"]

    def batch(self, t: int) -> Dict[str, torch.Tensor]:
        s = self.seeds[SEED_CHECK_CACHE]
        order = torch.as_tensor(epoch_order(s, t, self.B), device=self.device)
        scores = epoch_scores(s, t, 1, self.B, self.traffic["patch_slots"], self.device)[0]
        return assemble(self.rows[t], order, scores, self.traffic["num_patches"])

    def draws(self, t: int) -> Dict[str, torch.Tensor]:
        rng = torch.Generator(device=self.device).manual_seed(self.seeds[SEED_DRAWS])
        for _ in range(t + 1):
            d = step_draws(rng, self.n_critic, self.B, self.cfg["model"]["latent_dim"],
                           self.device)
        return d

    def embeds_before(self, t: int) -> int:
        """The embeddings of the steps before step t: the generator's, each
        critic update's, and the generator update's two."""
        return t * (self.n_critic + 3)

    def seek_dropout(self, net, embeds: int) -> None:
        torch.manual_seed(self.seeds[SEED_DROPOUT])
        for _ in range(embeds):
            net.skip_embed(self.B, self.traffic["num_patches"], self.device)


def reference_readings(cfg: dict, traffic: dict, weights: dict, check_rows: List[dict],
                       seeds: dict, steps_per_epoch: int, dtype: torch.dtype, device,
                       precision: Optional[str] = None, fault: Optional[str] = None,
                       steps: int = CHECK_STEPS) -> dict:
    """The reference's own run of the check's first `steps` steps from the
    benchmark's weights: {"losses": per step, "snapshots": at each
    boundary}, in the form `TrainCell` gives the program's. `precision`
    rounds every product's operands (the control); `fault` is one of
    `wgan_step.FAULTS`."""
    _allow_tf32(False)
    feed = Feed(cfg, traffic, check_rows, seeds, device)
    ref = WGANGPReference(cfg, weights["gen"], weights["critic"], steps_per_epoch, dtype,
                          precision, None if fault == "half_batch" else fault)
    rng = torch.Generator(device=device).manual_seed(seeds[SEED_DRAWS])
    torch.manual_seed(seeds[SEED_DROPOUT])
    losses, snapshots = [], [ref.snapshot()]
    for t in range(steps):
        batch = feed.batch(t)
        draws = step_draws(rng, cfg["train"]["n_critic"], feed.B, cfg["model"]["latent_dim"],
                           device)
        if fault == "half_batch":
            h = feed.B // 2
            batch = {k: v[:h] for k, v in batch.items()}
            draws = {"z": draws["z"][:, :h], "alpha": draws["alpha"][:, :h],
                     "z_gen": draws["z_gen"][:h]}
        metrics = ref.step(batch, draws)
        losses.append({k: float(v) for k, v in metrics.items()})
        snapshots.append(ref.snapshot())
    return {"losses": losses, "snapshots": snapshots}


def stages(cfg: dict, traffic: dict, snapshots: List[dict], check_rows: List[dict],
           seeds: dict, steps_per_epoch: int, dtype: torch.dtype, device,
           precision: Optional[str] = None) -> List[dict]:
    """Per step of a run whose state at the boundaries is `snapshots`, the
    reference's critic stage and generator stage from that state (the
    module's docstring): {"critic": {"after", "nu"}, "gen": {"after", "nu",
    "grads"}}, each net's parameters after the stage, its optimizer's
    second moments and (the generator's) the gradients it took."""
    _allow_tf32(False)
    feed = Feed(cfg, traffic, check_rows, seeds, device)
    n, out = cfg["train"]["n_critic"], []

    def on_device(snapshot):
        return {part: {k: v.to(device) for k, v in params.items()}
                for part, params in snapshot.items()}

    for t in range(len(snapshots) - 1):
        s0, s1 = on_device(snapshots[t]), on_device(snapshots[t + 1])
        batch, draws = feed.batch(t), feed.draws(t)
        cond = {k: batch[k] for k in CONDITIONING}
        ref = WGANGPReference(cfg, s0["gen"], s0["critic"], steps_per_epoch, dtype, precision,
                              g_nu=s0["g_nu"], d_nu=s0["d_nu"])
        feed.seek_dropout(ref.G, feed.embeds_before(t))
        ref.critic_updates(batch, draws)
        critic = {"after": ref.critic, "nu": ref.d_opt.nu}
        ref = WGANGPReference(cfg, s0["gen"], s1["critic"], steps_per_epoch, dtype, precision,
                              g_nu=s0["g_nu"], d_nu=s1["d_nu"])
        feed.seek_dropout(ref.G, feed.embeds_before(t) + 1 + n)
        ref.generator_update(cond, draws["z_gen"])
        gen = {"after": ref.gen, "nu": ref.g_opt.nu, "grads": ref.g_opt.grads}
        out.append({"critic": critic, "gen": gen})
    return out


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float64)


def _median(values) -> float:
    return float(np.median(list(values)))


def elem_gaps(snapshots: List[dict], stage: List[dict]) -> List[Dict[str, float]]:
    """Per step, {parameter: `gen_elem_gap`'s gap}."""
    out = []
    for t, st in enumerate(stage):
        nu0, nu1 = snapshots[t]["g_nu"], snapshots[t + 1]["g_nu"]
        ref = {k: _f64(g).abs() for k, g in st["gen"]["grads"].items()}
        norms = {k: float(v.norm()) for k, v in ref.items()}
        floor = _median(norms.values())
        gaps = {}
        for k, r in ref.items():
            g2 = _f64(nu1[k]) - RMSPROP_DECAY * _f64(nu0[k])
            mag = torch.sqrt(g2.clamp_min(0.0) / (1 - RMSPROP_DECAY))
            gaps[k] = float((mag - r).norm()) / max(norms[k], floor, 1e-30)
        out.append(gaps)
    return out


def move_gaps(snapshots: List[dict], stage: List[dict], net: str, pooled: bool = False
              ) -> List[Dict[str, float]]:
    """Per step, {parameter: the move gap of `net` ("gen" or "critic")};
    `pooled`: {net: the gap over all its parameters}."""
    out = []
    for t, st in enumerate(stage):
        before, after = snapshots[t][net], snapshots[t + 1][net]
        weights = {k: torch.sqrt(_f64(v)) for k, v in st[net]["nu"].items()}
        scale = {k: float(w.norm()) for k, w in weights.items()}
        small = SMALL_GRAD * _median(scale.values())
        sums = {}
        for k, w in weights.items():
            if scale[k] < small:
                continue
            b = _f64(before[k])
            run, ref = _f64(after[k]) - b, _f64(st[net]["after"][k]) - b
            sums[k] = (float((w * (run - ref).abs()).sum()), float((w * ref.abs()).sum()))
        if pooled:
            sums = {net: tuple(sum(v[i] for v in sums.values()) for i in (0, 1))}
        out.append({k: d / max(n, 1e-300) for k, (d, n) in sums.items()})
    return out


def ema_gaps(snapshots: List[dict], decay: float) -> List[Dict[str, float]]:
    """Per step, {parameter: `ema_gap`'s gap} from the run's own state."""
    out = []
    for s0, s1 in zip(snapshots[:-1], snapshots[1:]):
        e0 = {k: _f64(v) for k, v in s0["ema"].items()}
        want = {k: decay * e0[k] + (1 - decay) * _f64(s1["gen"][k]) for k in e0}
        moves = {k: float((want[k] - e0[k]).norm()) for k in e0}
        floor = _median(moves.values())
        out.append({k: float((_f64(s1["ema"][k]) - want[k]).norm()) / max(moves[k], floor, 1e-30)
                    for k in e0})
    return out


def loss_gaps(got: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    """{metric: |got - want| over the larger of |want| and the median
    |want|} (inf where `got` is not finite)."""
    floor = _median(abs(v) for v in want.values())
    return {k: (abs(got[k] - want[k]) / max(abs(want[k]), floor, 1e-30)
                if math.isfinite(got[k]) else math.inf) for k in want}


def gaps(side: dict, reference: dict, stage: List[dict], ema_decay: float
         ) -> Dict[str, List[Dict[str, float]]]:
    """Every compared quantity's gap, by number, per step (`loss1_gap` one
    step); `side` is a run's readings, `stage` its `stages`."""
    snaps = side["snapshots"]
    return {"loss1_gap": [loss_gaps(side["losses"][0], reference["losses"][0])],
            "gen_elem_gap": elem_gaps(snaps, stage),
            "gen_move_gap": move_gaps(snaps, stage, "gen"),
            "critic_move_gap": move_gaps(snaps, stage, "critic"),
            "critic_net_move_gap": move_gaps(snaps, stage, "critic", pooled=True),
            "ema_gap": ema_gaps(snaps, ema_decay)}


def worst(per_step: List[Dict[str, float]]) -> List[float]:
    """Each step's worst gap (inf where one is not a number)."""
    return [max((v if math.isfinite(v) else math.inf) for v in g.values()) for g in per_step]


def numbers(g: Dict[str, List[Dict[str, float]]]) -> Dict[str, float]:
    """The module's numbers from `gaps`: `gen_elem_gap` the median of its
    steps' worst, every other the worst of all."""
    out = {k: max(worst(v)) for k, v in g.items()}
    out["gen_elem_gap"] = float(np.median(worst(g["gen_elem_gap"])))
    return out


def compare(side: dict, reference: dict, stage: List[dict], ema_decay: float
            ) -> Dict[str, float]:
    return numbers(gaps(side, reference, stage, ema_decay))


def compared(limits: dict) -> List[str]:
    """The numbers a cell compares: those with a limit."""
    return [k for k in NUMBERS if limits.get(k, {}).get("limit") is not None]


def verdict(values: Dict[str, float], limits: dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]["limit"]
               for k in compared(limits))
