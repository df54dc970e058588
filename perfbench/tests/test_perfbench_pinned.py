"""What the training cells read, pinned: the bank `traffic.make_bank`
makes from a seed, a step's FLOPs and the flash kernels' sites. A generate
cell shares these files; its additions must leave the training cells'
numbers as they were."""

import pytest

from perfbench import spec, traffic
from perfbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 99
TRAIN = ("film_xattn_bf16.train_cohort", "film_xattn_f32.train_cohort",
         "film_xattn_bf16.train_wholeslide")
COHORT_SITE = {"name": "patch_self_attention", "B": 8, "H": 4, "Lq": 257, "Lk": 257, "D": 64,
               "valid_keys": 2056.0, "launches": {"fwd": 16, "bwd": 12}}
PINNED = {  # workload: (step FLOPs, kernel sites, steps an epoch)
    "film_xattn_bf16.train_cohort": (174401212416, [COHORT_SITE], 800),
    "film_xattn_f32.train_cohort": (174401212416, [COHORT_SITE], 800),
    "film_xattn_bf16.train_wholeslide": (
        7425304252416, [dict(COHORT_SITE, Lq=4097, Lk=4097, valid_keys=32776.0)], 200),
}
BANKS = [  # (workload, tiny traffic changes, the sum of each array of the bank)
    ("film_xattn_bf16.train_cohort", {},
     {"genes": -5.706919860676862, "patches": 0.38627517223358154, "patch_mask": 366.0,
      "tokens": 80.5711857676506, "token_mask": 261.0}),
    ("film_xattn_bf16.train_wholeslide",
     dict(cases=16, patch_slots=40, min_valid_patches=32, num_patches=32),
     {"genes": 11.66347377281636, "patches": -68.44734847545624, "patch_mask": 589.0,
      "tokens": 75.66770935058594, "token_mask": 108.0}),
]


@pytest.mark.parametrize("workload", TRAIN)
def test_a_training_cells_flops_sites_and_epoch(workload):
    cell = spec.load_cell(workload)
    flops = spec.architecture_flops(cell.config["architecture"])
    step, sites, steps = PINNED[workload]
    assert flops.train_step_flops(cell.config, cell.traffic) == step
    assert flops.kernel_sites(cell.config, cell.traffic) == sites
    assert traffic.steps_per_epoch(cell.config, cell.traffic) == steps


@pytest.mark.parametrize("workload, changes, sums", BANKS, ids=[b[0] for b in BANKS])
def test_the_bank_of_a_seed(workload, changes, sums):
    cell = tiny_cell(workload)
    cell.traffic.update(changes)
    bank = traffic.make_bank(cell.config, cell.traffic, SEED, "cpu")
    assert {k: float(v.double().sum()) for k, v in bank.items()} == pytest.approx(sums, rel=1e-12)
