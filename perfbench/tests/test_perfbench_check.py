"""The check against the plain reference, at tiny widths on the CPU: a
sound run of the port is correct; each fault a training cell can have,
planted in the port under the harness, makes it incorrect; the control
(the reference one precision down, put in the program's place) and the
reference's planted faults fail the cell's numbers."""

import copy

import pytest
import torch

from perfbench import calibrate, check
from perfbench.run import forbidden_modules, run_cell
from perfbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 12345  # more than 32 signed bits, as the driver's seeds are


def state_unchanged(engine):
    """The step computes its metrics and leaves params and moments as they
    were."""
    step = engine._fused_step

    def fused(state, real, cond, draws=None):
        tensors = [*state.gen.parameters(), *state.critic.parameters(),
                   *state.g_ema.parameters(), *state.g_opt.nu, *state.d_opt.nu,
                   state.g_opt.count_t, state.d_opt.count_t]
        saved = [t.detach().clone() for t in tensors]
        metrics = step(state, real, cond, draws)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return metrics

    engine._fused_step = fused


def half_batch(engine):
    """The step takes the first half of the batch; its means are over that."""
    step = engine._fused_step

    def fused(state, real, cond, draws=None):
        h = real.shape[0] // 2
        return step(state, real[:h], {k: v[:h] for k, v in cond.items()}, draws)

    engine._fused_step = fused


def critic_frozen(engine):
    """Each critic update computes its loss and leaves the critic and its
    moments as they were; the generator's update is sound."""
    update = engine.critic_update

    def critic_update(state, *args, **kw):
        tensors = [*state.critic.parameters(), *state.d_opt.nu]
        saved = [t.detach().clone() for t in tensors]
        out = update(state, *args, **kw)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return out

    engine.critic_update = critic_update


def critic_half_batch(engine):
    """The critic's updates take the first half of the batch; the
    generator's the whole."""
    update = engine.critic_update

    def critic_update(state, real, cond, g_cvec, z, alpha, noise=None, fake=None):
        h = real.shape[0] // 2
        return update(state, real[:h], {k: v[:h] for k, v in cond.items()}, g_cvec[:h],
                      z[:h], alpha[:h], noise, fake)

    engine.critic_update = critic_update


def no_gradient_penalty(engine):
    """The critic descends its loss without the gradient penalty."""
    scores = engine._critic_scores

    def critic_scores(*args, **kw):
        d_real, d_fake, gp = scores(*args, **kw)
        return d_real, d_fake, gp * 0.0

    engine._critic_scores = critic_scores


def generator_move(factor):
    """The generator's update moves its parameters `factor` times as far
    as it should (2: the rate doubled; -1: the wrong sign; 0: the write
    left out)."""
    def fault(engine):
        update = engine.generator_update

        def generator_update(state, *args, **kw):
            before = [p.detach().clone() for p in state.gen.parameters()]
            out = update(state, *args, **kw)
            with torch.no_grad():
                for p, b in zip(state.gen.parameters(), before):
                    p.copy_(b + factor * (p - b))
            return out

        engine.generator_update = generator_update

    fault.__name__ = f"generator_move_{factor}"
    return fault


def ema_unchanged(engine):
    """The EMA generator never moves."""
    engine._update_ema = lambda state: None


def test_a_sound_run_is_correct():
    cell = tiny_cell()
    result = run_cell(cell, SEED, 1.0, False, "cpu")
    assert result["correct"] is True
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(check.compared(cell.limits)) > {
        "gen_move_gap", "critic_move_gap", "ema_gap"}
    # the EMA's identity reads f32 rounding of its move, a thousandth of a
    # weight's scale; the others read the two sides' rounding apart
    assert all(c["value"] < (2e-2 if k == "ema_gap" else 1e-3)
               for k, c in result["check"].items())
    assert result["attempted"] % 5 == 0 and result["attempted"] >= 5 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert forbidden_modules() == []


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, critic_frozen,
                                   critic_half_batch, no_gradient_penalty, generator_move(2),
                                   generator_move(-1), generator_move(0), ema_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["film_xattn_f32.train_cohort",
                                      "film_xattn_bf16.train_cohort"])
def test_a_fault_under_the_harness_is_incorrect(fault, workload):
    result = run_cell(tiny_cell(workload), SEED, 1.0, False, "cpu", wrap=fault)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ["film_xattn_f32.train_cohort",
                                      "film_xattn_bf16.train_cohort",
                                      "film_xattn_bf16.train_wholeslide"])
def test_the_control_and_the_reference_faults_are_incorrect(workload):
    cell = tiny_cell(workload)
    out = calibrate.readings(cell, 7, "cpu")
    for side in ("control", "half_batch", "critic_half_batch", "no_gp"):
        assert not check.verdict(out[side], cell.limits), side
    if cell.config["model"]["compute_dtype"] == "float32":
        assert check.verdict(out["program"], cell.limits)


def test_unmoved_and_reversed_moves_read_1_and_2():
    before = {"w": torch.tensor([1.0, 2.0, 3.0])}
    ref = {"w": torch.tensor([1.5, 1.0, 3.0])}
    stage = [{"gen": {"after": ref, "nu": {"w": torch.tensor([4.0, 1.0, 0.0])}}}]
    for after, want in ((before, 1.0), ({"w": 2 * before["w"] - ref["w"]}, 2.0),
                        (ref, 0.0)):
        gaps = check.move_gaps([{"gen": before}, {"gen": after}], stage, "gen")
        assert gaps == [{"w": pytest.approx(want)}]


def test_an_ema_left_unmoved_reads_1():
    e0, g1 = {"w": torch.tensor([1.0, 2.0])}, {"w": torch.tensor([3.0, -1.0])}
    unmoved = [{"ema": e0, "gen": e0}, {"ema": e0, "gen": g1}]
    assert check.ema_gaps(unmoved, 0.9) == [{"w": pytest.approx(1.0)}]
    moved = {"w": 0.9 * e0["w"] + 0.1 * g1["w"]}
    assert check.ema_gaps([unmoved[0], {"ema": moved, "gen": g1}], 0.9)[0]["w"] < 1e-6


def test_numbers_take_the_median_step_of_gen_elem_gap_alone():
    steps = [{"a": 0.1, "b": 0.3}, {"a": 0.2}, {"a": 5.0}]
    got = check.numbers({"gen_elem_gap": steps, "ema_gap": steps})
    assert got == {"gen_elem_gap": 0.3, "ema_gap": 5.0}


def test_the_reference_imports_nothing_of_the_program():
    import perfbench.reference.film_cross_attention as flagship
    import perfbench.reference.numerics as numerics
    import perfbench.reference.wgan_step as wgan_step

    for module in (flagship, numerics, wgan_step):
        src = open(module.__file__).read()
        assert "gemm_gan_tpu" not in src.replace("-GeMM-GAN", "")
    cfg = copy.deepcopy(tiny_cell().config)
    assert flagship.param_shapes(cfg, "gen")[0][0] == "fusion.film.film_proj.weight"
