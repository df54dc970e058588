"""train_mfu (%): the whole step's share of the configuration's peak: the
analytic FLOPs of the window's steps (`train_step_flops` of the
architecture's `flops/` module) over the window's seconds on the host's
clock (the run's untraced window, as `train_steps_per_s` takes it)."""


def read(ctx):
    return 100.0 * ctx.step_flops * ctx.window_steps / ctx.window_s / ctx.peak_flops
