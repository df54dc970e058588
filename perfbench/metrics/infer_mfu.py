"""infer_mfu (%): the whole batch's share of the configuration's peak in an
inference cell: the analytic FLOPs of the window's batches
(`generate_batch_flops` of the architecture's `flops/<architecture>_generate.py`)
over the window's seconds on the host's clock (the run's untraced window, as
`infer_samples_per_s` takes it)."""


def read(ctx):
    return 100.0 * ctx.batch_flops * ctx.window_batches / ctx.window_s / ctx.peak_flops
