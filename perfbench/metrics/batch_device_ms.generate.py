"""batch_device_ms.generate (ms): the device time of the traced pass's
records (kernels, copies, sets) per batch."""


def read(ctx):
    return 1e3 * sum(s for s, _ in ctx.trace.by_name.values()) / ctx.trace_batches
