"""step_device_ms.train (ms): the device time of the traced epoch's records
(kernels, copies, sets) per training step."""


def read(ctx):
    return 1e3 * sum(s for s, _ in ctx.trace.by_name.values()) / ctx.trace_steps
