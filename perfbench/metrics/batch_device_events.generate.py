"""batch_device_events.generate (events): the device records of the traced
pass per batch (a count of launches, copies and sets)."""


def read(ctx):
    return sum(n for _, n in ctx.trace.by_name.values()) / ctx.trace_batches
