"""step_device_events.train (events): the device records of the traced
epoch per training step (a count of launches, copies and sets)."""


def read(ctx):
    return sum(n for _, n in ctx.trace.by_name.values()) / ctx.trace_steps
