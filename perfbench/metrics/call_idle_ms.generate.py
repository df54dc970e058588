"""call_idle_ms.generate (ms): the device's idle time in the traced call,
from its first device record after the first batch is handed over to its
last: what the host holds the device back by in one call of the sampling
entry (the graph's capture at the call's first batch, the loop between
replays)."""


def read(ctx):
    return 1e3 * (ctx.trace.window_s - ctx.trace.busy_s)
