"""d2h_ms.generate (ms): the device's copies to the host in the traced pass
(the profiler's `Memcpy DtoH` records: each batch's profiles fetched as
numpy), their device time per batch."""


def read(ctx):
    copies = [s for name, (s, _) in ctx.trace.by_name.items() if "DtoH" in name]
    return 1e3 * sum(copies) / ctx.trace_batches if copies else None
