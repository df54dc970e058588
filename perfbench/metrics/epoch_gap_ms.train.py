"""epoch_gap_ms.train (ms): the device's idle time between one epoch and
the next, per epoch boundary in the trace. A boundary is the benchmark's
`perfbench.on_epoch_end` span (the callback of `WGANGPEngine.fit`) that a
later epoch follows; the gap runs from the end of the last device record
that started before the span to the first device record launched by the
next epoch's first CUDA graph replay (`cudaGraphLaunch`), and counts only
the idle time inside it (the next epoch's index and score copies are
work)."""

SPAN = "perfbench.on_epoch_end"


def read(ctx):
    tr = ctx.trace
    launches = [s for n, s, _ in tr.host if n.startswith("cudaGraphLaunch")]
    gaps = []
    for _, s0, s1 in (h for h in tr.host if h[0] == SPAN):
        before = [b for _, a, b in tr.everything if a < s0]
        launch = next((t for t in launches if t > s1), None)
        if not before or launch is None:
            continue
        first = next((a for _, a, _ in tr.everything if a >= launch), None)
        if first is not None:
            gaps.append(tr.idle_ns(max(before), first) / 1e6)
    return sum(gaps) / len(gaps) if gaps else None
