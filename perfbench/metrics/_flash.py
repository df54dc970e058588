"""The port's own kernels in a trace: records whose name holds a kernel
of `kernels/` (the function's name, before its template arguments)."""

import re

from perfbench.kernels._attention import template_args


def kernel_of(trace_name: str, kernels: dict):
    """The name under `kernels/` of a trace record, or None."""
    m = re.search(r"(\w+_kernel)\b", trace_name)
    return m.group(1) if m and m.group(1) in kernels else None


def own_records(ctx):
    """[(kernel name, template args, seconds, launches)] of the port's
    kernels in the trace."""
    out = []
    for name, (seconds, count) in ctx.trace.by_name.items():
        k = kernel_of(name, ctx.kernels)
        if k is not None:
            out.append((k, template_args(name), seconds, count))
    return out
