"""flash_attn_device_share.train (%): the port's flash kernels' device time
over all device time in the traced epoch."""

from perfbench.metrics._flash import own_records


def read(ctx):
    own = own_records(ctx)
    if not own:
        return None
    return 100.0 * sum(s for _, _, s, _ in own) / sum(s for s, _ in ctx.trace.by_name.values())
