"""flash_attn_roofline.train (%): the port's flash kernels' least time over
their device time in the traced epoch. Each launch's least time is its
bound from `kernels/<name>.py` at a kernel site of the step
(`flops/<architecture>.py`'s `kernel_sites`); where several sites launch
the same kernel, its launches are shared among them as the sites'
`launches` a step of that kind (forward or backward) are."""

from perfbench.metrics._flash import own_records


def read(ctx):
    own = own_records(ctx)
    if not own or not ctx.sites:
        return None
    bound = 0.0
    for k, targs, _, n in own:
        kind = ctx.kernels[k].LAUNCH
        total = sum(site["launches"][kind] for site in ctx.sites)
        bound += sum(n * site["launches"][kind] / total
                     * ctx.kernels[k].bound_s(site, targs, ctx.peaks) for site in ctx.sites)
    return 100.0 * bound / sum(s for _, _, s, _ in own)
