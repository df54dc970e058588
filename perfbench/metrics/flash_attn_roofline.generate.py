"""flash_attn_roofline.generate (%): the port's flash kernels' least time
over their device time in the traced pass. Each launch's least time is its
bound from `kernels/<name>.py` at a kernel site of the batch
(`generate_kernel_sites` of `flops/<architecture>_generate.py`); where
several sites launch the same kernel, its launches are shared among them as
the sites' `launches` a batch are. Sampling launches forwards only: a
kernel of another kind has no site, and the reader raises."""

from perfbench.metrics._flash import own_records


def read(ctx):
    own = own_records(ctx)
    if not own or not ctx.sites:
        return None
    bound = 0.0
    for k, targs, _, n in own:
        kind = ctx.kernels[k].LAUNCH
        total = sum(site["launches"][kind] for site in ctx.sites)
        if not total:
            raise ValueError(f"{k} ({kind}) ran in the traced pass, and no site of the "
                             f"batch launches a {kind}")
        bound += sum(n * site["launches"][kind] / total
                     * ctx.kernels[k].bound_s(site, targs, ctx.peaks) for site in ctx.sites)
    return 100.0 * bound / sum(s for _, _, s, _ in own)
