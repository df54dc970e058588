"""Bound of `flash_bwd_dq_kernel<D, kMode>`: the port's mma.sync dq of the blocked classic backward (Q4)
(`gemm_gan_tpu_torch/kernels/csrc/`)."""

from perfbench.kernels import _attention

LAUNCH = "bwd"  # the attention call that launches it (a site's `launches`)


def bound_s(site: dict, targs: list, peaks: dict) -> float:
    """Least seconds of one launch at `site`, given the trace name's
    template arguments `targs` (D, kMode)."""
    D, mode = int(targs[0]), int(targs[1])
    if D != site["D"]:
        raise ValueError(f"flash_bwd_dq_kernel at head dim {D}, the site's is {site['D']}")
    return _attention.bound_s("dq", mode, site, peaks)
