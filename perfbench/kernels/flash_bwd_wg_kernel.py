"""Bound of `flash_bwd_wg_kernel<D, kBle, kMode>`: the port's wgmma fused backward of the bf16-ref modes (Q2, Q6)
(`gemm_gan_tpu_torch/kernels/csrc/`)."""

from perfbench.kernels import _attention

LAUNCH = "bwd"  # the attention call that launches it (a site's `launches`)


def bound_s(site: dict, targs: list, peaks: dict) -> float:
    """Least seconds of one launch at `site`, given the trace name's
    template arguments `targs` (D, kBle, kMode)."""
    D, ble, mode = int(targs[0]), targs[1] == "true", int(targs[2])
    if D != site["D"]:
        raise ValueError(f"flash_bwd_wg_kernel at head dim {D}, the site's is {site['D']}")
    return _attention.bound_s("bwd_fused", mode, site, peaks, ble)
