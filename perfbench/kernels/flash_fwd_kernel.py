"""Bound of `flash_fwd_kernel<D, kBle, kMode>`: the port's 3xTF32 mma.sync forward (Q1 in the [B, L, E] layout, Q3 in [B, H, L, D]), and its mxu_bf16 mode on f32 refs
(`gemm_gan_tpu_torch/kernels/csrc/`)."""

from perfbench.kernels import _attention

LAUNCH = "fwd"  # the attention call that launches it (a site's `launches`)


def bound_s(site: dict, targs: list, peaks: dict) -> float:
    """Least seconds of one launch at `site`, given the trace name's
    template arguments `targs` (D, kBle, kMode)."""
    D, ble, mode = int(targs[0]), targs[1] == "true", int(targs[2])
    if D != site["D"]:
        raise ValueError(f"flash_fwd_kernel at head dim {D}, the site's is {site['D']}")
    return _attention.bound_s("fwd", mode, site, peaks, ble)
