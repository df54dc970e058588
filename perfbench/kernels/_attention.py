"""The arithmetic shared by the flash kernels' bound files, as `PERF.md`
section 6 and `chip_smoke.py` phase 2 take it.

A launch at site (B, H, Lq, Lk, D, valid keys summed over the batch) needs
`flop_units` x H x Lq x D x valid FLOP (a forward 4: q.k and p.v; a fused
backward 10, dq 6, dk/dv 8) and moves each input once and each output
once. The f32 mode takes its products in 3xTF32 (the peak `tf32x3_flops`);
a bf16 mode runs `passes` bf16 products per product (the bf16 mode splits
P and dS into three bf16 terms; mxu_bf16 one pass each, its forward S
twice) at `bf16_flops`. The bound is the larger of the operations' time
and the bytes' time at `hbm_bytes_per_s`.
"""

import re

# csrc/flash_ops.cuh's Mode: f32, bf16, mxu_bf16 on f32 refs, on bf16 refs
F32, BF16, MXU_F32, MXU_BF16 = 0, 1, 2, 3
# bf16 passes per product: (bf16 mode, mxu mode) per kind of launch
PASSES = {"fwd": (4 / 2, 3 / 2), "bwd_fused": (11 / 5, 1.0), "dq": (5 / 3, 1.0),
          "dkv": (8 / 4, 1.0)}
FLOP_UNITS = {"fwd": 4, "bwd_fused": 10, "dq": 6, "dkv": 8}


def template_args(trace_name: str) -> list:
    """The template arguments of a kernel's trace name, e.g. ['64', 'true',
    '1'] of `void flash_fwd_wg_kernel<64, true, 1>(...)`."""
    m = re.search(r"_kernel<([^<>]*)>", trace_name)
    return [a.strip() for a in m.group(1).split(",")] if m else []


def bound_s(kind: str, mode: int, site: dict, peaks: dict, ble: bool = True) -> float:
    """The least seconds a launch of `kind` ("fwd", "bwd_fused", "dq",
    "dkv") in `mode` can take at `site`; `ble`: the fused backward in the
    [B, L, E] layout, which reads o and computes delta itself."""
    B, H, Lq, Lk, D = (site[k] for k in ("B", "H", "Lq", "Lk", "D"))
    flops = FLOP_UNITS[kind] * H * Lq * D * site["valid_keys"]
    elem = 2 if mode in (BF16, MXU_BF16) else 4
    q, kv, stats = B * H * Lq * D, B * H * Lk * D, 4 * B * H * Lq
    mask = B * Lk
    if kind == "fwd":            # q, k, v, mask in; o, lse out
        nbytes = elem * (2 * q + 2 * kv) + mask + stats
    elif kind == "bwd_fused" and ble:  # q, k, v, mask, o, dO, lse in; dq, dk, dv out
        nbytes = elem * (4 * q + 4 * kv) + mask + stats
    elif kind == "bwd_fused":    # q, k, v, mask, dO, lse, delta in; dq, dk, dv out
        nbytes = elem * (3 * q + 4 * kv) + mask + 2 * stats
    elif kind == "dq":           # q, k, v, mask, dO, lse, delta in; dq out
        nbytes = elem * (3 * q + 2 * kv) + mask + 2 * stats
    else:                        # q, k, v, mask, dO, lse, delta in; dk, dv out
        nbytes = elem * (2 * q + 4 * kv) + mask + 2 * stats
    if mode == F32:
        t_ops = flops / peaks["tf32x3_flops"]
    else:
        t_ops = PASSES[kind][0 if mode == BF16 else 1] * flops / peaks["bf16_flops"]
    return max(t_ops, nbytes / peaks["hbm_bytes_per_s"])
