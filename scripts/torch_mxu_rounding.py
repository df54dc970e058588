"""How far the bf16 backward modes land from their plain versions, and both
from a float64 evaluation of the same roundings, at token
cross-attention's whole-slide shape, on the card.

    python3 scripts/torch_mxu_rounding.py [--seeds N]

Needs one CUDA card and nvcc (the port's kernels are built at first use).
For Q4 and Q5 (`flash_bwd_dq`, `flash_bwd_dkv`) in the bf16 mode and
under mxu_bf16 (on bf16 and on f32 refs), at B 8, H 4, Lq 300, Lk 4,097,
D 64 with ragged keys (chip_smoke.py's phase-2 inputs, seeds 600..), it
prints per output the largest distance in bf16 ulps of a row's largest
entry and the rows beyond one ulp: kernel vs plain version, kernel vs
float64, plain version vs float64. The float64 evaluation rounds what the
mode rounds (under mxu_bf16 the operands and dS / P before their products)
and nothing else, so a distance beyond one ulp from it is a second
rounding landing the other way, not an error of the sums. For
`flash_bwd_dkv_mxu` it also prints the margin of phase 2's per-entry bound
(`chip_smoke.rounded_operand_bound`): the largest |kernel - plain| over the
bound (<= 1 within it) and the same for the kernel's dk and dv scaled by
1 + 2^-5 (the negative control, > 1 when the bound rejects it). A
measuring tool: nothing is gated.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ulps(got, want) -> tuple:
    """(largest |got - want| in bf16 ulps of its row's largest |want|, rows
    beyond one ulp, rows)."""
    import torch

    g, w = got.double(), want.double()
    top = w.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(top)
    ulp = torch.ldexp(torch.ones_like(top), e - 8)
    r = (g - w).abs() / torch.where(top > 0, ulp, torch.ones_like(ulp))
    return round(float(r.max()), 4), int((r > 1).any(-1).sum()), int(r[..., 0].numel())


def float64_evaluation(args, mxu: bool) -> dict:
    """dq, dk, dv of the plain versions' formulas in float64, rounding to
    bf16 only what the mode rounds."""
    import torch

    q, k, v, mask, do, lse, delta = (x.double() if x.is_floating_point() else x for x in args)

    def op(x):
        return x.to(torch.bfloat16).double() if mxu else x

    q, k, v, do = (op(x) for x in (q, k, v, do))
    valid = mask[:, None, None, :]
    s = torch.where(valid, q @ k.transpose(-1, -2), -1e30)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    return {"dq": op(ds) @ k, "dk": op(ds).transpose(-1, -2) @ q,
            "dv": op(p).transpose(-1, -2) @ do}


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mxu_rounding: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gemm_gan_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    for name in ("flash_bwd_dkv_mxu", "flash_bwd_dq_mxu", "flash_bwd_dkv_bf16",
                 "flash_bwd_dq_bf16"):
        mxu = name.endswith("_mxu")
        for dtype in ((torch.bfloat16, torch.float32) if mxu else (torch.bfloat16,)):
            for seed in range(600, 600 + opts.seeds):
                args = cs.bf16_args(fa, name, *cs.XATTN_WHOLE_SLIDE_SHAPE, True, seed, dtype)
                got, want = getattr(fa, name)(*args), getattr(fa, name + "_plain")(*args)
                got, want = ((x,) if isinstance(x, torch.Tensor) else x for x in (got, want))
                exact = float64_evaluation(args, mxu)
                parts = [f"{label}: kernel vs plain {ulps(g, w)}, kernel vs float64 "
                         f"{ulps(g, exact[label])}, plain vs float64 {ulps(w, exact[label])}"
                         for label, g, w in zip(cs.output_labels(name), got, want)]
                if name == "flash_bwd_dkv_mxu":
                    bound = cs.rounded_operand_bound(args)
                    parts += [f"{label} bound margin: kernel "
                              f"{cs.bound_ratio(g, w, bound[label]):.4f}, control "
                              f"{cs.bound_ratio(g.float() * (1 + 2 ** -5), w, bound[label]):.4f}"
                              for label, g, w in zip(("dk", "dv"), got, want)]
                print(f"{name} {str(dtype).split('.')[-1]} seed {seed} "
                      f"{cs.XATTN_WHOLE_SLIDE_SHAPE}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
