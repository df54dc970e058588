"""Build variants of the port's tensor-core attention kernels, hold each
against its plain PyTorch version and time it, on the card.

    python3 scripts/torch_kernel_variants.py [variant ...]

Needs one CUDA card (an H100: sm_90a) and nvcc. Each variant is a copy of
`flash_fwd_bhld.cu` or `flash_bwd_dkv.cu` (and of `tf32x3.cuh`) with text
substitutions, compiled by its own nvcc into a library under
`gemm_gan_tpu_torch/kernels/build/variants/` (ignored by git) and called
through ctypes with the entry point's usual arguments. For each variant it
prints ptxas' registers and spills at D = 64, the dynamic shared memory and
blocks per SM, then, at the whole-slide shape (B 8, H 4, L 4,097, D 64),
the largest |kernel - plain version| on all-valid and ragged masks and the
kernel's time by CUDA events (20 launches after 3 warm-up). With no
argument it runs every variant in VARIANTS. A measuring tool for tuning
only: the port builds and calls the sources as they are.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "gemm_gan_tpu_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "gemm_gan_tpu_torch", "kernels", "build", "variants")
LB = "__launch_bounds__(kThreads)"
# the fresh per-tile accumulators of tf32x3::weight_rows, undone: the
# product accumulates straight into acc, as the first version did
DIRECT = [("for (int n = 0; n < NC; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;",
           "for (int n = 0; n < NC; ++n) { part[n][0] = acc[n0 + n][0] * scale_lo; "
           "part[n][1] = acc[n0 + n][1] * scale_lo; part[n][2] = acc[n0 + n][2] * scale_hi; "
           "part[n][3] = acc[n0 + n][3] * scale_hi; }"),
          (re.compile(r"fmaf\(acc\[n0 \+ n\]\[(\d)\], scale_\w+, part\[n\]\[\d\]\)"),
           r"part[n][\1]")]
# name -> (source, substitutions of the source, substitutions of tf32x3.cuh)
VARIANTS = {
    "fwd": ("flash_fwd_bhld.cu", [], []),
    "fwd_direct_acc": ("flash_fwd_bhld.cu", [], DIRECT),
    "fwd_bk64": ("flash_fwd_bhld.cu", [("int BK = 32;", "int BK = 64;")], []),
    "fwd_3_blocks": ("flash_fwd_bhld.cu", [(LB, "__launch_bounds__(kThreads, 3)")], []),
    "fwd_q_raw": ("flash_fwd_bhld.cu", [("kQSplit = D <= 64;", "kQSplit = false;")], []),
    "fwd_fast_exp": ("flash_fwd_bhld.cu", [(re.compile(r"\bexpf\("), "__expf(")], []),
    "dkv": ("flash_bwd_dkv.cu", [], []),
    "dkv_fast_exp": ("flash_bwd_dkv.cu", [(re.compile(r"\bexpf\("), "__expf(")], []),
    "dkv_direct_acc": ("flash_bwd_dkv.cu", [], DIRECT),
    "dkv_bq32": ("flash_bwd_dkv.cu", [("BQ = D <= 64 ? 64 : 32;", "BQ = 32;")], []),
    "dkv_bq32_3_blocks": ("flash_bwd_dkv.cu", [("BQ = D <= 64 ? 64 : 32;", "BQ = 32;"),
                                               (LB, "__launch_bounds__(kThreads, 3)")], []),
}
_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if isinstance(old, str):
            if old not in text:
                raise ValueError(f"substitution target not found: {old!r}")
            text = text.replace(old, new)
        else:
            text, n = old.subn(new, text)
            if not n:
                raise ValueError(f"substitution pattern not found: {old.pattern!r}")
    return text


def build(names):
    """Compile the variants in parallel; returns {name: (entry point fn,
    ptxas lines at D = 64, (smem bytes, blocks per SM) at D = 64)}."""
    procs = {}
    for name in names:
        source, subs, header_subs = VARIANTS[name]
        vdir = os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(CSRC, "tf32x3.cuh")) as f:
            header = substitute(f.read(), header_subs)
        with open(os.path.join(vdir, "tf32x3.cuh"), "w") as f:
            f.write(header)
        with open(os.path.join(CSRC, source)) as f:
            text = substitute(f.read(), subs)
        with open(os.path.join(vdir, source), "w") as f:
            f.write(text)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             os.path.join(vdir, "lib.so"), os.path.join(vdir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        ptxas, head_dim = [], None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '\w*kernelILi(\d+)E", line)
            if entry:
                head_dim = entry.group(1)
            elif head_dim == "64" and ("registers" in line or "spill" in line):
                ptxas.append(line.replace("ptxas info    :", "").strip())
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        entry = "flash_fwd_bhld" if VARIANTS[name][0] == "flash_fwd_bhld.cu" else "flash_bwd_dkv"
        fn = getattr(lib, entry)
        fn.argtypes = _FWD_ARGS if entry == "flash_fwd_bhld" else _BWD_ARGS
        fn.restype = ctypes.c_int
        occ = getattr(lib, entry + "_occupancy")
        occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        if occ(64, ctypes.byref(smem), ctypes.byref(blocks)):
            raise RuntimeError(f"{name}: occupancy query failed")
        built[name] = (fn, ptxas, (smem.value, blocks.value))
    return built


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gemm_gan_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    names = argv or list(VARIANTS)
    print(f"card: {cs.card_line()}", flush=True)
    built = build(names)
    for name, (_, ptxas, (smem, blocks)) in built.items():
        print(f"{name}: D=64 {'; '.join(ptxas)}; {smem} bytes of shared memory, "
              f"{blocks} blocks per SM", flush=True)
    B, H, L, D = 8, 4, 4097, 64
    stream = torch.cuda.current_stream().cuda_stream
    for ragged, seed in ((False, 200), (True, 26)):
        q, k, v, mask = cs.attention_inputs("bhld", B, H, L, L, D, ragged, seed)
        po, plse = fa.flash_fwd_bhld_plain(q, k, v, mask)
        g = torch.Generator(device="cuda").manual_seed(seed + 1000)
        do = torch.randn(q.shape, device="cuda", generator=g)
        delta = (do * po).sum(-1)
        pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, mask, do, plse, delta)
        o, lse = torch.empty_like(q), torch.empty_like(plse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        for name, (fn, _, _) in built.items():
            if VARIANTS[name][0] == "flash_fwd_bhld.cu":
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731
                                  mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                  B, L, L, H, D, stream)
                outs, want = (o, lse), (po, plse)
            else:
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731
                                  mask.data_ptr(), None, do.data_ptr(), plse.data_ptr(),
                                  delta.data_ptr(), None, dk.data_ptr(), dv.data_ptr(),
                                  B, L, L, H, D, stream)
                outs, want = (dk, dv), (pdk, pdv)
            if call():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(outs, want)]
            ms = "" if ragged else f"; {cs.cuda_ms(call):.4f} ms"
            print(f"{'ragged' if ragged else 'full  '} {name}: max|err| "
                  f"{' / '.join(f'{e:.3e}' for e in errs)}{ms}", flush=True)
        del q, k, v, mask, po, plse, do, delta, pdk, pdv, o, lse, dk, dv
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
