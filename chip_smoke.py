"""On-card smoke run of the PyTorch / CUDA port (`gemm_gan_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of the JAX package. Phases:

1. Build the CUDA kernels from `gemm_gan_tpu_torch/kernels/csrc/` (nvcc into
   the ignored build dir) and print the build time, nvcc's register/spill
   report, and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it plus ragged and fully-masked cases, and
   time kernel, plain version and `scaled_dot_product_attention` (a
   yardstick only: the port never calls it).
3. The main path: `GeneratorServer.sample_all` with the flagship
   `film_cross_attention` generator at canonical widths (random weights from
   a seeded numpy tree in Flax layout, carried over by `convert.py`),
   4 batches of 8 with 256 x 1024 patches and 300 x 768 tokens, 2 repeats.
   Checks shape and finiteness, that the patch self-attention went through
   `flash_fwd_ble` 2 layers x 4 batches times, and one batch against the same
   server on the CPU.
4. Whole-slide conditioning (4,096 patches per sample, batch 8): the patch
   self-attention goes through `flash_fwd_bhld`.
5. Prints one `{"kernels": [...]}` JSON line, then the contract line
   `{"ok": true, "device": {...}}` last.

Any failed check raises, so the exit code is non-zero and the last line is
not printed. TF32 is switched off for matmuls and cuDNN, so every f32
product on the card is full f32.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "gemm_gan_tpu_torch/kernels/csrc/flash_fwd.cu"
TPU_KERNELS = "gemm_gan_tpu/kernels/flash_attention.py"
# H100 SXM data sheet: f32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs its plain version, f32 on the card (different summation order)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# whole generator, card (kernels, cuBLAS) vs CPU (plain versions)
E2E_RTOL, E2E_ATOL = 1e-4, 1e-4
BATCH, N_BATCHES, REPEATS = 8, 4, 2
WHOLE_SLIDE_PATCHES = 4096


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed):
    """q (pre-scaled), k, v, mask on the card; with `ragged`, random valid
    lengths and sample 0 fully masked."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "ble":
        qs, ks = (B, Lq, H * D), (B, Lk, H * D)
    else:
        qs, ks = (B, H, Lq, D), (B, H, Lk, D)
    q = torch.randn(qs, device="cuda", generator=g) * D ** -0.5
    k = torch.randn(ks, device="cuda", generator=g)
    v = torch.randn(ks, device="cuda", generator=g)
    if ragged:
        lens = torch.randint(1, Lk + 1, (B,), device="cuda", generator=g)
        lens[0] = 0
    else:
        lens = torch.full((B,), Lk, device="cuda")
    mask = torch.arange(Lk, device="cuda")[None, :] < lens[:, None]
    return q, k, v, mask


def bound(H, Lq, D, q, k, v, mask):
    """Least time (ms) for the work: the bytes each input read once and each
    output written once, against the operations that the valid keys need
    (q.k and p.v, 2 FLOP per multiply-add), at the card's f32 peak."""
    valid = int(mask.sum())
    flops = 4 * H * Lq * D * valid
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + mask.numel() \
        + 4 * q.shape[0] * H * Lq  # q, k, v, o, mask, lse
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(fa, layout, B, H, Lq, Lk, D, ragged, seed):
    """Kernel vs plain version on one input; returns (max |o err|, inputs)."""
    import torch

    q, k, v, mask = attention_inputs(layout, B, H, Lq, Lk, D, ragged, seed)
    if layout == "ble":
        o, lse = fa.flash_fwd_ble(q, k, v, mask, H)
        po, plse = fa.flash_fwd_ble_plain(q, k, v, mask, H)
    else:
        o, lse = fa.flash_fwd_bhld(q, k, v, mask)
        po, plse = fa.flash_fwd_bhld_plain(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, po, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    torch.testing.assert_close(lse, plse, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if ragged:  # sample 0 has no valid key
        assert float(o[0].abs().max()) == 0.0, "fully-masked rows must be 0"
    err = float((o - po).abs().max())
    print(f"  {layout:4s} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
          f"{'ragged' if ragged else 'full  '} max|o err|={err:.3e} "
          f"max|lse err|={float((lse - plse).abs().max()):.3e}", flush=True)
    return err, (q, k, v, mask)


def time_kernel(fa, layout, H, Lq, D, q, k, v, mask):
    import torch
    from torch.nn import functional as F

    if layout == "ble":
        B, L, E = q.shape

        def heads(x):
            return x.view(B, x.shape[1], H, D).transpose(1, 2)

        kernel = lambda: fa.flash_fwd_ble(q, k, v, mask, H)  # noqa: E731
        plain = lambda: fa.flash_fwd_ble_plain(q, k, v, mask, H)  # noqa: E731
        q4, k4, v4 = heads(q), heads(k), heads(v)
    else:
        kernel = lambda: fa.flash_fwd_bhld(q, k, v, mask)  # noqa: E731
        plain = lambda: fa.flash_fwd_bhld_plain(q, k, v, mask)  # noqa: E731
        q4, k4, v4 = q, k, v
    attn_mask = mask[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=attn_mask, scale=1.0)
    with torch.inference_mode():
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(library)
    bound_ms, bound_by = bound(H, Lq, D, q, k, v, mask)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def device_breakdown(server, batch) -> dict:
    """CUDA-event times (ms) of the serving path's parts for one batch: the
    conditioning's copy to the card, the condition embedding (fusion stack,
    run once per batch), one trunk evaluation (run once per repeat), and
    the copy of one repeat's profiles back to the host."""
    import torch

    with torch.inference_mode():
        cond = server.cond_tensors(batch)
        n = cond["tokens"].shape[0]
        cvec = server.gen.embed_cond(cond)
        z = torch.randn(n, server.cfg.latent_dim, device=server.device)
        fake = server.gen.score(z, cvec)
        return {"to_card": cuda_ms(lambda: server.cond_tensors(batch), iters=10),
                "embed_cond": cuda_ms(lambda: server.gen.embed_cond(cond), iters=10),
                "score": cuda_ms(lambda: server.gen.score(z, cvec), iters=10),
                "to_host": cuda_ms(lambda: fake.cpu(), iters=10)}


def flax_param_tree(m, seed: int) -> dict:
    """Random generator params in the Flax layout, with the paths that
    `gemm_gan_tpu.models.gan.Generator.init` gives them."""
    rng = np.random.RandomState(seed)
    f = m.fusion
    E = f.cond_dim

    def arr(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.randn(*shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": arr(i, o, scale=i ** -0.5), "bias": arr(o, scale=0.01)}

    def norm(n):
        return {"scale": arr(n, scale=0.1, shift=1.0), "bias": arr(n, scale=0.1)}

    def mha():
        return {n: dense(E, E) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    layers = {f"TransformerEncoderLayer_{i}": {
        "MaskedMultiHeadAttention_0": mha(), "LayerNorm_0": norm(E),
        "Dense_0": dense(E, f.ff_dim), "Dense_1": dense(f.ff_dim, E),
        "LayerNorm_1": norm(E)} for i in range(f.num_layers)}
    fusion = {
        "film": {"film_proj": dense(f.text_dim, 2 * f.patch_dim)},
        "text_encoder": dense(f.text_dim, E),
        "_PatchTransformer_0": {"patches_encoder": dense(f.patch_dim, E),
                                "cls_token": arr(1, 1, E, scale=0.02),
                                "patches_transformer": layers},
        "patch2text_attention": mha(),
        "text2patch_attention": mha(),
    }
    dims = [m.latent_dim + E, *m.gen_dims]
    trunk = {f"LinearBlock_{i}": {"Dense_0": dense(a, b)}
             for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    trunk["Dense_0"] = dense(dims[-1], m.n_genes)
    return {"fusion": fusion, "trunk": trunk}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gemm_gan_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(gemm_gan_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gemm_gan_tpu_torch.config import variant_config
    from gemm_gan_tpu_torch.data.synthetic import structured_dataset
    from gemm_gan_tpu_torch.kernels import build
    from gemm_gan_tpu_torch.kernels import flash_attention as fa
    from gemm_gan_tpu_torch.serving import GeneratorServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 off for "
          f"matmul and cuDNN", flush=True)

    # ---- 1. build
    _, build_s, log = build.build()
    build.load()
    print(f"[1] built kernels in {build_s:.1f} s", flush=True)
    for line in log.splitlines():  # ptxas -v, one entry per head-dim instantiation
        head_dim = re.search(r"Compiling entry function .*kernelILi(\d+)E", line)
        if head_dim:
            print(f"    D={head_dim.group(1)}:")
        elif "registers" in line or "spill" in line:
            print("      " + line.replace("ptxas info    :", "").strip())

    # ---- 2. kernels against their plain versions
    print(f"[2] kernels vs plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})", flush=True)
    errs = {"flash_fwd_ble": 0.0, "flash_fwd_bhld": 0.0}
    cases = [("ble", 8, 4, 257, 257, 64), ("ble", 2, 2, 130, 260, 64),
             ("bhld", 8, 4, 4097, 4097, 64), ("bhld", 2, 2, 130, 260, 64),
             ("bhld", 2, 2, 136, 600, 64), ("bhld", 2, 2, 136, 600, 8),
             ("bhld", 2, 2, 136, 600, 128)]
    for i, case in enumerate(cases):
        name = "flash_fwd_" + case[0]
        errs[name] = max(errs[name], check_kernel(fa, *case, True, seed=i)[0])
    # the serving paths' shapes with all-valid masks (structured data): checked and timed
    timed = {}
    for name, case in (("flash_fwd_ble", ("ble", 8, 4, 257, 257, 64)),
                       ("flash_fwd_bhld", ("bhld", 8, 4, 4097, 4097, 64))):
        err, (q, k, v, mask) = check_kernel(fa, *case, False, seed=100)
        errs[name] = max(errs[name], err)
        layout, _, H, Lq, _, D = case
        timed[name] = time_kernel(fa, layout, H, Lq, D, q, k, v, mask)
        print(f"  {name}: {json.dumps(timed[name])}", flush=True)
        del q, k, v, mask
    torch.cuda.empty_cache()

    # ---- 3. the main path at full width
    cfg = variant_config("film_cross_attention").model
    params = flax_param_tree(cfg, seed=0)
    server = GeneratorServer.from_flax(cfg, params)
    keys = server.keys
    data = structured_dataset(n=BATCH * N_BATCHES, n_genes=cfg.n_genes)
    batches = [{k: data[k][i * BATCH:(i + 1) * BATCH] for k in (*keys, "genes")}
               for i in range(N_BATCHES)]
    server.sample_all(batches[:1], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.sample_all(batches, REPEATS, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = {"flash_fwd_ble": fa.flash_fwd_ble.launches,
                     "flash_fwd_bhld": fa.flash_fwd_bhld.launches}
    n_profiles = BATCH * N_BATCHES * REPEATS
    print(f"[3] main path: {N_BATCHES} batches x {BATCH} x {REPEATS} repeats -> "
          f"{out['fake'].shape}; launches {main_launches}", flush=True)
    assert out["fake"].shape == (n_profiles, cfg.n_genes), out["fake"].shape
    assert np.isfinite(out["fake"]).all(), "non-finite profiles"
    assert main_launches["flash_fwd_ble"] == cfg.fusion.num_layers * N_BATCHES, main_launches
    assert main_launches["flash_fwd_bhld"] == 0, main_launches
    print(f"    {n_profiles / main_s:.1f} profiles/s ({main_s * 1e3:.1f} ms for "
          f"{n_profiles} profiles, host data to host profiles) on {card}", flush=True)
    print(f"    device ms per batch of {BATCH}: {json.dumps(device_breakdown(server, batches[0]))}",
          flush=True)

    cpu_server = GeneratorServer.from_flax(cfg, params, device="cpu")
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    on_card = server(z, batches[0]).cpu()
    on_cpu = cpu_server(z, batches[0])
    e2e_err = float((on_card - on_cpu).abs().max())
    print(f"    card vs CPU on one batch: max|err|={e2e_err:.3e} "
          f"(max|out|={float(on_cpu.abs().max()):.3f}; rtol {E2E_RTOL}, "
          f"atol {E2E_ATOL})", flush=True)
    torch.testing.assert_close(on_card, on_cpu, rtol=E2E_RTOL, atol=E2E_ATOL)
    del cpu_server, data, batches

    # ---- 4. whole-slide conditioning
    ws = structured_dataset(n=BATCH, n_genes=cfg.n_genes, num_patches=WHOLE_SLIDE_PATCHES)
    ws_batch = {k: ws[k] for k in keys}
    server.sample_all([ws_batch], 1, torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ws_out = server.sample_all([ws_batch], 1, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    ws_s = time.perf_counter() - t0
    ws_launches = {"flash_fwd_ble": fa.flash_fwd_ble.launches,
                   "flash_fwd_bhld": fa.flash_fwd_bhld.launches}
    print(f"[4] whole-slide: {WHOLE_SLIDE_PATCHES} patches x batch {BATCH} -> "
          f"{ws_out['fake'].shape}; launches {ws_launches}; "
          f"{BATCH / ws_s:.1f} profiles/s ({ws_s * 1e3:.1f} ms) on {card}", flush=True)
    assert ws_out["fake"].shape == (BATCH, cfg.n_genes)
    assert np.isfinite(ws_out["fake"]).all(), "non-finite whole-slide profiles"
    assert ws_launches["flash_fwd_bhld"] == cfg.fusion.num_layers, ws_launches
    assert ws_launches["flash_fwd_ble"] == 0, ws_launches

    # ---- 5. report
    replaces = {"flash_fwd_ble": f"{TPU_KERNELS}:290", "flash_fwd_bhld": f"{TPU_KERNELS}:84"}
    paths = {"flash_fwd_ble": ("main", main_launches),
             "flash_fwd_bhld": ("whole_slide", ws_launches)}
    kernels = []
    for name in ("flash_fwd_ble", "flash_fwd_bhld"):
        path, launches = paths[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces[name], "path": path,
                        "launches": launches[name], "max_abs_err": errs[name],
                        **timed[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
