"""The port's encoders, contrastive pair and embedding caches against the
JAX package's, on the CPU at tiny widths.

`encoders.vit.ViT` against `FlaxViT` (f32: at the native image size and at
resampled ones, which holds the cubic position-embedding resample against
`jax.image.resize`), timm- and HF-layout random state dicts against JAX's
converters, the layout validation at the published dims,
`encoders.modernbert.ModernBert` against `FlaxModernBert` beyond the local
window with padding, bf16 against f32, `info_nce` and three
`ContrastiveEngine` steps against JAX's, and the cache builders' files
against JAX's on the same weights. Tolerances: f32 forwards rtol 1e-4 /
atol 1e-5 (different summation order through a few layers); bf16 against
f32 by cosine > 0.99, as the JAX test holds its own.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gemm_gan_tpu.encoders import cache as jcache
from gemm_gan_tpu.encoders import contrastive as jcon
from gemm_gan_tpu.encoders.modernbert import (FlaxModernBert, convert_modernbert_state_dict,
                                              expected_modernbert_layout as j_bert_layout)
from gemm_gan_tpu.encoders.modernbert import ModernBertParams as JBertParams
from gemm_gan_tpu.encoders.vit import (FlaxViT, convert_hf_vit_state_dict,
                                       convert_timm_vit_state_dict)
from gemm_gan_tpu.encoders.vit import ViTParams as JViTParams
from gemm_gan_tpu.encoders.vit import expected_vit_layout as j_vit_layout
from gemm_gan_tpu_torch.cli import convert_encoders as tconv
from gemm_gan_tpu_torch.convert import modernbert_state_dict_from_flax, vit_state_dict_from_flax
from gemm_gan_tpu_torch.encoders import cache as tcache
from gemm_gan_tpu_torch.encoders import contrastive as tcon
from gemm_gan_tpu_torch.encoders.modernbert import (ModernBert, ModernBertParams,
                                                    expected_modernbert_layout,
                                                    from_hf_state_dict as bert_from_hf,
                                                    params_from_config,
                                                    validate_modernbert_layout)
from gemm_gan_tpu_torch.encoders.vit import (ViT, ViTParams, cubic_resize_matrix,
                                             expected_vit_layout, from_hf_state_dict,
                                             preprocess_tiles, validate_vit_layout)
from test_torch_variants import one_thread

RTOL, ATOL = 1e-4, 1e-5
VIT = dict(img_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
           mlp_ratio=2.0)
BERT = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=4, num_heads=4,
            global_every=3, local_window=4)
UNI_PARAM_COUNT = 303_350_784
MODERNBERT_PARAM_COUNT = 149_014_272


assert one_thread  # one intra-op thread: the autouse fixture runs here too


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


@pytest.fixture(scope="module")
def vit_params():
    """FlaxViT params with LayerScale gammas and a position table made
    non-trivial, so the blocks and the resample both matter."""
    p = JViTParams(**VIT, layerscale_init=0.5)
    params = jax.device_get(FlaxViT(p).init(jax.random.key(0),
                                            np.zeros((1, 32, 32, 3), np.float32))["params"])
    params = jax.tree.map(np.asarray, params)
    params["cls_token"] = np.random.RandomState(5).randn(1, 1, 32).astype(np.float32) * 0.5
    return p, params


@pytest.fixture(scope="module")
def bert_params():
    p = JBertParams(**BERT)
    ids = np.zeros((1, 8), np.int32)
    params = jax.device_get(FlaxModernBert(p).init(jax.random.key(1), ids)["params"])
    return p, jax.tree.map(np.asarray, params)


def _port_vit(params, **kw):
    vit = ViT(ViTParams(**VIT, layerscale_init=0.5), device="cpu", **kw)
    vit.load_state_dict(vit_state_dict_from_flax(params))
    return vit


# ----------------------------------------------------------------------- ViT
@pytest.mark.parametrize("size", [32, 48, 24, 40])
def test_vit_matches_flax_vit(size, vit_params):
    """32: the native grid (4 x 4); 48 and 40 resample the position table
    up (6 x 6, 5 x 5), 24 down (3 x 3: the widened, antialiased kernel)."""
    p, params = vit_params
    imgs = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(FlaxViT(p, pool="none").apply({"params": params}, imgs))
    with torch.no_grad():
        got = _port_vit(params, pool="none")(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 1 + (size // 8) ** 2, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_in,n_out", [(14, 16), (4, 6), (4, 3), (16, 14), (14, 14)])
def test_cubic_resize_matrix_matches_jax_image_resize(n_in, n_out):
    """The resample's weights: an identity image through `jax.image.resize`
    (cubic, antialias) is the weight matrix itself. UNI's 14 x 14 grid goes
    to 16 x 16 at 256-pixel tiles. Within a few f32 ulps (XLA fuses the
    kernel's arithmetic); torch's bicubic misses by ~1e-2."""
    eye = np.eye(n_in, dtype=np.float32)[:, :, None]
    want = np.asarray(jax.image.resize(eye, (n_in, n_out, 1), "cubic", antialias=True))[..., 0]
    np.testing.assert_allclose(cubic_resize_matrix(n_in, n_out), want, rtol=0, atol=1e-6)


def _timm_sd(p, rng):
    E, FF, ps = p.hidden_size, int(p.hidden_size * p.mlp_ratio), p.patch_size
    sd = {"patch_embed.proj.weight": rng.randn(E, 3, ps, ps) * 0.05,
          "patch_embed.proj.bias": rng.randn(E) * 0.05,
          "cls_token": rng.randn(1, 1, E) * 0.5, "pos_embed": rng.randn(1, 1 + p.num_patches, E),
          "norm.weight": 1 + rng.randn(E) * 0.1, "norm.bias": rng.randn(E) * 0.1}
    for i in range(p.num_layers):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": 1 + rng.randn(E) * 0.1, f"{b}.norm1.bias": rng.randn(E) * 0.1,
                   f"{b}.attn.qkv.weight": rng.randn(3 * E, E) * 0.2,
                   f"{b}.attn.qkv.bias": rng.randn(3 * E) * 0.05,
                   f"{b}.attn.proj.weight": rng.randn(E, E) * 0.2,
                   f"{b}.attn.proj.bias": rng.randn(E) * 0.05,
                   f"{b}.ls1.gamma": rng.rand(E), f"{b}.norm2.weight": 1 + rng.randn(E) * 0.1,
                   f"{b}.norm2.bias": rng.randn(E) * 0.1,
                   f"{b}.mlp.fc1.weight": rng.randn(FF, E) * 0.2,
                   f"{b}.mlp.fc1.bias": rng.randn(FF) * 0.05,
                   f"{b}.mlp.fc2.weight": rng.randn(E, FF) * 0.2,
                   f"{b}.mlp.fc2.bias": rng.randn(E) * 0.05, f"{b}.ls2.gamma": rng.rand(E)})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _hf_sd(p, rng):
    """An HF `ViTModel` state dict (with its pooler) built from a timm one."""
    t = _timm_sd(p, rng)
    E = p.hidden_size
    sd = {"embeddings.cls_token": t["cls_token"], "embeddings.position_embeddings": t["pos_embed"],
          "embeddings.patch_embeddings.projection.weight": t["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias": t["patch_embed.proj.bias"],
          "layernorm.weight": t["norm.weight"], "layernorm.bias": t["norm.bias"],
          "pooler.dense.weight": np.zeros((E, E), np.float32),
          "pooler.dense.bias": np.zeros(E, np.float32)}
    for i in range(p.num_layers):
        b, e = f"blocks.{i}", f"encoder.layer.{i}"
        for j, n in enumerate(("query", "key", "value")):
            sd[f"{e}.attention.attention.{n}.weight"] = t[f"{b}.attn.qkv.weight"][j * E:(j + 1) * E]
            sd[f"{e}.attention.attention.{n}.bias"] = t[f"{b}.attn.qkv.bias"][j * E:(j + 1) * E]
        for src, dst in (("norm1", "layernorm_before"), ("attn.proj", "attention.output.dense"),
                         ("norm2", "layernorm_after"), ("mlp.fc1", "intermediate.dense"),
                         ("mlp.fc2", "output.dense")):
            sd[f"{e}.{dst}.weight"] = t[f"{b}.{src}.weight"]
            sd[f"{e}.{dst}.bias"] = t[f"{b}.{src}.bias"]
    return sd


@pytest.mark.parametrize("layout", ["timm", "hf"])
def test_state_dicts_load_strict_and_match_jax_converters(layout):
    rng = np.random.RandomState(3)
    scale = 0.5 if layout == "timm" else None
    p = ViTParams(**VIT, layerscale_init=scale)
    jp = JViTParams(**VIT, layerscale_init=scale)
    if layout == "timm":
        sd = _timm_sd(p, rng)
        params, port_sd = convert_timm_vit_state_dict(sd, jp), sd
    else:
        sd = _hf_sd(p, rng)
        params, port_sd = convert_hf_vit_state_dict(sd, jp), from_hf_state_dict(sd, p)
    vit = ViT(p, pool="none", device="cpu")
    vit.load_state_dict({k: torch.as_tensor(v) for k, v in port_sd.items()}, strict=True)
    imgs = rng.randn(2, 40, 40, 3).astype(np.float32)
    want = np.asarray(FlaxViT(jp, pool="none").apply({"params": params}, imgs))
    with torch.no_grad():
        got = vit(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_layout_validation_at_the_published_dims():
    """UNI (ViT-L/16 + LayerScale) and ModernBERT-base: the layouts hold the
    published parameter counts and JAX's tensors one for one, a tiny
    module's state dict is its layout, and drift is named."""
    p, bp = ViTParams(), ModernBertParams()
    layout = expected_vit_layout(p)
    zeros = {k: np.broadcast_to(np.float32(0), s) for k, s in layout.items()}
    assert validate_vit_layout(zeros, p) == UNI_PARAM_COUNT
    assert len(layout) == len(j_vit_layout(JViTParams()))
    blayout = expected_modernbert_layout(bp)
    bzeros = {k: np.broadcast_to(np.float32(0), s) for k, s in blayout.items()}
    assert validate_modernbert_layout(bzeros, bp) == MODERNBERT_PARAM_COUNT
    assert len(blayout) == len(j_bert_layout(JBertParams()))
    tiny = ViTParams(**VIT)
    assert {k: tuple(v.shape) for k, v in ViT(tiny, device="cpu").state_dict().items()} \
        == expected_vit_layout(tiny)
    tb = ModernBertParams(**BERT)
    assert {k: tuple(v.shape) for k, v in ModernBert(tb, device="cpu").state_dict().items()} \
        == expected_modernbert_layout(tb)
    bad = dict(zeros)
    bad.pop("blocks.3.ls1.gamma")
    bad["blocks.0.attn.qkv.weight"] = np.zeros((3, 3), np.float32)
    bad["head.weight"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError) as err:
        validate_vit_layout(bad, p)
    for word in ("missing tensor blocks.3.ls1.gamma", "shape mismatch blocks.0.attn.qkv",
                 "unexpected tensor head.weight"):
        assert word in str(err.value)


def test_preprocess_tiles_matches_jax():
    from gemm_gan_tpu.encoders.vit import preprocess_tiles as jpre

    tiles = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(preprocess_tiles(tiles), jpre(tiles))


# ---------------------------------------------------------------- ModernBERT
@pytest.mark.parametrize("seq_len", [12, 20])
def test_modernbert_matches_flax_modernbert(seq_len, bert_params):
    """Beyond the local window (+-2 here) with padding: every position,
    padded rows included (their keys are masked as in JAX)."""
    p, params = bert_params
    rng = np.random.RandomState(seq_len)
    ids = rng.randint(0, 96, (3, seq_len)).astype(np.int32)
    mask = np.arange(seq_len)[None, :] < np.array([seq_len, seq_len // 2, 3])[:, None]
    want = np.asarray(FlaxModernBert(p).apply({"params": params}, ids, mask))
    model = ModernBert(ModernBertParams(**BERT), device="cpu")
    model.load_state_dict(modernbert_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_hf_modernbert_state_dict_loads_and_matches_jax_converter(bert_params):
    """A masked LM's state dict ("model." prefix, an LM head) and a
    `config.json` dict: the port's params and module equal JAX's
    converter's on the same dict."""
    p, params = bert_params
    sd = {"model." + k: v.numpy() for k, v in modernbert_state_dict_from_flax(params).items()}
    sd["head.dense.weight"] = np.zeros((32, 32), np.float32)
    config = {"vocab_size": 96, "hidden_size": 32, "intermediate_size": 48,
              "num_hidden_layers": 4, "num_attention_heads": 4,
              "global_attn_every_n_layers": 3, "local_attention": 4,
              "global_rope_theta": 160000.0, "local_rope_theta": None, "norm_eps": 1e-5}
    tp = params_from_config(config)
    assert tp == ModernBertParams(**BERT, local_rope_theta=160000.0)
    tp = ModernBertParams(**BERT)
    jparams = convert_modernbert_state_dict(sd, p)
    model = ModernBert(tp, device="cpu")
    model.load_state_dict(bert_from_hf(sd), strict=True)
    ids = np.random.RandomState(0).randint(0, 96, (2, 10)).astype(np.int32)
    want = np.asarray(FlaxModernBert(p).apply({"params": jparams}, ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encoders_bf16_close_to_f32(vit_params, bert_params):
    """Twin of tests/test_encoders.py::test_encoders_bf16_compute_close_to_f32."""
    _, params = vit_params
    imgs = torch.from_numpy(np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        e32 = _port_vit(params)(imgs)
        e16 = _port_vit(params, dtype=torch.bfloat16)(imgs)
    assert e16.dtype == torch.float32 and _cos(e32, e16).min() > 0.99
    _, bparams = bert_params
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, (4, 16)))
    models = [ModernBert(ModernBertParams(**BERT), dtype=d, device="cpu")
              for d in (torch.float32, torch.bfloat16)]
    for m in models:
        m.load_state_dict(modernbert_state_dict_from_flax(bparams))
    with torch.no_grad():
        t32, t16 = (m(ids) for m in models)
    assert t16.dtype == torch.float32 and _cos(t32, t16).min() > 0.99


# --------------------------------------------------------------- contrastive
def _paired(rng, n=32, image_dim=12, text_dim=8, n_classes=4):
    cls = rng.randint(0, n_classes, n)
    img = rng.randn(n_classes, image_dim)[cls] + 0.1 * rng.randn(n, image_dim)
    txt = rng.randn(n_classes, text_dim)[cls] + 0.1 * rng.randn(n, text_dim)
    return img.astype(np.float32), txt.astype(np.float32)


def test_info_nce_matches_jax():
    rng = np.random.RandomState(0)
    zi, zt = (rng.randn(16, 4).astype(np.float32) for _ in range(2))
    for t in (0.05, 0.07, 1.0):
        want = float(jcon.info_nce(jnp.asarray(zi), jnp.asarray(zt), t))
        got = float(tcon.info_nce(torch.from_numpy(zi), torch.from_numpy(zt), t))
        assert got == pytest.approx(want, rel=1e-5)


def test_three_contrastive_steps_match_jax():
    rng = np.random.RandomState(1)
    img, txt = _paired(rng)
    cfg = dict(image_dim=12, text_dim=8, emb_dim=6, lr=5e-3)
    jeng = jcon.ContrastiveEngine(jcon.ContrastiveConfig(**cfg))
    jstate = jeng.init_state(0)
    teng = tcon.ContrastiveEngine(tcon.ContrastiveConfig(**cfg), device="cpu")
    tstate = teng.state_from_flax(jax.device_get(jstate["params"]))
    for _ in range(3):
        jstate, jloss = jeng.step(jstate, img, txt)
        tstate, tloss = teng.step(tstate, img, txt)
        assert tloss == pytest.approx(jloss, rel=1e-5)
    for got, want in zip(teng.project(tstate, img, txt), jeng.project(jstate, img, txt)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert float(tstate["model"].log_temperature.detach()) == pytest.approx(
        float(jstate["params"]["log_temperature"]), rel=1e-5)


def test_contrastive_training_improves_alignment():
    """Twin of tests/test_contrastive_cache.py's: 60 steps learn the pairing."""
    rng = np.random.RandomState(42)
    img, txt = _paired(rng, n=64)
    eng = tcon.ContrastiveEngine(tcon.ContrastiveConfig(image_dim=12, text_dim=8, emb_dim=6,
                                                        lr=5e-3), device="cpu")
    state = eng.init_state(0)
    losses = []
    for _ in range(60):
        state, loss = eng.step(state, img, txt)
        losses.append(loss)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -------------------------------------------------------------------- caches
def test_batched_apply_pads_tail():
    calls = []
    x = np.random.RandomState(0).randn(10, 3).astype(np.float32)

    def fn(t):
        calls.append(t.shape[0])
        return t * 2.0

    np.testing.assert_allclose(tcache.batched_apply(fn, x, batch_size=4, device="cpu"),
                               x * 2.0, rtol=1e-6)
    assert calls == [4, 4, 4]


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cache_builders_write_jax_files(tmp_path, vit_params, bert_params):
    """Patch, CLS, token and contrastive caches from the port's encoders and
    from JAX's on the same weights: the same files, equal masks, the
    embeddings within the f32 tolerance; `load_tcga` reads the port's."""
    _, vparams = vit_params
    bp, bparams = bert_params
    rng = np.random.RandomState(7)
    cases = [f"case-{i}" for i in range(5)]
    tiles = {c: preprocess_tiles(rng.randint(0, 256, (3 + i, 32, 32, 3)).astype(np.uint8))
             for i, c in enumerate(cases)}
    ids = {c: rng.randint(0, 96, 9).astype(np.int32) for c in cases}
    masks = {c: np.arange(9) < 3 + i for i, c in enumerate(cases)}
    vit = _port_vit(vparams)
    bert = ModernBert(ModernBertParams(**BERT), device="cpu")
    bert.load_state_dict(modernbert_state_dict_from_flax(bparams))
    jvit = jax.jit(lambda x: FlaxViT(JViTParams(**VIT, layerscale_init=0.5)).apply(
        {"params": vparams}, x))
    jbert = jax.jit(lambda i, m: FlaxModernBert(bp).apply({"params": bparams}, i, m))
    roots = {}
    for side, embed, encode, build in (
            ("jax", jvit, jbert, jcache),
            ("port", vit, lambda i, m: bert(i, m), tcache)):
        root = str(tmp_path / side)
        kw = {} if side == "jax" else {"device": "cpu"}
        build.build_patch_cache(embed, tiles, os.path.join(root, "patch_embeddings_uni"),
                                batch_size=4, **kw)
        build.build_text_cls_cache(encode, ids, masks, os.path.join(
            root, "clinical_modernbert_embeddings.parquet"), batch_size=2, **kw)
        build.build_text_token_cache(encode, ids, masks, os.path.join(
            root, "clinical_modernbert_embeddings"), batch_size=2, **kw)
        w_img = np.random.RandomState(1).randn(32, 4).astype(np.float32)
        build.build_contrastive_caches(
            lambda x: np.asarray(x) @ w_img, lambda x: np.asarray(x) @ w_img,
            os.path.join(root, "patch_embeddings_uni"),
            os.path.join(root, "clinical_modernbert_embeddings"), root, emb_dim=4)
        roots[side] = root
    files = _tree_files(roots["jax"])
    assert files == _tree_files(roots["port"]) and len(files) == 5 * 4 + 3
    for f in files:
        a, b = (os.path.join(roots[s], f) for s in ("port", "jax"))
        if f.endswith(".parquet"):
            pa, pb = pd.read_parquet(a), pd.read_parquet(b)
            assert list(pa.index) == list(pb.index) and list(pa.columns) == list(pb.columns)
            np.testing.assert_allclose(pa.to_numpy(), pb.to_numpy(), rtol=RTOL, atol=ATOL)
        else:
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    pq = pd.read_parquet(os.path.join(roots["port"], "clinical_modernbert_embeddings.parquet"))
    for c in cases:  # the CLS vector is the token cache's first row
        tok = np.load(os.path.join(roots["port"], "clinical_modernbert_embeddings", f"{c}.npy"))
        np.testing.assert_array_equal(pq.loc[c].to_numpy(), tok[0])


def test_convert_encoders_cli_from_hf_cache(tmp_path, monkeypatch, bert_params):
    """`cli.convert_encoders` resolves hub ids in a local HF cache (refs/main
    first), validates, and writes state dicts that load strictly; the
    manifest's sha256 is the file's."""
    import hashlib
    import json

    p, params = bert_params
    hub = tmp_path / "hf" / "hub" / "models--org--bert"
    snap = hub / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (hub / "refs").mkdir()
    (hub / "refs" / "main").write_text("abc")
    sd = {"model." + k: v for k, v in modernbert_state_dict_from_flax(params).items()}
    torch.save(sd, snap / "pytorch_model.bin")
    (snap / "config.json").write_text(json.dumps({
        "vocab_size": 96, "hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 4,
        "num_attention_heads": 4, "global_attn_every_n_layers": 3, "local_attention": 4,
        "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "norm_eps": 1e-5}))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    (manifest,) = tconv.main(["--modernbert", "org/bert", "--out", str(tmp_path / "enc")])
    out = tmp_path / "enc" / "clinical_modernbert.pt"
    assert manifest["sha256"] == hashlib.sha256(out.read_bytes()).hexdigest()
    assert manifest["params"] == {**BERT, "global_rope_theta": 160000.0,
                                  "local_rope_theta": 10000.0, "norm_eps": 1e-5}
    model = ModernBert(ModernBertParams(**BERT), device="cpu")
    model.load_state_dict(tconv.load_converted(str(out)), strict=True)
    with pytest.raises(FileNotFoundError, match="huggingface-cli download"):
        tconv.find_checkpoint("org/missing")
    torch.save({"blocks.0.norm1.weight": torch.zeros(3)}, tmp_path / "bad.bin")
    with pytest.raises(SystemExit, match="not a UNI ViT-L/16 checkpoint"):
        tconv.main(["--uni", str(tmp_path / "bad.bin"), "--out", str(tmp_path / "enc")])
