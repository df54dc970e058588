"""The port's ingest layer, offline: the twin of tests/test_ingest.py on
the port's host copies (`gemm_gan_tpu_torch/data/{gdc,tiles,descriptions,
ingest}.py`: the GDC client and selection over a fake transport, Otsu and
tiling goldens, description generation with a fake LLM, the streaming
pipeline), then the copies against the JAX modules on the same inputs, the
UNI embed stage of `cli.ingest` in the pipeline against `FlaxViT`, and
`cli.preprocess` end to end (a fake tokenizer, a tiny HF-layout ModernBERT
checkpoint) into caches that `load_tcga` reads. No test reaches the
network."""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import json
import os

import numpy as np
import pandas as pd
import pytest

from gemm_gan_tpu_torch.data.descriptions import (DESCRIPTION_MARKER, SYSTEM_PROMPT,
                                            format_metadata,
                                            generate_descriptions,
                                            parse_generation)
from gemm_gan_tpu_torch.data.gdc import (DatasetIndex, GDCClient,
                                   build_expression_matrix, parse_rna_seq_tsv,
                                   select_rna_seq_files, select_tissue_slides,
                                   write_case_artifacts)
from gemm_gan_tpu_torch.data.ingest import IngestPipeline
from gemm_gan_tpu_torch.data.tiles import (extract_tiles, otsu_mask, otsu_threshold,
                                     load_valid_patches, save_valid_patches,
                                     tiles_from_array, valid_patches_for_slide)
from test_torch_variants import one_thread


assert one_thread  # one intra-op thread: the autouse fixture runs here too


# --------------------------------------------------------------------- GDC
class FakeResponse:
    def __init__(self, payload):
        self._payload = payload

    def raise_for_status(self):
        pass

    def json(self):
        return self._payload


class FakeSession:
    """Echoes canned hits; records the batched filter values."""

    def __init__(self, hits_by_endpoint):
        self.hits = hits_by_endpoint
        self.calls = []

    def post(self, url, json=None, timeout=None):
        endpoint = url.rsplit("/", 1)[-1]
        values = json["filters"]["content"]["value"]
        self.calls.append((endpoint, list(values)))
        hits = [h for h in self.hits.get(endpoint, [])
                if h.get("_match") in values]
        return FakeResponse({"data": {"hits": [
            {k: v for k, v in h.items() if k != "_match"} for h in hits]}})


def test_map_files_batches_of_100():
    ids = [f"id{i}" for i in range(250)]
    hits = [{"_match": i, "file_id": i, "file_name": f"{i}.tsv",
             "cases": [{"submitter_id": "s", "case_id": f"c-{i}",
                        "project": {"project_id": "TCGA-X"}}]} for i in ids]
    sess = FakeSession({"files": hits})
    client = GDCClient(session=sess, retries=1)
    df = client.map_files(ids)
    assert len(df) == 250
    assert [len(v) for _, v in sess.calls] == [100, 100, 50]
    assert set(df.columns) >= {"file_id", "file_name", "case_id", "project_id"}


def test_client_retries_then_raises():
    class FailingSession:
        def __init__(self):
            self.n = 0

        def post(self, url, json=None, timeout=None):
            self.n += 1
            raise ConnectionError("boom")

    sess = FailingSession()
    client = GDCClient(session=sess, retries=3, backoff=0.0)
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        client.map_files(["x"])
    assert sess.n == 3


def _rna_entities():
    return pd.DataFrame([
        # case A: two files, newer one must win
        dict(file_id="f1", file_name="a_old.tsv", case_id="A",
             tissue_type="Tumor", tumor_descriptor="Primary",
             portion_submitter_id="pA", created_datetime="2020-01-01"),
        dict(file_id="f2", file_name="a_new.tsv", case_id="A",
             tissue_type="Tumor", tumor_descriptor="Primary",
             portion_submitter_id="pA", created_datetime="2021-01-01"),
        # case B: normal tissue -> dropped
        dict(file_id="f3", file_name="b.tsv", case_id="B",
             tissue_type="Normal", tumor_descriptor="Primary",
             portion_submitter_id="pB", created_datetime="2021-01-01"),
        # case C: metastatic -> dropped
        dict(file_id="f4", file_name="c.tsv", case_id="C",
             tissue_type="Tumor", tumor_descriptor="Metastatic",
             portion_submitter_id="pC", created_datetime="2021-01-01"),
    ])


def test_select_rna_seq_files_dedup_and_filters():
    kept = select_rna_seq_files(_rna_entities())
    assert kept["case_id"].tolist() == ["A"]
    assert kept["file_name"].tolist() == ["a_new.tsv"]


def test_select_tissue_slides_prefers_bottom_then_recent():
    ents = pd.DataFrame([
        dict(file_id="s1", file_name="x.id1.svs", case_id="A",
             tissue_type="Tumor", tumor_descriptor="Primary",
             section_location="TOP", portion_submitter_id="pA",
             created_datetime="2022-01-01"),
        dict(file_id="s2", file_name="x.id2.svs", case_id="A",
             tissue_type="Tumor", tumor_descriptor="Primary",
             section_location="BOTTOM", portion_submitter_id="pA",
             created_datetime="2020-01-01"),
        dict(file_id="s3", file_name="x.id3.svs", case_id="A",
             tissue_type="Tumor", tumor_descriptor="Primary",
             section_location="BOTTOM", portion_submitter_id="pA",
             created_datetime="2021-01-01"),
        # portion not in the RNA-selected set -> dropped
        dict(file_id="s4", file_name="y.id4.svs", case_id="B",
             tissue_type="Tumor", tumor_descriptor="Primary",
             section_location="BOTTOM", portion_submitter_id="pZ",
             created_datetime="2021-01-01"),
    ])
    kept = select_tissue_slides(ents, valid_portions=["pA"])
    # BOTTOM beats TOP; most recent bottom wins
    assert kept["file_name"].tolist() == ["x.id3.svs"]


def test_rna_tsv_parse_and_matrix(tmp_path):
    header = "# comment\ngene_id\tgene_name\tgene_type\tunstranded\tstranded_first\tstranded_second\ttpm_unstranded\tfpkm_unstranded\tfpkm_uq_unstranded\n"
    summary = "".join(f"N_{k}\t\t\t0\t0\t0\t0\t0\t0\n"
                      for k in ("unmapped", "multimapping", "noFeature", "ambiguous"))
    rows = ("g1\tG1\tprotein_coding\t5\t0\t0\t3.0\t0\t0\n"
            "g2\tG2\tlncRNA\t5\t0\t0\t9.0\t0\t0\n"
            "g3\tG3\tprotein_coding\t5\t0\t0\t1.0\t0\t0\n")
    for case in ("A", "B"):
        (tmp_path / f"{case}.tsv").write_text(header + summary + rows)
    s = parse_rna_seq_tsv(str(tmp_path / "A.tsv"))
    assert s.index.tolist() == ["g1", "g3"]  # protein_coding only
    assert s.tolist() == [3.0, 1.0]

    idx = DatasetIndex({c: {"rna_seq_file": f"{c}.tsv", "tissue_file": f"{c}.svs"}
                        for c in ("A", "B")})
    mat = build_expression_matrix(idx, str(tmp_path),
                                  str(tmp_path / "rna_seq.parquet"))
    assert mat.shape == (2, 2)
    np.testing.assert_allclose(mat.loc["A", "g1"], np.log2(4.0))
    assert (tmp_path / "rna_seq.parquet").exists()


def test_dataset_index_roundtrip_and_artifacts(tmp_path):
    rna = pd.DataFrame({"case_id": ["A", "B"], "file_name": ["a.tsv", "b.tsv"]})
    slides = pd.DataFrame({"case_id": ["B", "A"], "file_name": ["b.svs", "a.svs"]})
    idx = DatasetIndex.build(rna, slides)
    assert idx.case_ids() == ["A", "B"]
    p = str(tmp_path / "index.json")
    idx.save(p)
    assert DatasetIndex.load(p).cases == idx.cases
    write_case_artifacts(idx, {"A": {"disease_type": "x"}}, str(tmp_path))
    assert (tmp_path / "case_ids.txt").read_text().split() == ["A", "B"]
    assert json.loads((tmp_path / "metainfos.json").read_text())["A"] == {
        "disease_type": "x"}
    assert (tmp_path / "slides_info.parquet").exists()


# ------------------------------------------------------------------- tiles
def test_otsu_threshold_separates_bimodal(rng):
    g = np.concatenate([rng.normal(0.2, 0.02, 5000),
                        rng.normal(0.8, 0.02, 5000)])
    t = otsu_threshold(g)
    # any split strictly between the modes is an Otsu optimum (the
    # between-class variance is flat across the empty-bin plateau)
    assert 0.25 < t < 0.75


def test_otsu_mask_marks_dark_tissue(rng):
    img = np.full((64, 64, 3), 240, np.uint8)      # white background
    img[16:48, 16:48] = 100                        # dark tissue block
    mask = otsu_mask(img)
    assert mask[32, 32] == 1 and mask[0, 0] == 0
    frac = mask.mean()
    assert 0.2 < frac < 0.3                        # 32x32 of 64x64 = 0.25


def test_extract_tiles_fraction_filter():
    mask = np.zeros((100, 100), np.uint8)
    mask[:50, :50] = 1                             # tissue in top-left quadrant
    tiles = extract_tiles(mask, full_dims=(100, 100), tile_size=50,
                          background_thresh=0.8)
    assert (0, 0, 50, 50) in tiles                 # 100% tissue
    assert (50, 0, 50, 50) not in tiles            # 0% tissue
    # 20% threshold boundary: a tile with exactly 25% tissue passes
    mask2 = np.zeros((100, 100), np.uint8)
    mask2[:25, :50] = 1
    tiles2 = extract_tiles(mask2, (100, 100), 50, 0.8)
    assert (0, 0, 50, 50) in tiles2


def test_extract_tiles_downscaled_mask_matches_fullres():
    rng = np.random.RandomState(0)
    mask_full = (rng.rand(128, 128) < 0.5).astype(np.uint8)
    # 2x downscaled mask by max-pooling
    small = mask_full.reshape(64, 2, 64, 2).max(axis=(1, 3))
    t_full = extract_tiles(mask_full, (128, 128), 32, 0.8)
    t_small = extract_tiles(small, (128, 128), 32, 0.8)
    # same grid; near-identical keep decisions on random masks
    assert len(set(t_full) & set(t_small)) >= int(0.8 * len(t_full))


def test_valid_patches_roundtrip(tmp_path):
    img = np.full((64, 64, 3), 245, np.uint8)
    img[:32, :32] = 90
    vp = {"caseA": valid_patches_for_slide(img, (64, 64), tile_sizes=(32, 16))}
    path = str(tmp_path / "valid_patches.json")
    save_valid_patches(vp, path)
    loaded = load_valid_patches(path)
    assert loaded["caseA"][32] == [tuple(t) for t in vp["caseA"][32]]
    tiles = tiles_from_array(img, loaded["caseA"][32], 32)
    assert tiles.shape[1:] == (32, 32, 3)


# ------------------------------------------------------------ descriptions
def test_format_metadata_prunes_and_flattens():
    md = {
        "case_id": "drop", "submitter_id": "drop", "project": "drop",
        "samples": ["drop"],
        "disease_type": "Adenomas",
        "demographic": {"gender": "female", "demographic_id": "drop",
                        "days_to_birth": -100, "vital_status": None},
        "diagnoses": [{"x": 1}, {"y": 2}],
    }
    s = format_metadata(md)
    assert "drop" not in s
    assert "disease_type: Adenomas" in s
    assert "gender: female" in s
    assert "days_to_birth" not in s and "vital_status" not in s


def test_parse_generation_marker_semantics():
    gen = f"prompt echo {DESCRIPTION_MARKER} more {DESCRIPTION_MARKER} The real text."
    assert parse_generation(gen) == "The real text."
    # marker only appears once (echoed from prompt) -> last line fallback
    gen2 = f"prompt {DESCRIPTION_MARKER} echo\nThe last line."
    assert parse_generation(gen2) == "The last line."


def test_generate_descriptions_roundtrip(tmp_path):
    metainfos = {"A": {"disease_type": "X", "primary_site": "Lung"}, "B": None}

    def fake_llm(system_prompt, metadata_str):
        assert DESCRIPTION_MARKER in system_prompt
        assert "disease_type: X" in metadata_str
        return (f"sys {DESCRIPTION_MARKER} echo {DESCRIPTION_MARKER} "
                "A lung specimen description.")

    out_path = str(tmp_path / "descriptions.json")
    out = generate_descriptions(fake_llm, metainfos, out_path=out_path)
    assert out == {"A": "A lung specimen description.", "B": ""}
    assert json.loads(open(out_path).read()) == out


# ---------------------------------------------------------------- pipeline
def test_ingest_pipeline_end_to_end(tmp_path, rng):
    slide_dir = tmp_path / "slides"
    slide_dir.mkdir()

    def download(case_id):
        if case_id == "bad":
            return None
        p = slide_dir / f"{case_id}.bin"
        p.write_bytes(b"x")
        return str(p)

    def tile(case_id, path):
        if case_id == "explode":
            raise ValueError("corrupt slide")
        return rng.rand(4, 8, 8, 3).astype(np.float32)

    def embed(tiles):
        if tiles.ndim != 4:
            raise ValueError("bad tiles")
        return tiles.reshape(tiles.shape[0], -1)[:, :6]

    out_dir = str(tmp_path / "cache")
    pipe = IngestPipeline(download, tile, embed, out_dir,
                          max_download_workers=2, max_in_flight=3)
    results = pipe.run(["c1", "c2", "bad", "explode", "c3"])
    by_case = {r.case_id: r for r in results}
    assert by_case["c1"].status == "ok" and by_case["c1"].n_patches == 4
    assert by_case["bad"].status == "download_failed"
    assert by_case["explode"].status == "error"
    assert np.load(os.path.join(out_dir, "c2.npy")).shape == (4, 6)
    # slides deleted after embedding; failed tile files may remain
    assert not (slide_dir / "c1.bin").exists()

    # idempotent rerun skips cached cases
    results2 = pipe.run(["c1", "c2"])
    assert {r.status for r in results2} == {"skipped"}

    info_path = str(tmp_path / "tiles_info.json")
    pipe.write_tiles_info(info_path)
    assert json.loads(open(info_path).read())["c1"] == 4


def test_download_failure_leaves_no_partial_file(tmp_path):
    """A mid-stream drop must not leave a truncated file that idempotent
    re-runs would treat as complete."""
    from gemm_gan_tpu_torch.data.gdc import GDCClient

    class DropSession:
        def get(self, url, stream=True, timeout=None):
            class R:
                def __enter__(self):
                    return self

                def __exit__(self, *a):
                    return False

                def raise_for_status(self):
                    pass

                def iter_content(self, chunk_size):
                    yield b"partial"
                    raise ConnectionError("dropped")
            return R()

    client = GDCClient(session=DropSession(), retries=2, backoff=0.0)
    dest = str(tmp_path / "f.tsv")
    assert client.download_file("fid", dest) is False
    assert not os.path.exists(dest)
    assert not os.path.exists(dest + ".part")


# ------------------------------------------------- the copies against JAX's
def test_host_copies_compute_what_the_jax_modules_compute(tmp_path):
    from gemm_gan_tpu.data import descriptions as jdesc
    from gemm_gan_tpu.data import gdc as jgdc
    from gemm_gan_tpu.data import tiles as jtiles
    from gemm_gan_tpu_torch.data import descriptions as tdesc
    from gemm_gan_tpu_torch.data import gdc as tgdc
    from gemm_gan_tpu_torch.data import tiles as ttiles

    rng = np.random.RandomState(3)
    thumb = (rng.rand(40, 60, 3) * 255).astype(np.uint8)
    thumb[10:30, 15:45] //= 3  # darker tissue
    for size in (64, 128):
        assert ttiles.extract_tiles(ttiles.otsu_mask(thumb), (600, 400), size) == \
            jtiles.extract_tiles(jtiles.otsu_mask(thumb), (600, 400), size)
    assert ttiles.valid_patches_for_slide(thumb, (600, 400)) == \
        jtiles.valid_patches_for_slide(thumb, (600, 400))
    boxes = ttiles.extract_tiles(ttiles.otsu_mask(thumb), (60, 40), 16)
    np.testing.assert_array_equal(ttiles.tiles_from_array(thumb, boxes, 16),
                                  jtiles.tiles_from_array(thumb, boxes, 16))
    md = {"disease_type": "Adeno", "demographic": {"gender": "f", "submitter_id": "x"},
          "diagnoses": ["a", "b"], "case_id": "c"}
    assert tdesc.format_metadata(md) == jdesc.format_metadata(md)
    assert tdesc.SYSTEM_PROMPT == jdesc.SYSTEM_PROMPT
    tsv = ("# comment\ngene_id\tgene_name\tgene_type\ttpm_unstranded\n"
           + "".join(f"N_{k}\t\t\t0\n" for k in "abcd")
           + "".join(f"g{i}\tG{i}\t{['protein_coding', 'lncRNA'][i % 2]}\t{i * 0.5}\n"
                     for i in range(6)))
    path = tmp_path / "a.tsv"
    path.write_text(tsv)
    pd.testing.assert_series_equal(tgdc.parse_rna_seq_tsv(str(path)),
                                   jgdc.parse_rna_seq_tsv(str(path)))


def test_uni_embed_stage_in_the_pipeline_matches_flax_vit(tmp_path):
    """`cli.ingest`'s embed stage (`uni_embedder`: the port's ViT over
    `batched_apply`, the tail padded) inside `IngestPipeline`, on synthetic
    preprocessed tiles, against `FlaxViT` on the same weights (f32, rtol
    1e-4 / atol 1e-5); the cached files are what `load_tcga` counts."""
    import jax

    from gemm_gan_tpu.encoders.vit import FlaxViT
    from gemm_gan_tpu.encoders.vit import ViTParams as JViTParams
    from gemm_gan_tpu_torch.cli.ingest import uni_embedder
    from gemm_gan_tpu_torch.convert import vit_state_dict_from_flax
    from gemm_gan_tpu_torch.encoders.vit import ViTParams, preprocess_tiles

    dims = dict(img_size=32, patch_size=8, hidden_size=16, num_layers=1, num_heads=2,
                mlp_ratio=2.0)
    params = jax.device_get(FlaxViT(JViTParams(**dims)).init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))["params"])
    embed = uni_embedder(vit_state_dict_from_flax(params), device="cpu", batch_size=4,
                         params=ViTParams(**dims))
    rng = np.random.RandomState(0)
    tiles = {c: preprocess_tiles(rng.randint(0, 256, (n, 40, 40, 3)).astype(np.uint8))
             for c, n in (("c1", 5), ("c2", 3))}
    pipe = IngestPipeline(lambda c: None if c == "gone" else c, lambda c, p: tiles[c], embed,
                          str(tmp_path / "patch_embeddings_uni"), delete_after_embed=False)
    results = {r.case_id: r for r in pipe.run(["c1", "c2", "gone"])}
    assert [results[c].status for c in ("c1", "c2", "gone")] == ["ok", "ok", "download_failed"]
    for c, t in tiles.items():
        want = np.asarray(FlaxViT(JViTParams(**dims)).apply({"params": params}, t))
        got = np.load(tmp_path / "patch_embeddings_uni" / f"{c}.npy")
        assert got.dtype == np.float32 and got.shape == (len(t), 16)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_read_manifest_renames_gdc_columns(tmp_path):
    from gemm_gan_tpu.cli.ingest import read_manifest as jread
    from gemm_gan_tpu_torch.cli.ingest import read_manifest

    path = tmp_path / "m.txt"
    path.write_text("id\tfilename\tmd5\tsize\tstate\nf1\ta.tsv\tx\t1\tok\n")
    pd.testing.assert_frame_equal(read_manifest(str(path)), jread(str(path)))
    assert list(read_manifest(str(path))[["file_id", "file_name"]].iloc[0]) == ["f1", "a.tsv"]


class _FakeTokenizer:
    """Word ids from a hash, CLS first, padded with 0 to max_length."""

    def __call__(self, text, max_length, padding, truncation):
        ids = [3] + [7 + sum(map(ord, w)) % 80 for w in text.split()]
        ids = ids[:max_length]
        pad = max_length - len(ids)
        return {"input_ids": ids + [0] * pad, "attention_mask": [1] * len(ids) + [0] * pad}


def test_preprocess_cli_writes_caches_that_load_tcga_reads(tmp_path, monkeypatch):
    """`cli.preprocess` over descriptions.json: the tokenizer (faked; the
    real one is `transformers.AutoTokenizer`), a tiny HF-layout ModernBERT
    checkpoint with its config.json, the CLS parquet and token caches (the
    first token's row is the CLS row), then `--contrastive_dim`; the
    layout loads with `load_tcga(schema="multi_token")`."""
    import pickle

    import torch
    import transformers

    from gemm_gan_tpu_torch.cli import preprocess
    from gemm_gan_tpu_torch.data.tcga import load_tcga
    from gemm_gan_tpu_torch.encoders.modernbert import ModernBert, ModernBertParams

    d = tmp_path / "tcga"
    d.mkdir()
    rng = np.random.RandomState(0)
    cases = [f"case-{i:02d}" for i in range(12)]
    pd.DataFrame(rng.rand(12, 30) * 8, index=pd.Index(cases, name="case_id"),
                 columns=[f"ENSG{i:05d}" for i in range(30)]).to_parquet(d / "rna_seq.parquet")
    (d / "patch_embeddings_uni").mkdir()
    for c in cases:
        np.save(d / "patch_embeddings_uni" / f"{c}.npy", rng.randn(4, 16).astype(np.float32))
    with open(d / "metainfos.pkl", "wb") as f:
        pickle.dump({c: {"disease_type": "AB"[i % 2], "primary_site": "XY"[i % 2]}
                     for i, c in enumerate(cases)}, f)
    (d / "descriptions.json").write_text(json.dumps(
        {c: " ".join(f"word{j}" for j in range(2 + i)) for i, c in enumerate(cases)}))
    ckpt = tmp_path / "bert"
    ckpt.mkdir()
    dims = dict(vocab_size=96, hidden_size=16, intermediate_size=24, num_layers=2,
                num_heads=2, global_every=2, local_window=4)
    model = ModernBert(ModernBertParams(**dims), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    torch.save({"model." + k: v for k, v in model.state_dict().items()},
               ckpt / "pytorch_model.bin")
    (ckpt / "config.json").write_text(json.dumps({
        "vocab_size": 96, "hidden_size": 16, "intermediate_size": 24, "num_hidden_layers": 2,
        "num_attention_heads": 2, "global_attn_every_n_layers": 2, "local_attention": 4,
        "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "norm_eps": 1e-5}))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, name: _FakeTokenizer()))
    preprocess.main(["--data_dir", str(d), "--modernbert", str(ckpt), "--max_length", "10",
                     "--batch_size", "4", "--contrastive_dim", "4",
                     "--contrastive_epochs", "2", "--device", "cpu"])
    cls = pd.read_parquet(d / "clinical_modernbert_embeddings.parquet")
    assert cls.shape == (12, 16)
    tok = np.load(d / "clinical_modernbert_embeddings" / "case-03.npy")
    mask = np.load(d / "clinical_modernbert_embeddings" / "case-03_attention_mask.npy")
    assert tok.shape == (10, 16) and mask.dtype == bool and mask.sum() == 1 + 5
    np.testing.assert_array_equal(cls.loc["case-03"].to_numpy(), tok[0])
    with torch.no_grad():
        ids = torch.tensor([_FakeTokenizer()("word0 word1 word2 word3 word4", 10, "", True)
                            ["input_ids"]])
        want = model(ids, ids != 0)[0].numpy()
    np.testing.assert_allclose(tok, want, rtol=1e-5, atol=1e-6)
    assert np.load(d / "text_embeddings_contrastive_4" / "case-03.npy").shape == (10, 4)
    assert pd.read_parquet(d / "embeddings_contrastive.parquet").shape == (12, 4)
    splits = load_tcga(str(d), schema="multi_token", num_patches=4, max_tokens=10)
    n = sum(len(splits[s]["genes"]) for s in ("train", "val", "test"))
    assert n == 12 and splits["train"]["tokens"].shape[1:] == (10, 16)
    assert splits["train"]["patches"].shape[1:] == (4, 16)
