"""GDC (Genomic Data Commons) ingest: REST client, cohort selection, matrix build.

Capability parity with the reference's L0 layer
(the reference's src/dataset/utils.py, src/dataset/download_data.py):
manifest -> file->case mapping (batched 100/request), clinical metadata
fetch, dedup to one primary-tumor RNA-seq file and one slide per case with
bottom-section preference, TSV -> protein-coding TPM log2(x+1) matrix.

Redesign notes (vs the reference):
  * one `GDCClient` with an injectable `session` (tests run with a fake
    transport; this container has zero egress);
  * cohort selection is pure-functional over pandas frames — no in-place
    pickle mutation; the dataset index is JSON, with list of deletions
    *returned* to the caller instead of files silently removed;
  * retries with exponential backoff on the client, not per call site.

A copy of `gemm_gan_tpu/data/gdc.py` (host code: numpy, pandas and the
standard library; optional imports stay lazy), kept here so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import pandas as pd

GDC_API = "https://api.gdc.cancer.gov"
_BATCH = 100  # GDC caps list filters at 100 values per request

CASE_FIELDS_TO_SAVE = ("case_id", "submitter_id", "project", "disease_type",
                       "primary_site", "demographic", "diagnoses", "samples")


class GDCClient:
    """Minimal GDC REST client. `session` must expose requests-like
    `get(url, stream, timeout)` / `post(url, json=..., timeout=...)`."""

    def __init__(self, session=None, base_url: str = GDC_API, retries: int = 3,
                 backoff: float = 1.0, timeout: float = 60.0):
        if session is None:
            import requests

            session = requests.Session()
        self.session = session
        self.base_url = base_url.rstrip("/")
        self.retries = retries
        self.backoff = backoff
        self.timeout = timeout

    # ------------------------------------------------------------- transport
    def _post(self, endpoint: str, payload: dict) -> dict:
        url = f"{self.base_url}/{endpoint}"
        err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                r = self.session.post(url, json=payload, timeout=self.timeout)
                r.raise_for_status()
                return r.json()
            except Exception as e:  # noqa: BLE001 — retry any transport error
                err = e
                if attempt + 1 < self.retries:
                    time.sleep(self.backoff * (2 ** attempt))
        raise RuntimeError(f"GDC POST {endpoint} failed after "
                           f"{self.retries} attempts: {err}")

    def download_file(self, file_id: str, output_path: str) -> bool:
        """Stream one file to disk; False on persistent failure (per-file
        failures are tolerated upstream, reference download_data.py:91-96).

        Streams into `<path>.part` and renames on success so a mid-stream
        drop never leaves a truncated file that idempotent re-runs (which
        check `os.path.exists`) would treat as complete.
        """
        url = f"{self.base_url}/data/{file_id}"
        tmp_path = output_path + ".part"
        for attempt in range(self.retries):
            try:
                with self.session.get(url, stream=True,
                                      timeout=self.timeout) as r:
                    r.raise_for_status()
                    with open(tmp_path, "wb") as f:
                        for chunk in r.iter_content(chunk_size=1 << 20):
                            f.write(chunk)
                os.replace(tmp_path, output_path)
                return True
            except Exception:  # noqa: BLE001
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
                if attempt + 1 < self.retries:
                    time.sleep(self.backoff * (2 ** attempt))
        return False

    # ------------------------------------------------------------- endpoints
    def _hits_batched(self, endpoint: str, field: str, values: Sequence[str],
                      fields: Sequence[str]) -> List[dict]:
        hits: List[dict] = []
        for start in range(0, len(values), _BATCH):
            batch = list(values[start:start + _BATCH])
            payload = {
                "filters": {"op": "in",
                            "content": {"field": field, "value": batch}},
                "fields": ",".join(fields),
                "format": "JSON",
                "size": _BATCH,
            }
            data = self._post(endpoint, payload)
            hits.extend(data.get("data", {}).get("hits", []))
        return hits

    def map_files(self, file_ids: Sequence[str]) -> pd.DataFrame:
        """file_id -> (file_name, submitter_id, case_id, project_id)."""
        hits = self._hits_batched(
            "files", "file_id", file_ids,
            ("file_id", "file_name", "cases.submitter_id", "cases.case_id",
             "cases.project.project_id"))
        rows = [{
            "file_id": h["file_id"],
            "file_name": h["file_name"],
            "submitter_id": h["cases"][0]["submitter_id"],
            "case_id": h["cases"][0]["case_id"],
            "project_id": h["cases"][0]["project"]["project_id"],
        } for h in hits]
        return pd.DataFrame(rows)

    def case_metadata(self, case_ids: Sequence[str]) -> Dict[str, dict]:
        """case_id -> pruned clinical metadata dict (reference keeps
        disease_type, primary_site, demographics, diagnoses, samples;
        dataset/utils.py:113)."""
        out: Dict[str, dict] = {}
        for start in range(0, len(case_ids), _BATCH):
            batch = list(case_ids[start:start + _BATCH])
            payload = {
                "filters": {"op": "in",
                            "content": {"field": "case_id", "value": batch}},
                "expand": "diagnoses,demographic,samples,project",
                "format": "JSON",
                "size": len(batch),
            }
            data = self._post("cases", payload)
            for hit in data.get("data", {}).get("hits", []):
                out[hit["case_id"]] = {f: hit.get(f) for f in CASE_FIELDS_TO_SAVE}
        return out

    def rna_file_entities(self, file_names: Sequence[str]) -> pd.DataFrame:
        hits = self._hits_batched(
            "files", "file_name", file_names,
            ("file_id", "file_name", "cases.submitter_id", "cases.case_id",
             "cases.project.project_id", "cases.samples.tissue_type",
             "cases.samples.tumor_descriptor",
             "cases.samples.portions.submitter_id", "created_datetime"))
        rows = []
        for h in hits:
            case = h["cases"][0]
            sample = case["samples"][0]
            rows.append({
                "file_id": h["file_id"], "file_name": h["file_name"],
                "case_id": case["case_id"],
                "tissue_type": sample["tissue_type"],
                "tumor_descriptor": sample["tumor_descriptor"],
                "portion_submitter_id": sample["portions"][0]["submitter_id"],
                "created_datetime": h["created_datetime"],
            })
        return pd.DataFrame(rows)

    def slide_file_entities(self, file_names: Sequence[str]) -> pd.DataFrame:
        hits = self._hits_batched(
            "files", "file_name", file_names,
            ("file_id", "file_name", "cases.submitter_id", "cases.case_id",
             "cases.samples.tissue_type", "cases.samples.tumor_descriptor",
             "cases.samples.portions.slides.section_location",
             "cases.samples.portions.slides.slide_id",
             "cases.samples.portions.submitter_id", "created_datetime"))
        rows = []
        for h in hits:
            case = h["cases"][0]
            sample = case["samples"][0]
            # slide filename embeds the slide_id: <...>.<slide_id>.svs
            slide_id = h["file_name"].split(".")[1].lower()
            slides = sample["portions"][0].get("slides") or []
            locs = [s.get("section_location") for s in slides
                    if s.get("slide_id") == slide_id]
            rows.append({
                "file_id": h["file_id"], "file_name": h["file_name"],
                "case_id": case["case_id"],
                "tissue_type": sample["tissue_type"],
                "tumor_descriptor": sample["tumor_descriptor"],
                "section_location": locs[0] if locs else "UNKNOWN",
                "portion_submitter_id": sample["portions"][0]["submitter_id"],
                "created_datetime": h["created_datetime"],
            })
        return pd.DataFrame(rows)


# ------------------------------------------------------- cohort selection
def select_rna_seq_files(entities: pd.DataFrame) -> pd.DataFrame:
    """One RNA-seq file per case: most recent, primary tumor, non-normal
    (reference dataset/utils.py:205-211). Returns the kept rows."""
    df = entities.copy()
    df["created_datetime"] = pd.to_datetime(df["created_datetime"])
    df = df.sort_values(["case_id", "created_datetime"],
                        ascending=[True, False])
    df = df.drop_duplicates(subset="case_id", keep="first")
    keep = (df["tissue_type"] != "Normal") & (df["tumor_descriptor"] == "Primary")
    return df[keep].reset_index(drop=True)


def select_tissue_slides(entities: pd.DataFrame,
                         valid_portions: Iterable[str]) -> pd.DataFrame:
    """One slide per case: restrict to RNA-matched portions, prefer the most
    recent BOTTOM section (lexicographic BOTTOM<TOP<UNKNOWN gives the
    reference's bottom-slide preference, dataset/utils.py:325-332), primary
    tumor, non-normal."""
    df = entities[entities["portion_submitter_id"].isin(set(valid_portions))].copy()
    df["created_datetime"] = pd.to_datetime(df["created_datetime"])
    df = df.sort_values(["case_id", "section_location", "created_datetime"],
                        ascending=[True, True, False])
    df = df.drop_duplicates(subset="case_id", keep="first")
    keep = (df["tissue_type"] != "Normal") & (df["tumor_descriptor"] == "Primary")
    return df[keep].reset_index(drop=True)


# --------------------------------------------------------- dataset index
@dataclasses.dataclass
class DatasetIndex:
    """case_id -> selected file names. JSON on disk (the reference mutates a
    pickle in place with .bak backups, dataset/utils.py:222-233)."""

    cases: Dict[str, Dict[str, str]]

    @classmethod
    def build(cls, rna_df: pd.DataFrame, slide_df: pd.DataFrame) -> "DatasetIndex":
        rna = dict(zip(rna_df["case_id"], rna_df["file_name"]))
        slides = dict(zip(slide_df["case_id"], slide_df["file_name"]))
        cases = {c: {"rna_seq_file": rna[c], "tissue_file": slides[c]}
                 for c in sorted(set(rna) & set(slides))}
        return cls(cases)

    def case_ids(self) -> List[str]:
        return sorted(self.cases)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"version": 1, "cases": self.cases}, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "DatasetIndex":
        with open(path) as f:
            return cls(json.load(f)["cases"])


# ------------------------------------------------------ expression matrix
def parse_rna_seq_tsv(path: str) -> pd.Series:
    """One GDC STAR-counts TSV -> protein-coding TPM series indexed by
    gene_id (reference dataset/utils.py:393-401: skip the 4 summary rows,
    keep gene_type=='protein_coding', take tpm_unstranded)."""
    df = pd.read_csv(path, sep="\t", header=1)
    df = df.iloc[4:]
    df = df[df["gene_type"] == "protein_coding"]
    return df.set_index("gene_id")["tpm_unstranded"].astype(np.float64)


def build_expression_matrix(index: DatasetIndex, rna_dir: str,
                            output_path: Optional[str] = None,
                            log_transform: bool = True) -> pd.DataFrame:
    """Samples x genes matrix with optional log2(x+1), written to parquet."""
    cols = {}
    for case_id in index.case_ids():
        path = os.path.join(rna_dir, index.cases[case_id]["rna_seq_file"])
        if not os.path.exists(path):
            continue
        cols[case_id] = parse_rna_seq_tsv(path)
    mat = pd.DataFrame(cols).T  # samples x genes
    if log_transform:
        mat = np.log2(mat + 1.0)
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        mat.to_parquet(output_path)
    return mat


def write_case_artifacts(index: DatasetIndex, metainfos: Dict[str, dict],
                         out_dir: str):
    """case_ids.txt + metainfos.json + slide mapping parquet (reference
    writes case_ids.txt, metainfos.pkl, slides_info.parquet)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "case_ids.txt"), "w") as f:
        f.write("\n".join(index.case_ids()) + "\n")
    with open(os.path.join(out_dir, "metainfos.json"), "w") as f:
        json.dump(metainfos, f, indent=2)
    pd.DataFrame({
        "case_id": index.case_ids(),
        "file_name": [index.cases[c]["tissue_file"] for c in index.case_ids()],
    }).to_parquet(os.path.join(out_dir, "slides_info.parquet"))


def download_many(client: GDCClient, files_df: pd.DataFrame, out_dir: str,
                  max_workers: int = 5, skip_existing: bool = True) -> Dict[str, bool]:
    """Thread-pooled downloads with idempotent re-runs (reference
    download_data.py:52-66 + existence checks :91,141)."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(out_dir, exist_ok=True)

    def one(row):
        dest = os.path.join(out_dir, row.file_name)
        if skip_existing and os.path.exists(dest):
            return row.file_name, True
        return row.file_name, client.download_file(row.file_id, dest)

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = dict(ex.map(one, files_df.itertuples()))
    return results
