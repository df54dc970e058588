"""Streaming ingest pipeline: download -> tile -> embed, bounded concurrency.

Capability parity with the reference's 3-stage producer/consumer pipeline
(the reference's src/download_and_preprocess_data.py:49-231: thread pools +
two queues + stop Event + three Locks, slide deleted after embedding,
idempotent re-runs via existence checks, per-case failure tolerance).

Redesign notes: stages are injected callables wired through
`concurrent.futures` with a bounded in-flight window — downloads and tiling
overlap, while embedding stays a single serialized consumer because the
encoder is one device-side program (no model lock needed: one submitter).
Each case is independently fault-isolated and the pipeline reports per-case
status instead of best-effort logging.

A copy of `gemm_gan_tpu/data/ingest.py` (host code: numpy, pandas and the
standard library; optional imports stay lazy), kept here so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CaseResult:
    case_id: str
    status: str            # "ok" | "skipped" | "download_failed" | "error"
    n_patches: int = 0
    error: Optional[str] = None


class IngestPipeline:
    """download_fn(case_id) -> local path | None
    tile_fn(case_id, path) -> tiles [N, S, S, 3] uint8/float
    embed_fn(tiles) -> embeddings [N, E]   (serialized; the device consumer)
    """

    def __init__(self, download_fn: Callable, tile_fn: Callable,
                 embed_fn: Callable, out_dir: str,
                 max_download_workers: int = 4, max_in_flight: int = 8,
                 delete_after_embed: bool = True):
        self.download_fn = download_fn
        self.tile_fn = tile_fn
        self.embed_fn = embed_fn
        self.out_dir = out_dir
        self.max_download_workers = max_download_workers
        self.max_in_flight = max_in_flight
        self.delete_after_embed = delete_after_embed
        self._tiles_info: Dict[str, int] = {}
        self._tiles_lock = threading.Lock()

    def _out_path(self, case_id: str) -> str:
        return os.path.join(self.out_dir, f"{case_id}.npy")

    def _stage_host(self, case_id: str):
        """Download + tile on a worker thread (I/O + CPU bound). Exceptions
        are captured per case — one corrupt slide must not kill the run."""
        path = None
        try:
            path = self.download_fn(case_id)
            if path is None:
                return case_id, None, None, None
            tiles = self.tile_fn(case_id, path)
            return case_id, path, tiles, None
        except Exception as e:  # noqa: BLE001 — per-case isolation
            return case_id, path, None, str(e)

    def run(self, case_ids: Sequence[str]) -> List[CaseResult]:
        os.makedirs(self.out_dir, exist_ok=True)
        results: List[CaseResult] = []
        todo = [c for c in case_ids]
        pending: set = set()

        def drain(done_futs):
            for fut in done_futs:
                case_id, path, tiles, host_err = fut.result()
                if host_err is not None:
                    results.append(CaseResult(case_id, "error", error=host_err))
                    if self.delete_after_embed and path and os.path.exists(path):
                        os.remove(path)
                    continue
                if tiles is None:
                    results.append(CaseResult(case_id, "download_failed"))
                    continue
                try:
                    emb = np.asarray(self.embed_fn(tiles))
                    np.save(self._out_path(case_id), emb.astype(np.float32))
                    with self._tiles_lock:
                        self._tiles_info[case_id] = int(emb.shape[0])
                    results.append(CaseResult(case_id, "ok", int(emb.shape[0])))
                except Exception as e:  # noqa: BLE001 — per-case isolation
                    results.append(CaseResult(case_id, "error", error=str(e)))
                finally:
                    if self.delete_after_embed and path and os.path.exists(path):
                        os.remove(path)

        with ThreadPoolExecutor(max_workers=self.max_download_workers) as ex:
            it = iter(todo)
            exhausted = False
            while not exhausted or pending:
                while not exhausted and len(pending) < self.max_in_flight:
                    try:
                        case_id = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    if os.path.exists(self._out_path(case_id)):
                        results.append(CaseResult(case_id, "skipped"))
                        continue
                    pending.add(ex.submit(self._stage_host, case_id))
                if pending:
                    done, pending = wait(pending, return_when=FIRST_COMPLETED)
                    drain(done)  # embed serialized on this thread
        return results

    def write_tiles_info(self, path: str):
        with open(path, "w") as f:
            json.dump(self._tiles_info, f, indent=2)
