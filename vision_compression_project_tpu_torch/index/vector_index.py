"""Device-resident vector index with metadata filtering: the port of
vision_compression_project_tpu/index/vector_index.py (the single-buffer
index; the sharded search is not ported yet).

Embedding rows live in a device buffer whose capacity doubles as it fills;
doc_id filtering is a mask that the scoring kernel applies
(ops/topk.py, kernels/masked_similarity.cu), so a filtered query costs one
masked matrix-vector product and a top-k on the device. Saved indexes use the
JAX package's files (`rows.npz`, `metadata.json`), so either package loads
what the other saved.
"""

from __future__ import annotations

import json
import secrets
import string
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.topk import cosine_topk

_ALPHABET = string.ascii_letters + string.digits


def _new_memory_id() -> str:
    """Opaque 22-char alphanumeric id (the surface shape of the reference's
    cloud memory ids, e.g. 'ZfqKQ1TkCeDRDKJyuNQk47')."""
    return "".join(secrets.choice(_ALPHABET) for _ in range(22))


class VectorIndex:
    """Single-buffer index on `device` ("cuda" unless the caller asks for
    "cpu"). `add`, `search` and `save` may be called from several threads
    (the HTTP server's /ingest beside /chat): one lock keeps the rows, the
    count, the cached masks and the metadata still for each call, since
    `add` writes the rows and cached masks in place."""

    def __init__(
        self,
        dim: int,
        capacity: int = 1024,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VectorIndex: device 'cuda' asked for, but no CUDA device is available")
        self.dim = dim
        self.dtype = dtype
        self._rows = torch.zeros((capacity, dim), dtype=dtype, device=self.device)
        self.count = 0
        self.metadata: List[Dict] = []  # row -> record
        self._doc_rows: Dict[str, List[int]] = {}
        self._mask_cache: Dict[Optional[str], torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._rows.shape[0]

    # -- mutation -----------------------------------------------------------

    def _ensure_capacity(self, extra: int) -> None:
        cap = self.capacity
        needed = self.count + extra
        if needed <= cap:
            return
        new_cap = cap
        while new_cap < needed:
            new_cap *= 2
        self._rows = F.pad(self._rows, (0, 0, 0, new_cap - cap))
        # Cached masks grow with zeros (masked out). F.pad allocates a new
        # tensor, so no cached mask is a view of a buffer that is replaced.
        self._mask_cache = {doc: F.pad(m, (0, new_cap - cap)) for doc, m in self._mask_cache.items()}

    def add(
        self,
        embeddings: np.ndarray,
        records: Sequence[Dict],
        memory_ids: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """Append unit-norm embedding rows with their metadata records.

        Each record should carry at least {'doc_id', 'page', 'content'};
        extra keys (summary, entities, source_file) ride along untouched.
        """
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"embeddings of shape {embeddings.shape}, expected (n, {self.dim})")
        n = embeddings.shape[0]
        if len(records) != n:
            raise ValueError(f"{len(records)} records for {n} rows")
        if memory_ids is None:
            memory_ids = [_new_memory_id() for _ in range(n)]
        with self._lock:
            self._ensure_capacity(n)
            start = self.count
            # In place: the JAX package donates the buffer to dynamic_update_slice
            # for the same O(n) append.
            self._rows[start : start + n] = torch.from_numpy(embeddings).to(self.device, self.dtype)
            ids = []
            new_rows_by_doc: Dict[str, List[int]] = {}
            for i, (record, mem_id) in enumerate(zip(records, memory_ids)):
                row = start + i
                rec = dict(record)
                rec["memory_id"] = mem_id
                self.metadata.append(rec)
                doc = rec.get("doc_id")
                if doc is not None:
                    self._doc_rows.setdefault(doc, []).append(row)
                    new_rows_by_doc.setdefault(doc, []).append(row)
                ids.append(mem_id)
            self.count += n
            # Cached masks are updated in place for the added rows only.
            for doc, mask in self._mask_cache.items():
                if doc is None:
                    mask[start : start + n] = 1.0
                elif doc in new_rows_by_doc:
                    mask[torch.as_tensor(new_rows_by_doc[doc], device=self.device)] = 1.0
            return ids

    # -- query --------------------------------------------------------------

    def _mask_for(self, doc_id: Optional[str]) -> torch.Tensor:
        if doc_id in self._mask_cache:
            return self._mask_cache[doc_id]
        mask = np.zeros((self.capacity,), np.float32)
        if doc_id is None:
            mask[: self.count] = 1.0
        else:
            mask[self._doc_rows.get(doc_id, [])] = 1.0
        device_mask = torch.from_numpy(mask).to(self.device)
        self._mask_cache[doc_id] = device_mask
        return device_mask

    def search(
        self, query_embeddings: np.ndarray, top_k: int = 8, doc_id: Optional[str] = None
    ) -> List[List[Dict]]:
        """Masked cosine top-k. Returns, per query, result dicts shaped like
        the reference's search results: {'id', 'content', 'metadata', 'score'}."""
        queries = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        with self._lock:
            if self.count == 0:
                return [[] for _ in range(queries.shape[0])]
            k = min(top_k, self.count)
            mask = self._mask_for(doc_id)
            vals, idx = cosine_topk(self._rows, torch.from_numpy(queries).to(self.device), mask, k)
            return self._results_from(vals.cpu().numpy(), idx.cpu().numpy())

    def _results_from(self, vals: np.ndarray, idx: np.ndarray) -> List[List[Dict]]:
        """(Q, k) scores/rows -> per-query result dicts
        {'id', 'content', 'metadata', 'score'}."""
        out: List[List[Dict]] = []
        for qi in range(vals.shape[0]):
            results = []
            for score, row in zip(vals[qi], idx[qi]):
                # Masked-out filler (the doc has fewer than k rows).
                if score <= -1e29 or int(row) >= self.count:
                    continue
                rec = self.metadata[int(row)]
                results.append(
                    {
                        "id": rec["memory_id"],
                        "content": rec.get("content", ""),
                        "metadata": {k: rec[k] for k in rec if k not in ("memory_id", "content")},
                        "score": float(score),
                    }
                )
            out.append(results)
        return out

    # -- persistence --------------------------------------------------------

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with self._lock:
            rows = self._rows[: self.count].to(torch.float32).cpu().numpy()
            metadata = json.dumps({"dim": self.dim, "metadata": self.metadata}, ensure_ascii=False)
        np.savez_compressed(path / "rows.npz", rows=rows)
        (path / "metadata.json").write_text(metadata)

    @classmethod
    def load(
        cls, path, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
    ) -> "VectorIndex":
        path = Path(path)
        meta = json.loads((path / "metadata.json").read_text())
        with np.load(path / "rows.npz") as data:
            rows = data["rows"]
        index = cls(dim=meta["dim"], capacity=max(1024, rows.shape[0]), dtype=dtype, device=device)
        if rows.shape[0]:
            index.add(
                rows,
                [{k: v for k, v in rec.items() if k != "memory_id"} for rec in meta["metadata"]],
                memory_ids=[rec["memory_id"] for rec in meta["metadata"]],
            )
        return index
