"""Device-resident vector index with metadata filtering: the port of
vision_compression_project_tpu/index/vector_index.py.

Embedding rows live in a device buffer whose capacity doubles as it fills;
doc_id filtering is a mask that the scoring kernel applies
(ops/topk.py, kernels/masked_similarity.cu), so a filtered query costs one
masked matrix-vector product and a top-k on the device. Saved indexes use the
JAX package's files (`rows.npz`, `metadata.json`), so either package loads
what the other saved.

`search_sharded` spreads the rows over the mesh `data` dimension: each rank
keeps its shard of the rows, padded to a shard multiple, scores and ranks it
locally (K2 on the card) and merges k candidates a shard with the other
ranks (parallel/collectives.py). Every rank holds the same index (the same
adds in the same order) and calls `search_sharded` with the same queries, as
every process of the reference runs the same program.
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
from ..parallel.collectives import sharded_cosine_topk
from ..parallel.mesh import AXIS_DATA, axis_size

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
        # Sharded-search residency: this rank's shard of the padded rows and
        # of each doc's mask, written incrementally by `add`; rebuilt whole
        # only on first use, another shard layout or capacity growth, which
        # `shard_rebuilds` counts (the reference's counter).
        self._shard_rows: Optional[torch.Tensor] = None
        self._shard_key = None
        self._shard_lo = 0
        self._shard_masks: Dict[Optional[str], torch.Tensor] = {}
        self.shard_rebuilds = 0
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
        # The shard copies are sized to the old capacity: the next sharded
        # search rebuilds them.
        self._shard_rows, self._shard_key = None, None
        self._shard_masks.clear()

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
            new = torch.from_numpy(embeddings).to(self.device, self.dtype)
            self._rows[start : start + n] = new
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
            if self._shard_rows is not None:
                self._add_to_shard(new, start, new_rows_by_doc)
            return ids

    def _add_to_shard(self, new: torch.Tensor, start: int, new_rows_by_doc: Dict[str, List[int]]) -> None:
        """Write the added rows that fall in this rank's shard into the
        shard copies: O(added), never a re-upload of the shard."""
        lo, per = self._shard_lo, self._shard_rows.shape[0]
        a, b = max(start, lo), min(start + new.shape[0], lo + per)
        if a >= b:
            return
        self._shard_rows[a - lo : b - lo] = new[a - start : b - start]
        for doc, mask in self._shard_masks.items():
            if doc is None:
                mask[a - lo : b - lo] = 1.0
            elif doc in new_rows_by_doc:
                rows = [r - lo for r in new_rows_by_doc[doc] if a <= r < b]
                mask[torch.as_tensor(rows, dtype=torch.long, device=self.device)] = 1.0

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
                # Masked-out filler (the doc has fewer than k rows) and shard padding.
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

    def _sharded_rows_mask(self, mesh, doc_id: Optional[str]):
        """This rank's shard of the rows and of doc_id's mask, the rows padded
        to a multiple of the mesh's `data` dimension; rebuilt only when the
        shard's place (the `data` dimension's size and this rank's
        coordinate on it) or the padded capacity changed. Not keyed on the
        mesh object: a new mesh may reuse a freed one's id()."""
        cap = self.capacity
        n_shards = axis_size(mesh, AXIS_DATA)
        pad = (-cap) % n_shards
        per = (cap + pad) // n_shards
        rank = mesh.get_local_rank(AXIS_DATA)
        key = (n_shards, rank, cap + pad)
        if self._shard_key != key:
            # A copy: `add` writes the rows in place, into both buffers.
            self._shard_lo = rank * per
            self._shard_rows = F.pad(self._rows, (0, 0, 0, pad))[self._shard_lo : self._shard_lo + per].clone()
            self._shard_key = key
            self._shard_masks.clear()
            self.shard_rebuilds += 1
        if doc_id not in self._shard_masks:
            mask = F.pad(self._mask_for(doc_id), (0, pad))
            self._shard_masks[doc_id] = mask[self._shard_lo : self._shard_lo + per].clone()
        return self._shard_rows, self._shard_masks[doc_id]

    def search_sharded(
        self, mesh, query_embeddings: np.ndarray, top_k: int = 8, doc_id: Optional[str] = None
    ) -> List[List[Dict]]:
        """Masked cosine top-k with the rows sharded over the mesh `data`
        dimension: a masked similarity and top-k on this rank's shard, then
        the k candidates of every shard merged (never a gather of the
        scores). The same results as `search`, on every rank; every rank of
        the mesh must make the same call."""
        queries = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        with self._lock:
            if self.count == 0:
                return [[] for _ in range(queries.shape[0])]
            k = min(top_k, self.count)
            rows, mask = self._sharded_rows_mask(mesh, doc_id)
            vals, idx = sharded_cosine_topk(mesh, rows, mask, torch.from_numpy(queries).to(self.device), k)
            return self._results_from(vals.cpu().numpy(), idx.cpu().numpy())

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
