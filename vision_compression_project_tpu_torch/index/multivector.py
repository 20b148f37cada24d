"""Multi-vector page index with late-interaction (MaxSim) scoring: the port
of vision_compression_project_tpu/index/multivector.py.

Each page is up to K vectors (the pooled page and its sentences) instead of
one, and a query set {q_j} scores a page as sum_j max_k <q_j, v_k>. Scoring
is one f32 product over the device-resident (N, K, D) rows, masked max and
sum reductions and the doc mask, then the top-k in the reference's order
(`ops.topk.topk_lowest_first`). The reference does this outside any Pallas
kernel, so it is plain tensor code here too. Saved indexes use the
reference's files (`mv_rows.npz`, `mv_metadata.json`), so either package
loads what the other saved.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.topk import NEG_INF, full_f32_matmul, topk_lowest_first
from .vector_index import _new_memory_id


def maxsim_scores(
    rows: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, doc_mask: torch.Tensor
) -> torch.Tensor:
    """rows (N, K, D), valid (N, K) bool, queries (Q, D), doc_mask (N,) ->
    (N,) f32 scores sum_q max_k <q, v_k> over the valid slots, NEG_INF where
    doc_mask is not positive."""
    with full_f32_matmul():
        sims = torch.einsum("nkd,qd->nkq", rows.to(torch.float32), queries.to(torch.float32))
    neg = torch.tensor(NEG_INF, device=sims.device)
    sims = torch.where(valid[:, :, None], sims, neg)
    scores = sims.amax(dim=1).sum(dim=1)
    return torch.where(doc_mask > 0, scores, neg)


def maxsim_topk(
    rows: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, doc_mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (k,), indices (k,)) of the MaxSim scores, equal scores with
    the lower row first, as the reference's `_maxsim_topk`."""
    return topk_lowest_first(maxsim_scores(rows, valid, queries, doc_mask), k)


class MultiVectorIndex:
    """Device-resident (capacity, vecs_per_page, dim) index on `device`
    ("cuda" unless the caller asks for "cpu"), with VectorIndex's record and
    result surface: `add` takes a vector set per page, `search` one query
    set and returns one ranked list whose results also carry the page's
    valid `vectors`. One lock holds still the rows, the count, the masks and
    the metadata through `add`, `search` and `save`, which the server's
    threads may call at once."""

    def __init__(
        self,
        dim: int,
        vecs_per_page: int = 8,
        capacity: int = 256,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultiVectorIndex: device 'cuda' asked for, but no CUDA device is available")
        self.dim = dim
        self.vecs_per_page = vecs_per_page
        self._rows = torch.zeros((capacity, vecs_per_page, dim), dtype=torch.float32, device=self.device)
        self._valid = torch.zeros((capacity, vecs_per_page), dtype=torch.bool, device=self.device)
        self.count = 0
        self.metadata: List[Dict] = []
        self._doc_rows: Dict[str, List[int]] = {}
        self._mask_cache: Dict[Optional[str], torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._rows.shape[0]

    def _ensure_capacity(self, extra: int) -> None:
        cap = self.capacity
        if self.count + extra <= cap:
            return
        new_cap = cap
        while new_cap < self.count + extra:
            new_cap *= 2
        self._rows = F.pad(self._rows, (0, 0, 0, 0, 0, new_cap - cap))
        self._valid = F.pad(self._valid, (0, 0, 0, new_cap - cap))

    def add(
        self,
        vector_sets: Sequence[np.ndarray],
        records: Sequence[Dict],
        memory_ids: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """vector_sets[i]: (k_i, dim) unit-norm vectors of page i, cut or
        padded to vecs_per_page."""
        n = len(vector_sets)
        if len(records) != n:
            raise ValueError(f"{len(records)} records for {n} vector sets")
        if memory_ids is None:
            memory_ids = [_new_memory_id() for _ in range(n)]
        kmax = self.vecs_per_page
        block = np.zeros((n, kmax, self.dim), np.float32)
        vmask = np.zeros((n, kmax), bool)
        for i, vecs in enumerate(vector_sets):
            vecs = np.asarray(vecs, np.float32).reshape(-1, self.dim)[:kmax]
            block[i, : len(vecs)] = vecs
            vmask[i, : len(vecs)] = True
        with self._lock:
            self._ensure_capacity(n)
            start = self.count
            self._rows[start : start + n] = torch.from_numpy(block).to(self.device)
            self._valid[start : start + n] = torch.from_numpy(vmask).to(self.device)
            ids = []
            for i, (record, mem_id) in enumerate(zip(records, memory_ids)):
                rec = dict(record)
                rec["memory_id"] = mem_id
                self.metadata.append(rec)
                doc = rec.get("doc_id")
                if doc is not None:
                    self._doc_rows.setdefault(doc, []).append(start + i)
                ids.append(mem_id)
            self.count += n
            self._mask_cache.clear()
            return ids

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
        self, query_vectors: np.ndarray, top_k: int = 8, doc_id: Optional[str] = None
    ) -> List[Dict]:
        """query_vectors (Q, dim), e.g. the question and its rewrite -> one
        ranked list of {'id', 'content', 'metadata', 'score', 'vectors'}."""
        queries = torch.from_numpy(np.atleast_2d(np.asarray(query_vectors, np.float32)))
        with self._lock:
            if self.count == 0:
                return []
            k = min(top_k, self.count)
            vals, idx = maxsim_topk(self._rows, self._valid, queries.to(self.device), self._mask_for(doc_id), k)
            # Masked-out filler (the doc has fewer than k pages) is dropped:
            # the scores are sorted, so it is a suffix.
            vals = vals.cpu().numpy()
            vals = vals[vals > NEG_INF / 2]
            keep = idx[: len(vals)]
            rows_host = self._rows[keep].cpu().numpy()
            valid_host = self._valid[keep].cpu().numpy()
            records = [self.metadata[int(row)] for row in keep.cpu()]
        return [
            {
                "id": rec["memory_id"],
                "content": rec.get("content", ""),
                "metadata": {key: rec[key] for key in rec if key not in ("memory_id", "content")},
                "score": float(score),
                "vectors": rows[valid],
            }
            for score, rec, rows, valid in zip(vals, records, rows_host, valid_host)
        ]

    # -- persistence --------------------------------------------------------

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with self._lock:
            rows = self._rows[: self.count].cpu().numpy()
            valid = self._valid[: self.count].cpu().numpy()
            metadata = json.dumps(
                {"dim": self.dim, "vecs_per_page": self.vecs_per_page, "metadata": self.metadata},
                ensure_ascii=False,
            )
        np.savez_compressed(path / "mv_rows.npz", rows=rows, valid=valid)
        (path / "mv_metadata.json").write_text(metadata)

    @classmethod
    def load(cls, path, device: Union[str, torch.device] = "cuda") -> "MultiVectorIndex":
        path = Path(path)
        meta = json.loads((path / "mv_metadata.json").read_text())
        with np.load(path / "mv_rows.npz") as data:
            rows, valid = data["rows"], data["valid"]
        index = cls(dim=meta["dim"], vecs_per_page=meta["vecs_per_page"],
                    capacity=max(256, rows.shape[0]), device=device)
        if rows.shape[0]:
            index.add(
                [rows[i][valid[i]] for i in range(rows.shape[0])],
                [{k: v for k, v in rec.items() if k != "memory_id"} for rec in meta["metadata"]],
                memory_ids=[rec["memory_id"] for rec in meta["metadata"]],
            )
        return index
