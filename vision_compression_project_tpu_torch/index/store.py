"""Process-wide index store: load-or-create, save after every add, one lock
for writers. The port of vision_compression_project_tpu/index/store.py:
single mode (VectorIndex, one pooled vector per page) and multi mode
(MultiVectorIndex, MaxSim over per-page vector sets). With a mesh whose
`data` dimension holds more than one rank, single-mode searches take the
sharded route (`VectorIndex.search_sharded`); every rank then serves the
same requests in the same order.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from .. import config
from ..parallel.mesh import AXIS_DATA, MeshConfig, axis_size, build_mesh
from .multivector import MultiVectorIndex
from .vector_index import VectorIndex

_lock = threading.Lock()
_default_store: Optional["IndexStore"] = None


class IndexStore:
    def __init__(
        self, root, dim: int, mode: Optional[str] = None, device: Union[str, torch.device] = "cuda", mesh=None
    ):
        self.root = Path(root)
        self.dim = dim
        self.mesh = mesh  # a mesh with data > 1 routes single-mode search through the sharded path
        self.mode = mode or config.RUNTIME.retrieval_mode
        if self.mode not in ("single", "multi"):
            raise ValueError(f"unknown retrieval mode {self.mode!r}")
        self._lock = threading.Lock()
        cls, meta_file = (MultiVectorIndex, "mv_metadata.json") if self.mode == "multi" else (
            VectorIndex, "metadata.json")
        self.index = None
        if (self.root / meta_file).exists():
            self.index = cls.load(self.root, device=device)
        if self.index is None or self.index.dim != dim:
            # A new store, or the embedder's dim changed: start fresh rather than mix spaces.
            self.index = cls(dim=dim, device=device)

    def add(self, embeddings, records, memory_ids=None):
        """Single mode: (B, dim) pooled vectors. Multi mode: a list of
        per-page (k_i, dim) vector sets. The index is saved after."""
        with self._lock:
            ids = self.index.add(embeddings, records, memory_ids)
            self.index.save(self.root)
            return ids

    def search(self, query_embeddings, top_k=8, doc_id=None):
        """Single mode: per-query result lists for (B, dim) queries. Multi
        mode: the (Q, dim) input is ONE query set (question + rewrites);
        returns [results] for call-site uniformity."""
        if self.mode == "multi":
            return [self.index.search(query_embeddings, top_k=top_k, doc_id=doc_id)]
        if self.mesh is not None and axis_size(self.mesh, AXIS_DATA) > 1:
            return self.index.search_sharded(self.mesh, query_embeddings, top_k=top_k, doc_id=doc_id)
        return self.index.search(query_embeddings, top_k=top_k, doc_id=doc_id)


def _serving_mesh():
    """A data-only mesh over every rank for sharded retrieval, by
    VCP_INDEX_SHARDED: '0' none, '1' always (raises without a process
    group), 'auto' when the world holds more than one rank."""
    knob = config.RUNTIME.index_sharded
    if knob not in ("0", "1", "auto"):
        raise ValueError(f"VCP_INDEX_SHARDED={knob!r}: expected 0, 1 or auto")
    if knob == "0" or (knob == "auto" and not (dist.is_initialized() and dist.get_world_size() > 1)):
        return None
    if not dist.is_initialized():
        raise RuntimeError("VCP_INDEX_SHARDED=1 needs a process group (parallel.initialize_multihost)")
    return build_mesh(MeshConfig(data=dist.get_world_size()), torch.device(config.RUNTIME.device).type)


def get_default_store(dim: Optional[int] = None, root=None) -> IndexStore:
    """The process's shared store on RUNTIME.device at `root`
    (RUNTIME.index_root by default), made anew when the root or the dim changes."""
    global _default_store
    dim = dim or config.RUNTIME.embed_dim
    root = Path(root or config.RUNTIME.index_root)
    with _lock:
        if _default_store is None or _default_store.root != root or _default_store.dim != dim:
            _default_store = IndexStore(root, dim, device=config.RUNTIME.device, mesh=_serving_mesh())
        return _default_store
