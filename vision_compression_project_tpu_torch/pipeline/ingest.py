"""Page-JSON ingestion into the vector index: the port of
vision_compression_project_tpu/pipeline/ingest.py.

Each page_NNN.json becomes one index row: in single mode one pooled vector,
embedded in batches; in multi mode (a store whose mode is "multi") the
page's vector set, `page_vector_set`, one embed call per page. The manifest
{doc_id, pdf_path, pages: [{page, file, memory_id}], failed_pages} has the
reference's schema, and an existing manifest for the same doc is resumed.
parse_json_file reads both legacy artifact shapes: {page_number,
raw_response} with fenced JSON inside, and {page_number, markdown, entities,
summary}.
"""

from __future__ import annotations

import functools
import json
import logging
import re
from pathlib import Path
from typing import Dict, List, Optional

from ..config import RUNTIME
from ..utils import METRICS, safe_json_loads

logger = logging.getLogger(__name__)

_PAGE_RE = re.compile(r"page_(\d+)\.json$")
_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def page_vector_set(embedder, content: str, kmax: int = 8):
    """Multi-vector page representation: the pooled page vector plus up to
    kmax-1 sentence vectors. Returns (vectors, sentences) with vectors row
    i+1 aligned to sentences[i] (row 0 = pooled page vector)."""
    sentences = [
        sent.strip()
        for sent in _SENT_RE.split(" ".join(content.split()))
        if len(sent.strip()) >= 15
    ][: kmax - 1]
    return embedder.embed([content] + sentences), sentences


def parse_json_file(file_path) -> Dict:
    """Parse a page JSON of either legacy shape into a flat record."""
    file_path = Path(file_path)
    outer = json.loads(file_path.read_text(encoding="utf-8"))
    raw_response = outer.get("raw_response", "")
    if raw_response:
        inner = safe_json_loads(raw_response)
        if inner and isinstance(inner, dict):
            return {**outer, **inner}
        return {
            "page_number": outer.get("page_number", 1),
            "markdown": raw_response,
            "entities": [],
            "summary": "",
        }
    return outer


def _page_content(data: Dict) -> str:
    """markdown -> raw_response -> str(data) fallback chain."""
    content = data.get("markdown", "")
    if not content and "raw_response" in data:
        content = data["raw_response"]
    if not content:
        content = str(data)
    return content


@functools.lru_cache(maxsize=1)
def _get_embedder():
    """The process's default embedder (RUNTIME.embed_backend) on RUNTIME.device."""
    from .. import config
    from ..models.configs import EmbedderConfig
    from ..models.embedder import get_embedder

    runtime = config.RUNTIME
    return get_embedder(runtime.embed_backend, EmbedderConfig(dim=runtime.embed_dim), device=runtime.device)


def ingest_pages_dir(
    pages_dir,
    pdf_path,
    doc_id: str,
    manifest_path,
    overwrite: bool = False,
    embedder=None,
    store=None,
    batch_size: Optional[int] = None,
) -> Dict:
    """Embed and index every page_*.json in pages_dir; write and return the
    manifest."""
    pages_dir = Path(pages_dir)
    manifest_path = Path(manifest_path)
    embedder = embedder or _get_embedder()
    if store is None:
        from ..index import get_default_store

        store = get_default_store(dim=embedder.dim)
    batch_size = batch_size or RUNTIME.embed_batch_size

    # Resume: reuse rows already in an existing manifest for this doc.
    existing_pages: Dict[int, Dict] = {}
    if manifest_path.exists() and not overwrite:
        try:
            existing = json.loads(manifest_path.read_text(encoding="utf-8"))
            if existing.get("doc_id") == doc_id:
                for entry in existing.get("pages", []):
                    if "page" in entry and "error" not in entry:
                        existing_pages[entry["page"]] = entry
        except Exception:  # an unreadable manifest is ignored, as in the reference
            pass

    pages: List[Dict] = []
    failed_pages: List[Dict] = []
    todo = []  # (page_number, file_path, content, record)
    for file_path in sorted(pages_dir.glob("page_*.json")):
        match = _PAGE_RE.search(file_path.name)
        if not match:
            continue
        page_number = int(match.group(1))
        if not overwrite and page_number in existing_pages:
            pages.append(existing_pages[page_number])
            continue
        try:
            data = parse_json_file(file_path)
        except Exception as exc:  # as the reference: any parse failure, e.g. RecursionError
            failed_pages.append({"page": page_number, "error": f"Failed to parse JSON: {exc}"})
            continue
        content = _page_content(data)
        record = {
            "doc_id": doc_id,
            "page": page_number,
            "summary": data.get("summary", ""),
            "entities": data.get("entities", []),
            "source_file": str(pdf_path),
            "content": content,
        }
        todo.append((page_number, file_path, content, record))

    multi = getattr(store, "mode", "single") == "multi"
    # One device batch per chunk: embed + append.
    for i in range(0, len(todo), batch_size):
        chunk = todo[i : i + batch_size]
        try:
            with METRICS.timer("ingest.batch"):
                if multi:
                    embeddings = []
                    for c in chunk:
                        vecs, sentences = page_vector_set(embedder, c[2])
                        embeddings.append(vecs)
                        # The sentence texts ride the record, aligned with
                        # vectors 1.., so answers can reuse the stored vectors.
                        c[3]["sentences"] = sentences
                else:
                    embeddings = embedder.embed([c[2] for c in chunk])
                memory_ids = store.add(embeddings, [c[3] for c in chunk])
            METRICS.count("ingest.pages", len(chunk))
        except Exception as exc:  # a failed batch is recorded per page; the others go on
            logger.error("ingest batch failed: %s", exc, exc_info=True)
            for page_number, *_ in chunk:
                failed_pages.append({"page": page_number, "error": str(exc)})
            continue
        for (page_number, file_path, _, _), mem_id in zip(chunk, memory_ids):
            pages.append({"page": page_number, "file": str(file_path), "memory_id": mem_id})

    pages.sort(key=lambda x: x["page"])
    manifest = {
        "doc_id": doc_id,
        "pdf_path": str(pdf_path),
        "pages": pages,
        "failed_pages": failed_pages,
    }
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    manifest_path.write_text(json.dumps(manifest, indent=2, ensure_ascii=False), encoding="utf-8")
    return manifest
