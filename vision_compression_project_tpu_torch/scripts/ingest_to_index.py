"""Page-JSON -> vector-index ingestion CLI: the port of
scripts/ingest_to_index.py.

Same argparse surface, manifest schema, and post-ingest search smoke test as
the reference's scripts/ingest_to_supermemory.py (--pages_dir --pdf_path
--doc_id --overwrite --smoke_test_query; output/supermemory_manifest.json
with {doc_id, pdf_path, created_at, pages:[{page,file,memory_id}]};
doc_id slug from the PDF filename; top-10 smoke-test hits), with the cloud
index replaced by the on-device index."""

import argparse
import json
import re
from datetime import datetime, timezone
from pathlib import Path

from ..pipeline import ingest
from ..pipeline.ingest import _get_embedder
from . import configure_logging


def generate_doc_id(pdf_path: str) -> str:
    """Slug from the PDF filename (reference ingest_to_supermemory.py:239-245)."""
    stem = Path(pdf_path).stem.lower()
    slug = re.sub(r"[^a-z0-9]+", "_", stem).strip("_")
    return slug or "document"


def main():
    parser = argparse.ArgumentParser(
        description="Ingest compressed per-page outputs into the on-device index as searchable memories."
    )
    parser.add_argument(
        "--pages_dir", default="output/pages",
        help="Directory containing page JSON files (default: output/pages)",
    )
    parser.add_argument(
        "--pdf_path", default="data/sample.pdf",
        help="Path to original PDF file. Use quotes if path contains spaces.",
    )
    parser.add_argument(
        "--doc_id",
        help="Document ID. If not provided, generated from PDF filename.",
    )
    parser.add_argument(
        "--overwrite", action="store_true",
        help="Overwrite existing ingested pages (default: skip already ingested pages)",
    )
    parser.add_argument(
        "--smoke_test_query", default="Summarize the document",
        help='Query for smoke test (default: "Summarize the document")',
    )
    args = parser.parse_args()
    configure_logging()

    doc_id = args.doc_id or generate_doc_id(args.pdf_path)
    manifest_path = Path("output/supermemory_manifest.json")
    manifest = ingest.ingest_pages_dir(
        args.pages_dir, args.pdf_path, doc_id, manifest_path,
        overwrite=args.overwrite,
    )
    # Script-mode manifest additionally records created_at (reference
    # ingest_to_supermemory.py:162-173 / the checked-in golden manifest).
    manifest["created_at"] = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    manifest_path.write_text(
        json.dumps(manifest, indent=2, ensure_ascii=False), encoding="utf-8"
    )
    print(
        f"Ingested {len(manifest['pages'])} pages as doc_id={doc_id!r}; "
        f"{len(manifest['failed_pages'])} failed"
    )
    print(f"Manifest: {manifest_path}")

    # Search smoke test: print the top-10 hits for retrievability
    # (reference ingest_to_supermemory.py:176-236).
    if args.smoke_test_query:
        from ..index import get_default_store

        embedder = _get_embedder()
        store = get_default_store(dim=embedder.dim)
        results = store.search(
            embedder.embed([args.smoke_test_query]), top_k=10, doc_id=doc_id
        )[0]
        print(f"\nSmoke test query: {args.smoke_test_query!r}")
        if not results:
            print("  (no results)")
        for rank, r in enumerate(results, 1):
            print(
                f"  {rank:2d}. page={r['metadata'].get('page')} "
                f"memory_id={r['id']} score={r['score']:.3f}"
            )


if __name__ == "__main__":
    main()
