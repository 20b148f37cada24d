"""Single-page extraction smoke CLI: the port of scripts/extract_page.py.

Counterpart of the reference's scripts/extract_page_with_gemini.py (page 1
of a PDF -> output/page_1.png + output/page_1.json), with the cloud vision
call replaced by the on-device pipeline (text engine or VLM). The PNG is
written by the port's own encoder (no PIL)."""

import argparse
import json
from pathlib import Path

from ..pipeline import extract
from ..raster import PdfDocument
from . import configure_logging

OUTPUT_DIR = Path("output")


def main():
    parser = argparse.ArgumentParser(
        description="Extract page 1 of a PDF to structured JSON (on-device)."
    )
    parser.add_argument(
        "--pdf", type=str, default="data/sample.pdf",
        help="Path to PDF file (default: data/sample.pdf)",
    )
    parser.add_argument("--dpi", type=int, default=200)
    parser.add_argument(
        "--engine", choices=["auto", "text", "vlm"], default=None,
        help="Extraction engine (default: auto)",
    )
    args = parser.parse_args()
    configure_logging()

    OUTPUT_DIR.mkdir(parents=True, exist_ok=True)
    with PdfDocument(args.pdf) as doc:
        print(f"PDF has {doc.page_count} pages")
        img = doc.render_page(0, dpi=args.dpi)
    extract._save_png(img, OUTPUT_DIR / "page_1.png")
    print(f"Saved image: {OUTPUT_DIR / 'page_1.png'} ({img.shape[1]}x{img.shape[0]})")

    pages_dir = OUTPUT_DIR / "_page1_tmp"
    stats = extract.extract_pdf_to_page_jsons(
        args.pdf, pages_dir, dpi=args.dpi, start_page=1, end_page=1,
        overwrite=True, engine=args.engine, save_images=False,
    )
    src = pages_dir / "page_001.json"
    record = json.loads(src.read_text(encoding="utf-8"))
    (OUTPUT_DIR / "page_1.json").write_text(
        json.dumps(record, indent=2, ensure_ascii=False), encoding="utf-8"
    )
    print(f"Saved JSON: {OUTPUT_DIR / 'page_1.json'}")
    print(f"Summary: {record.get('summary', '')[:200]}")
    if stats["failed_pages"]:
        print(f"Failures: {stats['failed_pages']}")


if __name__ == "__main__":
    main()
