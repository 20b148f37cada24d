"""Full-PDF batch extraction CLI: the port of scripts/extract_pdf.py.

Same argparse surface and artifacts as the reference's
scripts/extract_pdf_with_gemini.py (--pdf --dpi --start_page --end_page
--sleep --overwrite; output/pages/page_###.{png,json}, output/manifest.json,
output/combined.md), with the sequential page loop + 1 s/page API pacing
replaced by batched on-device execution. --sleep is accepted for surface
compatibility and ignored (there is no external API to pace)."""

import argparse
from pathlib import Path

from ..config import resolve_model_preset
from ..pipeline import extract
from . import configure_logging


def main():
    parser = argparse.ArgumentParser(
        description="Extract and compress PDF pages using the on-device vision pipeline"
    )
    parser.add_argument(
        "--pdf", type=str, default="data/sample.pdf",
        help="Path to PDF file (default: data/sample.pdf)",
    )
    parser.add_argument(
        "--dpi", type=int, default=200,
        help="DPI for image conversion (default: 200)",
    )
    parser.add_argument(
        "--start_page", type=int, default=1,
        help="Start page (1-indexed, default: 1)",
    )
    parser.add_argument(
        "--end_page", type=int, default=None,
        help="End page (1-indexed, default: all pages)",
    )
    parser.add_argument(
        "--sleep", type=float, default=1.0,
        help="Accepted for CLI compatibility; unused (no external API to pace)",
    )
    parser.add_argument(
        "--overwrite", action="store_true",
        help="Overwrite existing JSON files",
    )
    parser.add_argument(
        "--engine", choices=["auto", "text", "vlm"], default=None,
        help="Extraction engine (default: auto)",
    )
    args = parser.parse_args()
    configure_logging()

    output_dir = Path("output")
    pages_dir = output_dir / "pages"
    stats = extract.extract_pdf_to_page_jsons(
        args.pdf,
        pages_dir,
        images_dir=pages_dir,  # reference CLI keeps PNGs beside JSONs
        dpi=args.dpi,
        start_page=args.start_page,
        end_page=args.end_page,
        overwrite=args.overwrite,
        engine=args.engine,
    )
    print(
        f"Processed {len(stats['processed_pages'])}/{stats['pages_total']} pages; "
        f"{len(stats['failed_pages'])} failed"
    )
    extract.create_manifest(
        args.pdf, output_dir / "manifest.json", stats,
        dpi=args.dpi, start_page=args.start_page, end_page=args.end_page,
        # The JAX package's model name, so both packages write the same manifest.
        model_name=f"vcp-tpu-{resolve_model_preset()}",
    )
    print(f"Manifest: {output_dir / 'manifest.json'}")
    extract.create_combined_markdown(pages_dir, output_dir / "combined.md")
    print(f"Combined markdown: {output_dir / 'combined.md'}")


if __name__ == "__main__":
    main()
