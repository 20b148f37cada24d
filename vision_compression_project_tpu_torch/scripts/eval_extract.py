"""Full-page extraction quality: does the VLM engine reproduce the text
engine's structured output on fresh synthetic pages? The port of
scripts/eval_extract.py, with its arguments, output lines and JSON.

The text engine (pipeline/textmd.py) gives the ground-truth {markdown,
summary, entities} of a synthetic page; the VLM must recover them from the
pixels. Reports SequenceMatcher similarity per field. Runs on RUNTIME.device
(VCP_DEVICE, the card unless it says "cpu"):

    python -m vision_compression_project_tpu_torch.scripts.eval_extract \\
        --preset ocr_bpe --ckpt_dir checkpoints/default/ocr_bpe --pages 16

--data golden_png reads the reference's page rasters with the port's own PNG
reader (raster/png.py); nothing here imports PIL.
"""

import argparse
import difflib
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import config


def _extract_chunked(runner, pages, args):
    """extract_batch in chunks of --chunk pages, one flushed progress line
    per chunk: the heartbeat a staleness watchdog reads. (The reference pads
    the last chunk to its compiled shape; eager PyTorch needs no padding, and
    the records are the same.)"""
    n = pages.shape[0]
    chunk = max(1, min(getattr(args, "chunk", 4) or n, n))
    records = []
    t0 = time.time()
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        records.extend(runner.extract_batch(pages[lo:hi], page_numbers=list(range(lo + 1, hi + 1))))
        print(f"eval pages {hi}/{n} ({time.time() - t0:.0f}s)", flush=True)
    return records


def _load_runner(args):
    from ..models import get_preset
    from ..train import checkpoint

    return checkpoint.load_runner(get_preset(args.preset), args.ckpt_dir, max_new_default=args.max_new,
                                  device=config.RUNTIME.device)


def _eval_golden_png(args):
    """Score the VLM on the reference's own page rasters (real document
    pixels); the ground truth is the markdown its pipeline extracted
    (pages/page_NNN.json's raw_response)."""
    from ..raster.png import read_png, to_rgb
    from ..train.corpus import golden_pages_dir
    from ..train.data import stack_pages
    from ..utils.json_utils import safe_json_loads

    pages_dir = golden_pages_dir()
    pngs = sorted(pages_dir.glob("page_*.png"))[: args.pages]
    if not pngs:
        raise SystemExit(f"no golden page PNGs under {pages_dir}")
    golds, imgs = [], []
    for png in pngs:
        rec = safe_json_loads(json.loads(png.with_suffix(".json").read_text())["raw_response"])
        if not isinstance(rec, dict) or "markdown" not in rec:
            continue
        golds.append(rec["markdown"])
        imgs.append(to_rgb(read_png(png)))
    batch = stack_pages(imgs)
    records = _extract_chunked(_load_runner(args), batch, args)
    sims = [difflib.SequenceMatcher(None, g, r["markdown"]).ratio() for g, r in zip(golds, records)]
    result = {
        "pages": len(imgs),
        "data": "golden_png",
        "source": str(pages_dir),
        "markdown_similarity_mean": round(float(np.mean(sims)), 4),
        "markdown_similarity_min": round(float(min(sims)), 4),
    }
    print(json.dumps(result))
    print("\nsample VLM markdown:", records[0]["markdown"][:160].replace("\n", " | "))
    print("sample gold markdown:", golds[0][:160].replace("\n", " | "))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=2))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="ocr_bpe")
    parser.add_argument("--ckpt_dir", required=True)
    parser.add_argument("--pages", type=int, default=16)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--dpi", type=int, default=46)
    parser.add_argument("--font_size", type=int, default=24)
    parser.add_argument("--lines", type=int, default=6)
    parser.add_argument("--max_new", type=int, default=256)
    parser.add_argument(
        "--data", choices=["words", "real", "golden", "golden_png", "jumble"], default="words",
        help="real: held-out real-language prose pages (a corpus split never seen in training); golden: prose "
        "from the reference's golden combined.md (VCP_GOLDEN_MD), outside every training pool; golden_png: the "
        "reference's own page rasters (VCP_GOLDEN_PAGES dir) scored against its extracted markdown",
    )
    parser.add_argument("--fonts", default="builtin",
                        help="comma list of page fonts rotated per page (pdfgen aliases or .ttf paths)")
    parser.add_argument("--vocab_cap", type=int, default=0,
                        help="jumble word-inventory cap; must match the training cap")
    parser.add_argument("--jumble_plain", type=int, default=0,
                        help="1: plain jumble pages (no templates/bullets/blank lines), as in training")
    parser.add_argument("--chunk", type=int, default=4,
                        help="device sub-batch size; each chunk prints a flushed progress line")
    parser.add_argument("--json_out", default=None)
    args = parser.parse_args(argv)

    from ..pipeline.textmd import structure_page
    from ..raster import PdfDocument, make_pdf
    from ..train.data import stack_pages, synthetic_page_text

    rng = np.random.default_rng(args.seed)
    if args.data == "golden_png":
        _eval_golden_png(args)
        return
    fonts = [f.strip() for f in args.fonts.split(",") if f.strip()] or ["builtin"]
    page_fonts = [int(rng.integers(0, len(fonts))) for _ in range(args.pages)]
    if args.data in ("real", "golden"):
        from ..train.corpus import real_page_text

        split = "heldout" if args.data == "real" else "golden"
        texts = [real_page_text(rng, lines=args.lines, font_size=args.font_size, split=split,
                                font=fonts[page_fonts[i]]) for i in range(args.pages)]
    elif args.data == "jumble":
        # Fresh random word sequences: training words in an unseen order, so
        # the score measures reading with no language prior to lean on.
        from ..train.corpus import jumble_page_text

        texts = [jumble_page_text(rng, lines=args.lines, font_size=args.font_size, font=fonts[page_fonts[i]],
                                  vocab_cap=args.vocab_cap, plain=bool(args.jumble_plain))
                 for i in range(args.pages)]
    else:
        texts = [synthetic_page_text(rng, lines=args.lines) for _ in range(args.pages)]
    tmp = Path(tempfile.mkdtemp(prefix="vcp_extract_eval_"))
    pdf = make_pdf(texts, tmp / "eval.pdf", font_size=args.font_size, fonts=fonts, page_fonts=page_fonts)
    with PdfDocument(pdf) as doc:
        rasters = doc.render_batch(0, args.pages - 1, dpi=args.dpi)
    pages = stack_pages(rasters)
    records = _extract_chunked(_load_runner(args), pages, args)

    def sim(a: str, b: str) -> float:
        return difflib.SequenceMatcher(None, a, b).ratio()

    md_scores, sum_scores, ent_scores = [], [], []
    for text, record in zip(texts, records):
        gold = structure_page(text, record["page_number"])
        md_scores.append(sim(gold["markdown"], record["markdown"]))
        sum_scores.append(sim(gold["summary"], record["summary"]))
        ent_scores.append(sim(" ".join(gold["entities"]), " ".join(record["entities"])))

    result = {
        "pages": args.pages,
        "data": args.data,
        "render": {
            "lines": args.lines, "font_size": args.font_size, "dpi": args.dpi, "fonts": fonts,
            **({"vocab_cap": args.vocab_cap} if args.data == "jumble" else {}),
        },
        "markdown_similarity_mean": round(float(np.mean(md_scores)), 4),
        "markdown_similarity_min": round(float(min(md_scores)), 4),
        "summary_similarity_mean": round(float(np.mean(sum_scores)), 4),
        "entities_similarity_mean": round(float(np.mean(ent_scores)), 4),
    }
    print(json.dumps(result))
    print("\nsample VLM markdown:", records[0]["markdown"][:160].replace("\n", " | "))
    print("sample gold markdown:", structure_page(texts[0], 1)["markdown"][:160].replace("\n", " | "))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
