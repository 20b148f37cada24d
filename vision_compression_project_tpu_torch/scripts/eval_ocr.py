"""Did the VLM learn to read? The port of scripts/eval_ocr.py: generates the
structured output of fresh synthetic code pages and scores the digits it
reproduces against the ground truth.

Only the pixels can predict a page's random codes, so digit similarity well
above chance (about 0.1) shows working end-to-end OCR. Runs on
RUNTIME.device (VCP_DEVICE, the card unless it says "cpu"):

    python -m vision_compression_project_tpu_torch.scripts.eval_ocr --ckpt_dir checkpoints/vlm
"""

import argparse
import difflib
import re
import tempfile
from pathlib import Path

import numpy as np

from .. import config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate learned OCR.")
    parser.add_argument("--preset", default="ocr_demo")
    parser.add_argument("--ckpt_dir", required=True)
    parser.add_argument("--pages", type=int, default=8)
    parser.add_argument("--seed", type=int, default=999)
    parser.add_argument("--dpi", type=int, default=72)
    parser.add_argument("--font_size", type=int, default=24)
    parser.add_argument("--lines", type=int, default=8)
    parser.add_argument("--max_new", type=int, default=256)
    args = parser.parse_args(argv)

    from ..models import get_preset
    from ..raster import PdfDocument, make_pdf
    from ..train import checkpoint
    from ..train.data import synthetic_code_page

    rng = np.random.default_rng(args.seed)
    texts = [synthetic_code_page(rng, lines=args.lines) for _ in range(args.pages)]
    tmp = Path(tempfile.mkdtemp(prefix="vcp_ocr_eval_"))
    pdf = make_pdf(texts, tmp / "eval.pdf", font_size=args.font_size)
    with PdfDocument(pdf) as doc:
        rasters = doc.render_batch(0, args.pages - 1, dpi=args.dpi)
    pages = np.stack(rasters)

    runner = checkpoint.load_runner(get_preset(args.preset), args.ckpt_dir, max_new_default=args.max_new,
                                    device=config.RUNTIME.device)
    records = runner.extract_batch(pages, page_numbers=list(range(1, args.pages + 1)))

    scores = []
    for text, record in zip(texts, records):
        gold = "".join(re.findall(r"\d", text))
        pred = "".join(re.findall(r"\d", record["markdown"]))
        scores.append(difflib.SequenceMatcher(None, gold, pred).ratio())
    print(f"digit-sequence similarity over {args.pages} fresh pages:")
    print(f"  mean={np.mean(scores):.3f}  min={min(scores):.3f}  max={max(scores):.3f}")
    print("  (chance ~0.1; >0.3 indicates real visual reading)")
    sample = records[0]["markdown"][:200].replace("\n", " | ")
    print(f"sample output: {sample}")
    print(f"gold page:     {texts[0][:200]}")


if __name__ == "__main__":
    main()
