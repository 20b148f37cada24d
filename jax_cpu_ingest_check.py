#!/usr/bin/env python3
"""The JAX package's /ingest on the CPU over the PDF that chip_smoke.py's
ingest_pdf phase reads, as the reference for the port's similarity on the card.

    JAX_PLATFORMS=cpu VCP_FORCE_XLA_ATTENTION=1 python3 jax_cpu_ingest_check.py [--seed 0]

The page texts come from vision_compression_project_tpu_torch/train/pages.py,
loaded by path (it needs only numpy), so this script imports neither torch
nor the port's package. It builds the PDF with the JAX package's make_pdf at
ocr_real's training render, reads it with the JAX package's load_runner (the
shipped ocr_real, decode budget 2048 as bench.py) and
extract_pdf_to_page_jsons(engine="vlm", batch_size=4, save_images=False),
and prints one JSON line: the markdown similarity of every page to its
structure_page gold, their mean and the seconds taken.
"""

from __future__ import annotations

import argparse
import difflib
import importlib.util
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from vision_compression_project_tpu.config import shipped_checkpoint_dir, shipped_meta
from vision_compression_project_tpu.models import get_preset
from vision_compression_project_tpu.pipeline.extract import extract_pdf_to_page_jsons
from vision_compression_project_tpu.pipeline.textmd import structure_page
from vision_compression_project_tpu.raster import make_pdf
from vision_compression_project_tpu.train.checkpoint import load_runner

PAGES_PY = Path(__file__).resolve().parent / "vision_compression_project_tpu_torch" / "train" / "pages.py"
N_PAGES, BATCH, MAX_NEW = 16, 4, 2048


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("port_pages", PAGES_PY)
    pages = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pages)

    meta = shipped_meta("ocr_real")
    texts = pages.ingest_texts(args.seed, N_PAGES, meta["lines"], meta["font_size"])
    runner = load_runner(get_preset("ocr_real"), shipped_checkpoint_dir("ocr_real"), max_new_default=MAX_NEW)
    with tempfile.TemporaryDirectory() as tmp:
        pdf = make_pdf(texts, Path(tmp) / "ingest.pdf", font_size=meta["font_size"], fonts=meta.get("fonts"))
        t0 = time.perf_counter()
        stats = extract_pdf_to_page_jsons(pdf, Path(tmp) / "pages", dpi=meta["dpi"], engine="vlm",
                                          batch_size=BATCH, runner=runner, save_images=False)
        seconds = time.perf_counter() - t0
        sims = []
        for i, text in enumerate(texts, 1):
            rec = json.loads((Path(tmp) / "pages" / f"page_{i:03d}.json").read_text())
            sims.append(difflib.SequenceMatcher(None, structure_page(text, i)["markdown"], rec["markdown"]).ratio())
    print(json.dumps({"device": "cpu", "pages": N_PAGES, "failed_pages": stats["failed_pages"],
                      "seconds": seconds, "similarity": sims, "mean_similarity": float(np.mean(sims))}))


if __name__ == "__main__":
    main()
