"""Retrieval quality harness, hit@k over synthetic documents: the port of
scripts/eval_retrieval.py, with its arguments, corpus and output lines.

Builds N synthetic pages with known per-page facts, ingests them under each
retrieval configuration (mode:backend), and asks one templated question per
page; a hit means the gold page is retrieved in the top k. Runs on
RUNTIME.device (VCP_DEVICE, the card unless it says "cpu"):

    python -m vision_compression_project_tpu_torch.scripts.eval_retrieval \\
        --pages 200 --top_k 1 --configs single:hash multi:hash
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

from .. import config


def build_corpus(n_pages: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    topics = [
        "solar panels", "wind turbines", "battery storage", "hydro dams",
        "nuclear reactors", "geothermal wells", "tidal generators",
        "biomass plants", "grid transformers", "transmission lines",
        "carbon capture", "heat pumps", "electric vehicles", "fuel cells",
        "smart meters", "demand response", "insulation retrofits",
        "district heating", "power inverters", "charging stations",
    ]
    pages, questions = [], []
    for i in range(n_pages):
        topic = topics[i % len(topics)]
        qualifier = f"variant {i // len(topics)}" if i >= len(topics) else ""
        fact_value = int(rng.integers(10, 99))
        page = (
            f"Section on {topic} {qualifier}\n"
            f"This section covers {topic} in detail.\n"
            f"The measured efficiency of {topic} {qualifier} is {fact_value} percent.\n"
            f"Additional general commentary about energy systems follows here."
        )
        pages.append(page)
        questions.append((f"What is the efficiency of {topic} {qualifier}?", i + 1))
    return pages, questions


def evaluate(mode: str, backend: str, pages, questions, k: int) -> float:
    from ..index import IndexStore
    from ..models import EmbedderConfig, get_embedder
    from ..pipeline import extract, ingest, qa
    from ..raster import make_pdf

    device = config.RUNTIME.device
    with tempfile.TemporaryDirectory(prefix=f"vcp_eval_{mode}_{backend}_") as tmp:
        tmp = Path(tmp)
        pdf = make_pdf(pages, tmp / "corpus.pdf")
        extract.extract_pdf_to_page_jsons(pdf, tmp / "pages", dpi=72, engine="text")
        embedder = get_embedder(backend, EmbedderConfig(), device=device)
        store = IndexStore(tmp / "idx", dim=embedder.dim, mode=mode, device=device)
        ingest.ingest_pages_dir(tmp / "pages", pdf, "corpus", tmp / "sm.json", embedder=embedder, store=store)
        hits = 0
        for question, gold_page in questions:
            # hit@k reads the retrieval alone, which comes before the answer
            # engine runs, so the cheapest engine answers.
            result = qa.answer_question("corpus", question, top_k=k, store=store, embedder=embedder,
                                        engine="extractive")
            if any(r["page"] == gold_page for r in result["retrieved"]):
                hits += 1
    return hits / len(questions)


def main():
    parser = argparse.ArgumentParser(description="Retrieval hit@k evaluation.")
    parser.add_argument("--pages", type=int, default=40)
    parser.add_argument("--top_k", type=int, default=3)
    parser.add_argument(
        "--configs", nargs="+",
        default=["single:hash", "multi:hash"],
        help="mode:backend pairs to evaluate",
    )
    args = parser.parse_args()

    pages, questions = build_corpus(args.pages)
    print(f"corpus: {len(pages)} pages, hit@{args.top_k}")
    for cfg in args.configs:
        mode, backend = cfg.split(":")
        score = evaluate(mode, backend, pages, questions, args.top_k)
        print(f"  {cfg:>16}: {score:.3f}")


if __name__ == "__main__":
    main()
