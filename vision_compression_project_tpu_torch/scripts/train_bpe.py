"""Train a BPE merge table: the port of the repository's scripts/train_bpe.py,
with its arguments, corpus and lines.

Corpus: the synthetic page generators (the training and serving input
distribution), their markdown structurings, digit-code OCR pages, the
reference's golden pages where they are present (VCP_GOLDEN_PAGES, default
beside the reference's combined.md, train/corpus.py), and general English from the
package docs of the reference's site-packages directory (METADATA files,
train/corpus.py's HARVEST_DIR) and the repository's
own markdown; or, with --corpus real, the open-vocabulary prose the ocr_real
preset trains on. The merges go to --out, by default the port's own
models/bpe_merges.json: a table learned here never lands in the JAX package.

    python -m vision_compression_project_tpu_torch.scripts.train_bpe [--vocab_size 4096] [--pages 3000]
        [--corpus mixed|real] [--out PATH]
"""

import argparse
import glob
import sys
from pathlib import Path

import numpy as np

from ..models.tokenizer import DEFAULT_MERGES_PATH, BPETokenizer
from ..pipeline.ingest import parse_json_file
from ..pipeline.textmd import structure_page
from ..train.corpus import HARVEST_DIR, golden_pages_dir
from ..train.data import synthetic_code_page, synthetic_page_text
from . import REPO

DOC_BUDGET = 6_000_000  # characters of docs, after which no more files are read
DOC_FILE_CHARS = 200_000  # characters taken from one doc file


def doc_files() -> list:
    """The package docs and repository markdown the corpus reads, in the
    reference's order (a dist-info METADATA matches both globs, so it is
    listed twice, as there)."""
    site = str(HARVEST_DIR)
    files = glob.glob(f"{site}/*/METADATA") + glob.glob(f"{site}/*.dist-info/METADATA")
    files += [str(p) for p in REPO.glob("*.md")]
    files += [str(p) for p in (REPO / "docs").glob("**/*.md")]
    return sorted(files)


def build_corpus(n_pages: int = 3000, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n_pages):
        t = synthetic_page_text(rng, lines=int(rng.integers(6, 24)))
        texts.append(t)
        rec = structure_page(t, i + 1)
        texts.append(rec["markdown"])
        texts.append(rec["summary"])
        texts.extend(rec["entities"])
    for _ in range(n_pages // 10):
        texts.append(synthetic_code_page(rng))
    golden = golden_pages_dir()
    if golden.is_dir():
        for f in sorted(golden.glob("page_*.json")):
            try:
                data = parse_json_file(f)
            except Exception:
                continue
            texts.append(data.get("markdown", ""))
            texts.append(data.get("summary", "") or "")
    used = 0
    for fp in doc_files():
        try:
            body = Path(fp).read_text(encoding="utf-8", errors="ignore")
        except Exception:
            continue
        texts.append(body[:DOC_FILE_CHARS])
        used += min(len(body), DOC_FILE_CHARS)
        if used > DOC_BUDGET:
            break
    return texts


def build_real_corpus(n_pages: int = 2000, seed: int = 0) -> list:
    """The train split's sentences (held-out sentences never shape the
    tokenizer), wrapped prose pages as ocr_real trains and serves on, their
    structurings, and digit-code pages."""
    from ..train.corpus import corpus_sentences, real_page_text

    rng = np.random.default_rng(seed)
    texts = list(corpus_sentences("train"))
    for i in range(n_pages):
        t = real_page_text(rng, lines=int(rng.integers(8, 32)), font_size=int(rng.choice([12, 14, 16, 20, 32])))
        texts.append(t)
        rec = structure_page(t, i + 1)
        texts.append(rec["markdown"])
        texts.append(rec["summary"])
        texts.extend(rec["entities"])
    for _ in range(n_pages // 10):
        texts.append(synthetic_code_page(rng))
    return texts


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--vocab_size", type=int, default=4096)
    parser.add_argument("--pages", type=int, default=3000)
    parser.add_argument("--corpus", choices=["mixed", "real"], default="mixed",
                        help="real: open-vocabulary prose corpus for the ocr_real preset")
    parser.add_argument("--out", default=str(DEFAULT_MERGES_PATH))
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    texts = build_real_corpus(args.pages) if args.corpus == "real" else build_corpus(args.pages)
    total_bytes = sum(len(t.encode("utf-8")) for t in texts)
    print(f"corpus: {len(texts)} texts, {total_bytes / 1e6:.2f} MB")
    tok = BPETokenizer.train(texts, vocab_size=args.vocab_size)
    path = tok.save(args.out)
    print(f"trained {len(tok.merges)} merges -> vocab {tok.vocab_size}")
    print(f"saved: {path}")

    sample = texts[0]
    ids = tok.encode(sample)
    print(f"sample compression: {len(sample.encode('utf-8')) / max(1, len(ids)):.2f} bytes/token")
    assert tok.decode(ids) == sample
    golden = golden_pages_dir()
    if golden.is_dir():
        md = parse_json_file(golden / "page_009.json")["markdown"]
        print(f"golden-page compression: {len(md.encode('utf-8')) / max(1, len(tok.encode(md))):.2f} bytes/token")
    return 0


if __name__ == "__main__":
    sys.exit(main())
