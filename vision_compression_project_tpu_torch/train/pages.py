"""Seeded page texts for the port's runs on the card: prose made from a seed,
laid out on a page as the JAX package lays out its real-text pages
(vision_compression_project_tpu/train/corpus.py::real_page_text, builtin font).

The reference draws its sentences from the Python packages installed on the
machine, so its pages depend on the machine; here they come from
`prose_pages`, so the same seed gives the same PDF anywhere. The returned
text is exactly what is drawn, so `pipeline.textmd.structure_page(text)` is
the gold extraction of the page.

Standard library and numpy only: a script that does not import torch may
load this file by path.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

PAGE_W, PAGE_H, MARGIN = 612, 792, 72  # US Letter in points, as make_pdf draws it
ADVANCE_FACTOR = 0.62  # builtin font: ems per character, with slack
LEADING_FACTOR = 1.4

_SUBJECTS = ("The cache module", "The billing service", "Plant delta", "The audit team",
             "The retrieval index", "The vision encoder", "Cluster theta", "The night shift")
_VERBS = ("stored", "reported", "processed", "rejected", "shipped", "reviewed")
_OBJECTS = ("invoices", "pages", "units", "defect reports", "requests", "samples")
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_NUMERIC = (
    "The value reached {a}.{b} percent in {year}.",
    "Table {n} lists {a} of the {c} measured cases.",
    "Results improved from {a}.{b} to {c}.{d} after {n} runs.",
    "Section {n}.{m} reports {a},{b}{d} samples total.",
)


def prose_pages(seed: int, n_pages: int, sentences: int = 20) -> List[str]:
    """Seeded synthetic prose, one string per page (about 1,300 characters at
    20 sentences); every sentence carries its page and sentence numbers."""
    rng = np.random.default_rng(seed)
    pages = []
    for p in range(1, n_pages + 1):
        out = []
        for s in range(1, sentences + 1):
            subj = _SUBJECTS[rng.integers(len(_SUBJECTS))]
            verb = _VERBS[rng.integers(len(_VERBS))]
            obj = _OBJECTS[rng.integers(len(_OBJECTS))]
            out.append(f"{subj} {verb} {int(rng.integers(2, 999))} {obj} in section {p}.{s}.")
        pages.append(" ".join(out))
    return pages


def sentence_pool(seed: int, n_pages: int = 40) -> List[str]:
    """The sentences of `prose_pages(seed, n_pages)`, in order."""
    return [s for page in prose_pages(seed, n_pages) for s in _SENT_SPLIT.split(page) if s]


def chars_per_line(font_size: int) -> int:
    return max(8, int((PAGE_W - 2 * MARGIN) / (ADVANCE_FACTOR * font_size)))


def max_lines_for_font(font_size: int) -> int:
    return max(1, int((PAGE_H - 2 * MARGIN) / (LEADING_FACTOR * font_size)))


def _wrap(words: List[str], width: int) -> List[str]:
    lines: List[str] = []
    cur = ""
    for w in words:
        w = w[:width]
        if cur and len(cur) + 1 + len(w) > width:
            lines.append(cur)
            cur = w
        else:
            cur = (cur + " " + w).strip()
    if cur:
        lines.append(cur)
    return lines


def real_page_text(rng: np.random.Generator, pool: List[str], lines: int = 30, font_size: int = 12,
                   title_words: int = 3) -> str:
    """One page: a short title (then a blank line half the time), then runs
    of consecutive pool sentences word-wrapped to the column width, with
    numeric sentences, bullet lists and paragraph breaks drawn from `rng` at
    the reference's rates."""
    lines = min(lines, max_lines_for_font(font_size))
    width = chars_per_line(font_size)
    start = int(rng.integers(0, len(pool)))
    title_src = pool[(start + 7919) % len(pool)].split()
    title = " ".join(w.capitalize() for w in title_src[: min(len(title_src), title_words)])[:width][:60].rstrip(".")

    out: List[str] = []
    idx = start
    while len(out) < lines:
        budget = lines - len(out)
        if rng.random() < 0.12:
            sent = str(rng.choice(_NUMERIC)).format(
                a=int(rng.integers(1, 100)), b=int(rng.integers(0, 10)),
                c=int(rng.integers(1, 100)), d=int(rng.integers(0, 10)),
                n=int(rng.integers(1, 10)), m=int(rng.integers(1, 10)),
                year=int(rng.integers(1990, 2027)),
            )
            out.extend(_wrap(sent.split(), width)[:budget])
            if len(out) < lines - 1 and rng.random() < 0.3:
                out.append("")
            continue
        if budget >= 3 and rng.random() < 0.15:
            for _ in range(int(rng.integers(2, min(5, budget) + 1))):
                item = " ".join(pool[idx % len(pool)].split()[: max(3, width // 8)])
                idx += 1
                out.append(("- " + item)[:width])
                if len(out) >= lines:
                    break
        else:
            words: List[str] = []
            for _ in range(int(rng.integers(1, 4))):
                words += pool[idx % len(pool)].split()
                idx += 1
            out.extend(_wrap(words, width)[:budget])
        if len(out) < lines - 1 and rng.random() < 0.35:
            out.append("")
    sep = "\n\n" if rng.random() < 0.5 else "\n"
    return title + sep + "\n".join(out[:lines])


def ingest_texts(seed: int, n_pages: int, lines: int, font_size: int) -> List[str]:
    """The page texts of the card's /ingest check: `n_pages` pages from one
    generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    pool = sentence_pool(seed)
    return [real_page_text(rng, pool, lines=lines, font_size=font_size) for _ in range(n_pages)]
