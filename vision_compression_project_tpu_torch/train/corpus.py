"""Real-language sentence corpus for VLM OCR training: the port's copy of
vision_compression_project_tpu/train/corpus.py (standard library and numpy).

Harvests English prose from the documentation of the installed Python
packages (METADATA, README, rst and txt files under the site-packages
directory the reference harvests, `HARVEST_DIR`) into a deduplicated sentence
pool with a deterministic 95/5 train/heldout split, and generates document pages with a
realistic layout: width-aware word wrapping (make_pdf does not wrap; clipped
words poison targets), titles, paragraph breaks and occasional bullets, so
the textmd gold targets exercise headings and lists. The pool depends on the
machine, as the reference's does. The golden split (`golden_sentences`) reads
the reference pipeline's own extracted document, which no training pool draws
from, so the eval numbers on it are uncontaminated real prose. Both paths are
the reference's fixed ones, whatever interpreter runs the port, so the two
packages read the same files on any machine.
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
from pathlib import Path
from typing import List

import numpy as np

# pdfgen pages are US Letter (612x792pt) with 72pt margins; the C++ engine
# renders non-embedded Type1 text with the built-in atlas at an advance of
# 0.55*font_size (raster/cpp/pdf_engine.cc:1421).  0.62 leaves slack so no
# wrapped line ever clips at the right edge.
_PAGE_W, _PAGE_H, _MARGIN = 612, 792, 72
_ADVANCE_FACTOR = 0.62
_LEADING_FACTOR = 1.4

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_WORD_RE = re.compile(r"[A-Za-z]")

_sentences_cache: dict = {}


def chars_per_line(font_size: int, font: str = "builtin") -> int:
    usable = _PAGE_W - 2 * _MARGIN
    factor = _ADVANCE_FACTOR
    if font not in (None, "", "builtin"):
        # Embedded TrueType: effective per-char width from the font's own
        # metrics (mean lowercase+space advance, raster/ttf.py) plus slack.
        factor = _mean_advance_em(font) * 1.12
    return max(8, int(usable / (factor * font_size)))


def _mean_advance_em(font: str) -> float:
    from ..raster.pdfgen import resolve_font
    from ..raster.ttf import load_metrics

    m = load_metrics(resolve_font(font))
    chars = "abcdefghijklmnopqrstuvwxyz "
    return sum(m.advance_em(ord(c)) for c in chars) / len(chars)


def _make_wrapper(font: str, font_size: int):
    """(words -> wrapped lines) for the given font: char-count wrap for the
    builtin atlas (historical behavior, advance is a constant 0.55 em —
    raster/cpp/pdf_engine.cc), exact em-measured wrap for embedded TTFs
    (advances vary per glyph; the measure uses the same hmtx metrics the
    renderer positions by, so no wrapped line can clip)."""
    if font in (None, "", "builtin"):
        width = chars_per_line(font_size)
        return width, lambda words: _wrap(words, width)
    from ..raster.pdfgen import resolve_font
    from ..raster.ttf import load_metrics

    m = load_metrics(resolve_font(font))
    usable_em = (_PAGE_W - 2 * _MARGIN) / font_size * 0.98
    width = chars_per_line(font_size, font)

    def wrap(words: List[str]) -> List[str]:
        lines: List[str] = []
        cur, cur_w = "", 0.0
        space_w = m.advance_em(32)
        for w in words:
            w_w = m.text_width_em(w)
            while w_w > usable_em and len(w) > 1:  # pathological long token
                w = w[: len(w) // 2]
                w_w = m.text_width_em(w)
            if cur and cur_w + space_w + w_w > usable_em:
                lines.append(cur)
                cur, cur_w = w, w_w
            elif cur:
                cur, cur_w = cur + " " + w, cur_w + space_w + w_w
            else:
                cur, cur_w = w, w_w
        if cur:
            lines.append(cur)
        return lines

    return width, wrap


def max_lines_for_font(font_size: int) -> int:
    usable = _PAGE_H - 2 * _MARGIN
    return max(1, int(usable / (_LEADING_FACTOR * font_size)))


def _clean_line(line: str) -> str:
    # Strip common rst/markdown markup so the pool is prose, not syntax.
    line = re.sub(r"[`*_|=~^<>{}\[\]#]", " ", line)
    line = re.sub(r"https?://\S+", " ", line)
    line = line.encode("ascii", "replace").decode().replace("?", " ")
    return " ".join(line.split())


def _sentence_ok(s: str) -> bool:
    if not (24 <= len(s) <= 220):
        return False
    words = s.split()
    if len(words) < 4:
        return False
    alpha = sum(1 for c in s if c.isalpha() or c == " ")
    if alpha / len(s) < 0.8:
        return False
    # Mostly word-like tokens (filters option tables, code fragments).
    wordish = sum(1 for w in words if _WORD_RE.search(w))
    return wordish / len(words) >= 0.8


def _add_sentences(body: str, seen: set, out: List[str]) -> None:
    """Append the acceptable sentences of `body`, paragraph by paragraph, to
    `out`, each once: `seen` holds the lowercased sentences so far."""
    for para in re.split(r"\n\s*\n", body):
        text = _clean_line(para.replace("\n", " "))
        for sent in _SENT_SPLIT.split(text):
            sent = sent.strip()
            if _sentence_ok(sent) and sent.lower() not in seen:
                seen.add(sent.lower())
                out.append(sent)


# The reference's harvest directory (vision_compression_project_tpu/train/corpus.py:128),
# fixed: not the running interpreter's site-packages.
HARVEST_DIR = Path("/").joinpath("opt", "venv", "lib", "python3.12", "site-packages")


def _harvest(budget_bytes: int = 30_000_000) -> List[str]:
    files: List[str] = []
    site = str(HARVEST_DIR)
    files += glob.glob(f"{site}/*.dist-info/METADATA")
    files += glob.glob(f"{site}/*/METADATA")
    for ext in ("md", "rst", "txt"):
        files += glob.glob(f"{site}/**/*.{ext}", recursive=True)
    files = sorted(set(files))
    seen = set()
    out: List[str] = []
    used = 0
    for fp in files:
        try:
            body = Path(fp).read_text(encoding="utf-8", errors="ignore")[:300_000]
        except OSError:
            continue
        used += len(body)
        _add_sentences(body, seen, out)
        if used > budget_bytes:
            break
    if not out:  # pathological environment: fall back to repo docs
        for fp in Path(__file__).resolve().parents[2].glob("*.md"):
            for sent in _SENT_SPLIT.split(_clean_line(fp.read_text())):
                if _sentence_ok(sent.strip()):
                    out.append(sent.strip())
    return out


GOLDEN_MD_ENV = "VCP_GOLDEN_MD"
# The reference pipeline's combined.md of its real 22-page PDF, at the
# reference's fixed path (vision_compression_project_tpu/train/corpus.py:165);
# VCP_GOLDEN_MD overrides.
_DEFAULT_GOLDEN_MD = Path("/").joinpath("root", "reference", "output", "combined.md")


def golden_pages_dir() -> Path:
    """The reference pipeline's page directory of the same run (page_NNN.json
    and page_NNN.png): VCP_GOLDEN_PAGES, else beside the default combined.md."""
    return Path(os.environ.get("VCP_GOLDEN_PAGES", _DEFAULT_GOLDEN_MD.parent / "pages"))


def golden_sentences() -> List[str]:
    """Sentences of the reference's golden document (the combined.md its
    pipeline extracted), never in the training pool. The path is
    VCP_GOLDEN_MD's, else the default; a missing file raises
    FileNotFoundError."""
    path = Path(os.environ.get(GOLDEN_MD_ENV, _DEFAULT_GOLDEN_MD))
    if not path.exists():
        raise FileNotFoundError(f"golden document not found at {path}; set {GOLDEN_MD_ENV}")
    out: List[str] = []
    _add_sentences(path.read_text(errors="ignore"), set(), out)
    return out


def corpus_sentences(split: str = "train") -> List[str]:
    """Deterministic 95/5 train/heldout split by sentence content hash;
    split="golden" draws from the reference's golden document instead
    (golden_sentences)."""
    if split == "golden":
        if "golden" not in _sentences_cache:
            _sentences_cache["golden"] = golden_sentences()
        return _sentences_cache["golden"]
    if split not in ("train", "heldout"):
        raise ValueError(f"unknown split {split!r}: 'train', 'heldout' or 'golden'")
    if split not in _sentences_cache:
        all_sents = _sentences_cache.get("_all")
        if all_sents is None:
            all_sents = _harvest()
            _sentences_cache["_all"] = all_sents
        train, heldout = [], []
        for s in all_sents:
            h = int(hashlib.md5(s.lower().encode()).hexdigest()[:8], 16)
            (heldout if h % 20 == 0 else train).append(s)
        _sentences_cache["train"] = train
        _sentences_cache["heldout"] = heldout
    return _sentences_cache[split]


def corpus_vocabulary(min_len: int = 2, max_len: int = 14) -> List[str]:
    """Unique words of the training sentence pool, sorted (deterministic).

    The word inventory for jumble pages: real-language glyph/word shapes
    without real-language *sequence* statistics."""
    if "vocab" not in _sentences_cache:
        seen = set()
        for s in corpus_sentences("train"):
            for w in s.split():
                w = w.strip(".,;:!?()'\"")
                if min_len <= len(w) <= max_len and w.isalpha():
                    seen.add(w)
        _sentences_cache["vocab"] = sorted(seen)
    return _sentences_cache["vocab"]


def capped_vocabulary(cap: int) -> List[str]:
    """A deterministic `cap`-word subset of the corpus vocabulary.

    Stride-sampled from the sorted inventory (not an alphabetical prefix,
    which would collapse onto one letter region), so a capped vocab keeps
    diverse word lengths and initial glyphs: the vocabulary ramp of jumble
    read-training (a direct jump to the full inventory starves the reading
    gradient), cap 128 -> 1024 -> full."""
    v = corpus_vocabulary()
    if cap <= 0 or cap >= len(v):
        return v
    key = f"vocab_cap_{cap}"
    if key not in _sentences_cache:
        stride = max(1, len(v) // cap)
        _sentences_cache[key] = v[::stride][:cap]
    return _sentences_cache[key]


def jumble_page_text(
    rng: np.random.Generator,
    lines: int = 30,
    font_size: int = 12,
    split: str = "train",  # unused; signature-compatible with real_page_text
    min_words: int = 0,
    max_words: int = 0,
    title_words: int = 3,
    font: str = "builtin",
    vocab_cap: int = 0,
    plain: bool = False,
) -> str:
    """A page of INDEPENDENTLY random corpus words — unmemorizable content.

    plain=True strips the structural extras (Value-template sentences,
    bullet lines, blank lines): every token then carries reading signal,
    and greedy generation has no high-prior template to collapse into.

    Pages of consecutive corpus sentences let the decoder reach a low loss
    by memorizing the sentence pool while ignoring the pixels. Random word
    sequences have no language prior to exploit, so every nat of loss below
    the vocabulary entropy must come from reading, while the glyph
    distribution, wrapping, bullets and paragraph layout stay those of real
    pages.

    vocab_cap > 0 restricts the word inventory (capped_vocabulary): the
    read-dive ramp — small vocab concentrates the reading gradient so the
    vision circuit forms, later stages widen back to the full inventory."""
    vocab = capped_vocabulary(vocab_cap)
    lines = min(lines, max_lines_for_font(font_size))
    width, wrap = _make_wrapper(font, font_size)

    def rand_words(n: int) -> List[str]:
        idx = rng.integers(0, len(vocab), size=n)
        return [vocab[int(i)] for i in idx]

    title = " ".join(
        w.capitalize() for w in rand_words(int(title_words))
    )[:width][:60].rstrip(".")

    out_lines: List[str] = []
    while len(out_lines) < lines:
        budget = lines - len(out_lines)
        if not plain and rng.random() < 0.12:
            sent = "Value {a}.{b} of {c} in {year}.".format(
                a=int(rng.integers(1, 100)), b=int(rng.integers(0, 10)),
                c=int(rng.integers(1, 1000)), year=int(rng.integers(1990, 2027)),
            )
            out_lines.extend(wrap(sent.split())[:budget])
        elif not plain and budget >= 3 and rng.random() < 0.15:
            for _ in range(int(rng.integers(2, min(5, budget) + 1))):
                item = " ".join(rand_words(max(3, width // 8)))
                out_lines.append(_clip_line("- " + item, width, font, wrap))
                if len(out_lines) >= lines:
                    break
        else:
            words: List[str] = []
            for _ in range(int(rng.integers(1, 4))):
                ws = rand_words(int(rng.integers(4, 10)))
                ws[0] = ws[0].capitalize()
                ws[-1] += "."
                words += ws
            out_lines.extend(wrap(words)[:budget])
        if not plain and len(out_lines) < lines - 1 and rng.random() < 0.35:
            out_lines.append("")
    body = "\n".join(out_lines[:lines])
    sep = "\n" if plain else ("\n\n" if rng.random() < 0.5 else "\n")
    return title + sep + body


def _clip_line(line: str, width: int, font: str, wrap) -> str:
    """Bound one line to the page width: char slice for the builtin atlas
    (fixed advance — historical behavior), measured word-boundary clip for
    embedded TTFs (char counts under-estimate wide glyph runs)."""
    if font in (None, "", "builtin"):
        return line[:width]
    clipped = wrap(line.split())
    return clipped[0] if clipped else ""


def _wrap(words: List[str], width: int) -> List[str]:
    lines: List[str] = []
    cur = ""
    for w in words:
        if len(w) > width:
            w = w[:width]
        if cur and len(cur) + 1 + len(w) > width:
            lines.append(cur)
            cur = w
        else:
            cur = (cur + " " + w).strip()
    if cur:
        lines.append(cur)
    return lines


def real_page_text(
    rng: np.random.Generator,
    lines: int = 30,
    font_size: int = 12,
    split: str = "train",
    min_words: int = 0,  # unused; signature-compatible with synthetic_page_text
    max_words: int = 0,
    title_words: int = 3,
    font: str = "builtin",
) -> str:
    """A document page of real-language prose with realistic layout.

    Consecutive corpus sentences are word-wrapped to the rendered column
    width for `font_size`; a short title heads the page (blank line after it
    half the time, which textmd structures as a markdown heading); sentence
    runs occasionally restart as new paragraphs; some paragraphs render as
    bullet lists.  The returned string is the exact text drawn on the page,
    so `structure_page(text)` is the gold extraction target.
    """
    pool = corpus_sentences(split)
    lines = min(lines, max_lines_for_font(font_size))
    width, wrap = _make_wrapper(font, font_size)
    start = int(rng.integers(0, len(pool)))

    title_src = pool[(start + 7919) % len(pool)].split()
    n_t = min(len(title_src), int(title_words))
    title = " ".join(w.capitalize() for w in title_src[:n_t])[: width][:60].rstrip(".")

    out_lines: List[str] = []
    idx = start
    while len(out_lines) < lines:
        budget = lines - len(out_lines)
        # Numeric sentences: the harvested prose is digit-poor (the
        # sentence filter wants 80% alpha) but real documents are full of
        # dates/figures/percentages — inject them so OCR training covers
        # digits, units and punctuation around numbers.
        if rng.random() < 0.12:
            templates = (
                "The value reached {a}.{b} percent in {year}.",
                "Table {n} lists {a} of the {c} measured cases.",
                "Results improved from {a}.{b} to {c}.{d} after {n} runs.",
                "Section {n}.{m} reports {a},{b}{d} samples total.",
            )
            t = str(rng.choice(templates))
            sent = t.format(
                a=int(rng.integers(1, 100)), b=int(rng.integers(0, 10)),
                c=int(rng.integers(1, 100)), d=int(rng.integers(0, 10)),
                n=int(rng.integers(1, 10)), m=int(rng.integers(1, 10)),
                year=int(rng.integers(1990, 2027)),
            )
            out_lines.extend(wrap(sent.split())[:budget])
            if len(out_lines) < lines - 1 and rng.random() < 0.3:
                out_lines.append("")
            continue
        is_bullets = budget >= 3 and rng.random() < 0.15
        if is_bullets:
            for _ in range(int(rng.integers(2, min(5, budget) + 1))):
                s = pool[idx % len(pool)]
                idx += 1
                item = " ".join(s.split()[: max(3, width // 8)])
                out_lines.append(_clip_line("- " + item, width, font, wrap))
                if len(out_lines) >= lines:
                    break
        else:
            n_sent = int(rng.integers(1, 4))
            words: List[str] = []
            for _ in range(n_sent):
                words += pool[idx % len(pool)].split()
                idx += 1
            out_lines.extend(wrap(words)[:budget])
        # paragraph break (a blank line costs one rendered line)
        if len(out_lines) < lines - 1 and rng.random() < 0.35:
            out_lines.append("")
    body = "\n".join(out_lines[:lines])
    sep = "\n\n" if rng.random() < 0.5 else "\n"
    return title + sep + body
