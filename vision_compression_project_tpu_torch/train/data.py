"""Synthetic supervised data for VLM training: the port of
vision_compression_project_tpu/train/data.py, page extraction and the
answer task (question + evidence pack -> cited answer).

Synthetic document pages are written as real PDFs (raster/pdfgen.py) and
rasterized by the C++ engine, the input the serving path sees, and paired
with the token sequence the decoder is to emit (`markdown <SEP> summary <SEP>
entities <EOS>`, models/vlm.py), derived from the known source text by the
text engine's structurer (pipeline/textmd.py). A seed gives the same page
bytes and token ids as the reference's generator: the numpy draws are made
in the same order, and the answer task's examples and batches are the
reference's draw for draw.
"""

from __future__ import annotations

import functools
import queue
import re
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models.configs import VLMConfig
from ..models.tokenizer import (
    BOS_ID, EOS_ID, PAD_ID, SEP_ID, TASK_ANSWER_ID, TASK_EXTRACT_ID, ByteTokenizer, get_tokenizer,
)
from ..models.vlm import UNIT_SEP
from ..ops.preprocess import preprocess_pages
from ..pipeline.textmd import structure_page
from ..utils.metrics import METRICS

_WORDS = (
    "model data page table figure result method train loss token image "
    "system value metric test index query answer document vision text "
    "compression encoder decoder attention kernel batch memory device"
).split()


def synthetic_code_page(
    rng: np.random.Generator, lines: int = 8, groups: int = 3, digits: int = 5
) -> str:
    """A page of random digit codes: unpredictable from language statistics,
    so a loss below the ln(10)/digit blind floor must come from reading the
    pixels."""
    title = "Code Sheet " + str(int(rng.integers(100, 999)))
    body = []
    for _ in range(lines):
        gs = " ".join(
            "".join(str(d) for d in rng.integers(0, 10, size=digits)) for _ in range(groups)
        )
        body.append("CODE " + gs)
    return title + "\n" + "\n".join(body)


def synthetic_page_text(
    rng: np.random.Generator,
    lines: int = 18,
    min_words: int = 5,
    max_words: int = 10,
    title_words: int = 3,
) -> str:
    title = " ".join(rng.choice(_WORDS, size=title_words)).title()
    body = []
    for _ in range(lines):
        n = int(rng.integers(min_words, max_words + 1))
        sentence = " ".join(rng.choice(_WORDS, size=n)) + "."
        body.append(sentence.capitalize())
    return title + "\n" + "\n".join(body)


def target_tokens(text: str, page_number: int, max_len: int, tok=None) -> np.ndarray:
    """Teacher sequence: BOS TASK markdown SEP summary SEP entities EOS,
    padded with PAD (or cut, ending in EOS) to max_len int32 ids."""
    tok = tok or ByteTokenizer()
    record = structure_page(text, page_number)
    ids: List[int] = [BOS_ID, TASK_EXTRACT_ID]
    ids += tok.encode(record["markdown"])
    ids.append(SEP_ID)
    ids += tok.encode(record["summary"])
    ids.append(SEP_ID)
    for i, entity in enumerate(record["entities"]):
        if i:
            ids.append(UNIT_SEP)
        ids += tok.encode(entity)
    ids.append(EOS_ID)
    out = np.full((max_len,), PAD_ID, np.int32)
    ids = ids[: max_len - 1] + [EOS_ID] if len(ids) > max_len else ids
    out[: len(ids)] = ids
    return out


def stack_pages(images) -> np.ndarray:
    """(N, H, W, 3) uint8: each (h, w, 3) image at the top left of a white
    page of the largest height and width."""
    h = max(i.shape[0] for i in images)
    w = max(i.shape[1] for i in images)
    pages = np.full((len(images), h, w, 3), 255, np.uint8)
    for i, im in enumerate(images):
        pages[i, : im.shape[0], : im.shape[1]] = im
    return pages


def synthetic_batches(
    cfg: VLMConfig,
    batch_size: int,
    text_len: int = 512,
    dpi: int = 72,
    seed: int = 0,
    workdir: Optional[Path] = None,
    font_size: int = 12,
    lines: int = 18,
    kind: str = "words",
    code_groups: int = 3,
    code_digits: int = 5,
    jumble_frac: float = 0.0,
    fonts: Optional[List[str]] = None,
    vocab_cap: int = 0,
    jumble_plain: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"pages_u8": (B, H, W, 3) uint8, "token_ids": (B, text_len)
    int32} forever; text_len is cut to the context the vision tokens leave.

    kind: words, words_easy, codes, codes_easy, real or jumble. jumble_frac:
    the share of pages drawn from the jumble generator instead (not with
    kind jumble). fonts: font specs to rotate per page (make_pdf's aliases or
    paths, or "builtin"); real and jumble text is wrapped with the chosen
    font's own metrics. Pages are padded to the batch's largest height and
    width with white."""
    from ..raster import PdfDocument, make_pdf

    rng = np.random.default_rng(seed)
    workdir = Path(workdir or tempfile.mkdtemp(prefix="vcp_train_"))
    tok = get_tokenizer(cfg)
    text_len = min(text_len, cfg.decoder.max_seq - cfg.vision.tokens_out - 1)
    if kind == "codes":
        gen = functools.partial(synthetic_code_page, groups=code_groups, digits=code_digits)
    elif kind == "codes_easy":
        gen = functools.partial(synthetic_code_page, groups=1, digits=5)
    elif kind == "words_easy":
        # Short sentences that stay inside the page width at large font sizes.
        gen = functools.partial(synthetic_page_text, min_words=2, max_words=3, title_words=2)
    elif kind == "real":
        from .corpus import real_page_text

        gen = functools.partial(real_page_text, font_size=font_size)
    elif kind == "jumble":
        from .corpus import jumble_page_text

        gen = functools.partial(jumble_page_text, font_size=font_size, vocab_cap=vocab_cap, plain=jumble_plain)
    elif kind == "words":
        gen = synthetic_page_text
    else:
        raise ValueError(f"unknown data kind {kind!r}")
    mix_gen = None
    if jumble_frac > 0.0 and kind != "jumble":
        from .corpus import jumble_page_text

        mix_gen = functools.partial(jumble_page_text, font_size=font_size, vocab_cap=vocab_cap, plain=jumble_plain)
    fonts = list(fonts or ["builtin"])
    step = 0
    while True:
        page_fonts = [int(rng.integers(0, len(fonts))) for _ in range(batch_size)]
        texts = []
        for i in range(batch_size):
            g = mix_gen if mix_gen and rng.random() < jumble_frac else gen
            takes_font = g is mix_gen or kind in ("real", "jumble")
            kwargs = {"font": fonts[page_fonts[i]]} if takes_font else {}
            texts.append(g(rng, lines=lines, **kwargs))
        pdf = make_pdf(texts, workdir / f"batch_{step % 4}.pdf", font_size=font_size,
                       fonts=fonts, page_fonts=page_fonts)
        with PdfDocument(pdf) as doc:
            pages = stack_pages(doc.render_batch(0, batch_size - 1, dpi=dpi))
        tokens = np.stack([target_tokens(t, i + 1, text_len, tok=tok) for i, t in enumerate(texts)])
        yield {"pages_u8": pages, "token_ids": tokens}
        step += 1


def prefetch_batches(it: Iterator[Dict[str, np.ndarray]], depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Run a host-bound batch generator in a background thread, `depth`
    batches ahead, so page synthesis and rasterization overlap the device's
    step. An error in the generator is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True, name="batch-prefetch").start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def device_batch(runner_or_cfg, batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """Host batch -> train-step batch on `device` (else the runner's device,
    else RUNTIME.device): bf16 patch tokens, int64 token ids and a loss mask
    (all ones when the batch has none: extraction supervises every non-pad
    target). Gray pages ship one channel to the device; preprocessing
    broadcasts it to RGB after the resize. Timed as `train.feed`, with its
    rows counted in `train.pages` (utils/metrics.py)."""
    from .train_step import resolve_device

    dev = resolve_device(device or getattr(runner_or_cfg, "device", None))
    vision = getattr(runner_or_cfg, "cfg", runner_or_cfg).vision
    pages = batch["pages_u8"]
    if pages.ndim == 4 and pages.shape[-1] == 3:
        pages = pages[..., 0]
    token_ids = batch["token_ids"]
    loss_mask = batch.get("loss_mask")
    if loss_mask is None:
        loss_mask = np.ones_like(token_ids)
    with METRICS.timer("train.feed"):
        out = {
            "patch_tokens": preprocess_pages(
                torch.from_numpy(np.ascontiguousarray(pages)).to(dev),
                target_h=vision.image_size, target_w=vision.image_size, patch=vision.patch,
            ),
            "token_ids": torch.from_numpy(np.asarray(token_ids)).to(dev, torch.long),
            "loss_mask": torch.from_numpy(np.asarray(loss_mask)).to(dev),
        }
    METRICS.count("train.pages", len(pages))
    return out


# ---------------------------------------------------------------------------
# Answer-task supervision (question + evidence pack -> cited answer)
# ---------------------------------------------------------------------------


def qa_sentence_pool(split: str = "train", max_chars: int = 120) -> List[str]:
    """Real-language sentences short enough for evidence packs (3-5 pages of
    the corpus's longest sentences would fill the answer task's token budget
    before the target sentence appears)."""
    from .corpus import corpus_sentences

    return [s for s in corpus_sentences(split) if len(s) <= max_chars]


def _qa_page_sentences(rng: np.random.Generator, n: int, sentence_pool: Optional[List[str]]) -> List[str]:
    """n evidence sentences: consecutive corpus prose when a pool is given
    (reads like a document page, what /chat sees), else word soup."""
    if sentence_pool:
        start = int(rng.integers(0, len(sentence_pool)))
        return [sentence_pool[(start + i) % len(sentence_pool)] for i in range(n)]
    out = []
    for _ in range(n):
        k = int(rng.integers(5, 10))
        out.append((" ".join(rng.choice(_WORDS, size=k)) + ".").capitalize())
    return out


def _synthetic_qa_example(rng: np.random.Generator, doc_id: str = "doc",
                          sentence_pool: Optional[List[str]] = None):
    """One (question, evidence_pack, answer_md) triple: the question names one
    sentence's content words, and the teacher answer is the extractive
    engine's citation format (pipeline/qa.py::_compose_extractive_answer)
    with that sentence as the claim."""
    n_pages = int(rng.integers(2, 5))
    pages = []
    for _ in range(n_pages):
        n_sent = int(rng.integers(2, 5))
        pages.append(_qa_page_sentences(rng, n_sent, sentence_pool))
    tp = int(rng.integers(0, n_pages))         # target page index
    ts = int(rng.integers(0, len(pages[tp])))  # target sentence index
    target = pages[tp][ts]
    content_words = [w for w in re.findall(r"[a-z]+", target.lower()) if len(w) > 3][:4]
    question = "What about " + " ".join(content_words) + "?"
    page_numbers = list(range(1, n_pages + 1))
    parts = [f"[Page {pno} | memory_id=m{pno:02d}]\n" + " ".join(sents) for pno, sents in zip(page_numbers, pages)]
    evidence_pack = "\n\n---\n\n".join(parts)
    answer_md = (
        f"Based on the retrieved pages ({doc_id} p.{page_numbers[tp]}):\n\n"
        f"- {target} ({doc_id} p.{page_numbers[tp]})"
    )
    return question, evidence_pack, answer_md


_AGG_SUBJECTS = ("region", "team", "sensor", "cluster", "plant")
_AGG_NAMES = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta", "sigma")
_AGG_ITEMS = ("units", "samples", "reports", "devices", "queries", "errors")


def _synthetic_agg_qa_example(rng: np.random.Generator, doc_id: str = "doc",
                              sentence_pool: Optional[List[str]] = None):
    """One aggregation example: (question, evidence_pack, answer_md, facts).
    The answer is a count, a total or a superlative over facts spread across
    pages, a statement no evidence sentence holds, so the extractive engine
    cannot produce it. `facts` is the ground truth eval_answer --task agg
    scores key-fact accuracy with."""
    kind = str(rng.choice(["count", "sum", "max"]))
    n_pages = int(rng.integers(3, 6))
    subject = str(rng.choice(_AGG_SUBJECTS))
    item = str(rng.choice(_AGG_ITEMS))
    names = list(rng.choice(_AGG_NAMES, size=n_pages, replace=False))
    values = rng.integers(2, 98, size=n_pages)
    if kind == "max":
        # A unique maximum, so "which produced the most" has one answer.
        j = int(rng.integers(0, n_pages))
        values[j] = int(values.max()) + int(rng.integers(1, 10))
    if sentence_pool:
        # A topic word from real prose, so the mention and the question share its vocabulary.
        cand = re.findall(r"[a-z]{5,}", sentence_pool[int(rng.integers(0, len(sentence_pool)))].lower())
        topic = cand[int(rng.integers(0, len(cand)))] if cand else str(rng.choice(_WORDS))
    else:
        topic = str(rng.choice(_WORDS))
    mention = rng.random(n_pages) < 0.5
    if kind == "count":
        while not 0 < mention.sum():  # at least one page mentions it
            mention = rng.random(n_pages) < 0.5

    pages = []
    for i in range(n_pages):
        sents = [f"{subject.capitalize()} {names[i]} produced {int(values[i])} {item}."]
        if mention[i]:
            sents.append(f"The {topic} module is covered in this section.")
        n_fill = int(rng.integers(1, 3))
        sents += _qa_page_sentences(rng, n_fill, sentence_pool)
        rng.shuffle(sents)
        pages.append(" ".join(sents))

    page_numbers = list(range(1, n_pages + 1))
    parts = [f"[Page {p} | memory_id=m{p:02d}]\n{text}" for p, text in zip(page_numbers, pages)]
    evidence_pack = "\n\n---\n\n".join(parts)

    if kind == "count":
        cited = [p for p, m in zip(page_numbers, mention) if m]
        question = f"How many pages mention the {topic} module?"
        claim = f"{len(cited)} of the {n_pages} pages mention the {topic} module"
        facts = {"kind": kind, "value": len(cited), "cited": cited}
    elif kind == "sum":
        cited = page_numbers
        total = int(values.sum())
        question = f"How many {item} were produced in total across all {subject}s?"
        claim = f"The {subject}s produced {total} {item} in total"
        facts = {"kind": kind, "value": total, "cited": cited}
    else:  # max
        j = int(np.argmax(values))
        cited = [page_numbers[j]]
        question = f"Which {subject} produced the most {item}?"
        claim = f"{subject.capitalize()} {names[j]} produced the most {item} ({int(values[j])})"
        facts = {"kind": kind, "value": int(values[j]), "name": names[j], "cited": cited}
    cite_str = ", ".join(f"p.{p}" for p in cited)
    answer_md = f"Based on the retrieved pages ({doc_id} {cite_str}):\n\n- {claim} ({doc_id} {cite_str})"
    return question, evidence_pack, answer_md, facts


def qa_batches(
    cfg: VLMConfig,
    batch_size: int,
    text_len: int = 512,
    seed: int = 0,
    agg_frac: float = 0.0,
    data_kind: str = "words",
) -> Iterator[Dict[str, np.ndarray]]:
    """Text-only answer-task batches for the same train step as extraction (a
    blank page rides the vision tower, so one checkpoint serves both tasks):
    {"pages_u8": blank (B, 64, 64, 3), "token_ids": (B, text_len),
    "loss_mask": (B, text_len)}, forever.

    token_ids = BOS TASK_ANSWER question SEP evidence SEP answer EOS, the
    prompt layout of VLMRunner.answer, and loss_mask supervises the answer
    span only. agg_frac: the share of examples from the aggregation
    generator. data_kind: "words" (word-soup evidence), "real" (corpus prose,
    qa_sentence_pool) or "mixed" (50/50 per example)."""
    rng = np.random.default_rng(seed)
    tok = get_tokenizer(cfg)
    text_len = min(text_len, cfg.decoder.max_seq - cfg.vision.tokens_out - 1)
    pool = qa_sentence_pool("train") if data_kind in ("real", "mixed") else None
    blank = np.full((batch_size, 64, 64, 3), 255, np.uint8)
    while True:
        tokens = np.full((batch_size, text_len), PAD_ID, np.int32)
        # Only the answer span is supervised: the prompt is given at serve
        # time, and its cross-entropy would drown the answer's about 10:1.
        loss_mask = np.zeros((batch_size, text_len), np.int32)
        for i in range(batch_size):
            use_pool = pool if (data_kind == "real" or (data_kind == "mixed" and rng.random() < 0.5)) else None
            # Resample when the evidence overflows its budget: cutting it
            # could drop the target sentence the answer quotes.
            for _attempt in range(6):
                if rng.random() < agg_frac:
                    q, ev, ans, _ = _synthetic_agg_qa_example(rng, sentence_pool=use_pool)
                else:
                    q, ev, ans = _synthetic_qa_example(rng, sentence_pool=use_pool)
                ids: List[int] = [BOS_ID, TASK_ANSWER_ID]
                ids += tok.encode(q)
                ids.append(SEP_ID)
                ev_ids = tok.encode(ev)
                ans_ids = tok.encode(ans) + [EOS_ID]
                budget = text_len - len(ids) - len(ans_ids) - 1
                if len(ev_ids) <= budget:
                    break
            ids += ev_ids[: max(0, budget)]
            ids.append(SEP_ID)
            answer_start = len(ids)  # the first answer token
            ids += ans_ids
            ids = ids[: text_len - 1] + [EOS_ID] if len(ids) > text_len else ids
            tokens[i, : len(ids)] = ids
            loss_mask[i, answer_start : len(ids)] = 1
        yield {"pages_u8": blank, "token_ids": tokens, "loss_mask": loss_mask}
