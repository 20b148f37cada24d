"""Synthetic supervised data for VLM extraction training: the port of the
extraction half of vision_compression_project_tpu/train/data.py.

Synthetic document pages are written as real PDFs (raster/pdfgen.py) and
rasterized by the C++ engine, the input the serving path sees, and paired
with the token sequence the decoder is to emit (`markdown <SEP> summary <SEP>
entities <EOS>`, models/vlm.py), derived from the known source text by the
text engine's structurer (pipeline/textmd.py). A seed gives the same page
bytes and token ids as the reference's generator: the numpy draws are made
in the same order.
"""

from __future__ import annotations

import functools
import queue
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models.configs import VLMConfig
from ..models.tokenizer import BOS_ID, EOS_ID, PAD_ID, SEP_ID, TASK_EXTRACT_ID, ByteTokenizer, get_tokenizer
from ..models.vlm import UNIT_SEP
from ..ops.preprocess import preprocess_pages
from ..pipeline.textmd import structure_page

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
            rasters = doc.render_batch(0, batch_size - 1, dpi=dpi)
        h = max(r.shape[0] for r in rasters)
        w = max(r.shape[1] for r in rasters)
        pages = np.full((batch_size, h, w, 3), 255, np.uint8)
        for i, r in enumerate(rasters):
            pages[i, : r.shape[0], : r.shape[1]] = r
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
    broadcasts it to RGB after the resize."""
    from .train_step import resolve_device

    dev = resolve_device(device or getattr(runner_or_cfg, "device", None))
    vision = getattr(runner_or_cfg, "cfg", runner_or_cfg).vision
    pages = batch["pages_u8"]
    if pages.ndim == 4 and pages.shape[-1] == 3:
        pages = pages[..., 0]
    patches = preprocess_pages(
        torch.from_numpy(np.ascontiguousarray(pages)).to(dev),
        target_h=vision.image_size, target_w=vision.image_size, patch=vision.patch,
    )
    token_ids = batch["token_ids"]
    loss_mask = batch.get("loss_mask")
    if loss_mask is None:
        loss_mask = np.ones_like(token_ids)
    return {
        "patch_tokens": patches,
        "token_ids": torch.from_numpy(np.asarray(token_ids)).to(dev, torch.long),
        "loss_mask": torch.from_numpy(np.asarray(loss_mask)).to(dev),
    }
