"""The one generator of the benchmark's inputs. A traffic mix is a data file
(traffic/<mix>.json) of parameters; this module makes its inputs from the
run's seed: gray page rasters with lines of dark word blocks on white, and,
for training, target id rows in the extraction grammar
(BOS TASK text... SEP text... SEP text... EOS, then PAD). The same seed gives
the same inputs, and every row of a pool differs."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference.tokens import BOS_ID, EOS_ID, PAD_ID, SEP_ID, TASK_EXTRACT_ID, text_ids


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of the seed."""
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, stream])


def pages(rng: np.random.Generator, n: int, h: int, w: int, lines: int) -> np.ndarray:
    """(n, h, w) uint8 pages: `lines` text lines of words (dark blocks of
    random widths and strokes) inside 1-inch-like margins, on white."""
    out = np.full((n, h, w), 255, np.uint8)
    top, left = h // 11, w // 9
    pitch = (h - 2 * top) // max(lines, 1)
    band = max(2, int(pitch * 0.55))
    for i in range(n):
        for line in range(lines):
            y0 = top + line * pitch
            cols = np.zeros(w, bool)
            x = left + int(rng.integers(0, pitch))
            end = w - left - int(rng.integers(0, 4 * pitch))
            while x < end:
                word = int(rng.integers(band // 2, 5 * band))
                cols[x:min(x + word, end)] = True
                x += word + int(rng.integers(band // 3, band))
            strokes = rng.integers(0, 110, size=(band, int(cols.sum())), dtype=np.uint8)
            out[i, y0:y0 + band][:, cols] = strokes
    return out


def targets(rng: np.random.Generator, n: int, text_len: int, min_text: int, tokenizer: str) -> np.ndarray:
    """(n, text_len) int32 target rows: BOS TASK_EXTRACT, then markdown,
    summary and entity text separated by SEP, EOS, then PAD; each row's
    length drawn from [min_text, text_len]."""
    ids = text_ids(tokenizer)
    out = np.full((n, text_len), PAD_ID, np.int32)
    for i in range(n):
        length = int(rng.integers(min(min_text, text_len), text_len + 1))
        body = ids[rng.integers(0, len(ids), size=length - 3)]
        cuts = np.sort(rng.choice(np.arange(1, len(body)), size=2, replace=False))
        body[cuts] = SEP_ID
        out[i, : length] = np.concatenate([[BOS_ID, TASK_EXTRACT_ID], body, [EOS_ID]])
    return out


def host_batches(traffic: dict, cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """traffic["pool"] host batches of traffic["batch"] rows, made from the
    seed: {"pages_u8": (B, H, W) uint8} and, where the mix has a text_len,
    {"token_ids": (B, text_len) int32}."""
    b, pool = traffic["batch"], traffic["pool"]
    rng = rng_for(seed, 1)
    out = []
    for _ in range(pool):
        batch = {"pages_u8": pages(rng, b, traffic["page_h"], traffic["page_w"], traffic["lines"])}
        if "text_len" in traffic:
            batch["token_ids"] = targets(rng, b, traffic["text_len"], traffic.get("min_text", traffic["text_len"]),
                                         cfg["decoder"]["tokenizer"])
        out.append(batch)
    return out
