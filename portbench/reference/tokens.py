"""Token ids and the extraction task's logit mask, worked out from the raw
BPE merges file (the tokenizer's own data, which the port reads too). Ids
0..255 are bytes, 256..265 specials, merges from 266; the vocabulary is
padded up to a multiple of 128."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

PAD_ID, BOS_ID, EOS_ID, SEP_ID, TASK_EXTRACT_ID = 256, 257, 258, 259, 260
UNIT_SEP = 0x1F
FIRST_MERGE_ID = 266
BYTE_VOCAB = 512
MERGES_DIR = Path(__file__).resolve().parents[2] / "vision_compression_project_tpu_torch" / "models"


def expansions(tokenizer: str) -> Dict[int, bytes]:
    """Token id -> bytes for a configuration's `tokenizer` ("byte", "bpe" or
    "bpe:<merges file>")."""
    table = {i: bytes([i]) for i in range(256)}
    if tokenizer == "byte":
        return table
    name = tokenizer.split(":", 1)[1] if ":" in tokenizer else "bpe_merges.json"
    merges = json.loads((MERGES_DIR / name).read_text())["merges"]
    for r, (a, b) in enumerate(merges):
        table[FIRST_MERGE_ID + r] = table[a] + table[b]
    return table


def extract_mask(tokenizer: str, vocab: int) -> np.ndarray:
    """(vocab,) f32: 0 where the extraction grammar allows the id (text
    tokens of printable or whitespace bytes, SEP, EOS, the unit separator),
    -1e30 elsewhere."""
    allowed = set(range(0x20, 0x7F)) | set(range(0x80, 0x100)) | {0x09, 0x0A}
    mask = np.full((vocab,), -1e30, np.float32)
    for tid, exp in expansions(tokenizer).items():
        if exp and all(b in allowed for b in exp):
            mask[tid] = 0.0
    mask[[SEP_ID, EOS_ID, UNIT_SEP]] = 0.0
    return mask


def text_ids(tokenizer: str) -> np.ndarray:
    """Ids whose expansion is printable text: what a page's target draws from."""
    allowed = set(range(0x20, 0x7F))
    return np.asarray(sorted(t for t, e in expansions(tokenizer).items() if e and all(b in allowed for b in e)),
                      np.int64)
