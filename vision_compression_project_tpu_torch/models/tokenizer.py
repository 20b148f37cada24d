"""Byte-level and learned-BPE tokenizers, the same as the JAX package's
(vision_compression_project_tpu/models/tokenizer.py), with its own copies of
the merges files.

Token ids 0..255 are raw UTF-8 bytes; specials follow at 256..265; BPE merge
tokens start at 266. Byte fallback is structural: every text encodes, and
every token decodes to bytes. `BPETokenizer.train` learns a merge table
(scripts/train_bpe.py), `save` writes one.
"""

from __future__ import annotations

import heapq
import json
import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
SEP_ID = 259          # separates conditioning segments (e.g. question | evidence)
TASK_EXTRACT_ID = 260  # page-image -> structured JSON fields
TASK_ANSWER_ID = 261   # evidence pack -> cited answer
TASK_EMBED_ID = 262    # text -> embedding
FIELD_MARKDOWN_ID = 263
FIELD_ENTITIES_ID = 264
FIELD_SUMMARY_ID = 265

VOCAB_SIZE = 512  # byte vocab, padded up

N_SPECIALS = 10        # ids 256..265
FIRST_MERGE_ID = 266   # BPE merge tokens start here
DEFAULT_MERGES_PATH = Path(__file__).parent / "bpe_merges.json"


def _encode_batch(tok, texts: Sequence[str], max_len: int, add_bos: bool) -> tuple:
    """Pad/truncate to (B, max_len) int32 ids plus (B,) lengths."""
    batch = np.full((len(texts), max_len), PAD_ID, np.int32)
    lengths = np.zeros((len(texts),), np.int32)
    for i, t in enumerate(texts):
        ids = tok.encode(t, add_bos=add_bos)[:max_len]
        batch[i, : len(ids)] = ids
        lengths[i] = len(ids)
    return batch, lengths


class ByteTokenizer:
    """UTF-8 byte tokenizer with special tokens."""

    vocab_size = VOCAB_SIZE
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    sep_id = SEP_ID
    cache_key = "byte"

    def expansions(self) -> dict:
        """token id -> byte expansion (text tokens only; no specials)."""
        return {i: bytes([i]) for i in range(256)}

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Sequence[str], max_len: int, add_bos: bool = False) -> tuple:
        return _encode_batch(self, texts, max_len, add_bos)


class BPETokenizer:
    """Byte-pair-encoding tokenizer with byte fallback and the same special
    tokens as ByteTokenizer (ids 256..265 are shared, so prompts, logit
    masks and field separators keep their meaning across tokenizers)."""

    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    sep_id = SEP_ID

    # GPT-2-style pretokens: a word keeps its leading space; whitespace runs
    # and digit runs stay separate so merges never cross word boundaries.
    _WORD_RE = re.compile(rb" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+")

    def __init__(self, merges: Sequence[Tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self._expand: Dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        self._rank: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for r, (a, b) in enumerate(self.merges):
            tid = FIRST_MERGE_ID + r
            self._expand[tid] = self._expand[a] + self._expand[b]
            self._rank[(a, b)] = (r, tid)
        raw = FIRST_MERGE_ID + len(self.merges)
        self.vocab_size = -(-raw // 128) * 128
        self.cache_key = f"bpe-{len(self.merges)}"
        self._word_cache: Dict[bytes, Tuple[int, ...]] = {}

    def save(self, path=None) -> Path:
        path = Path(path or DEFAULT_MERGES_PATH)
        path.write_text(json.dumps({"merges": self.merges}))
        return path

    @classmethod
    def load(cls, path=None) -> "BPETokenizer":
        path = Path(path or DEFAULT_MERGES_PATH)
        return cls(json.loads(path.read_text())["merges"])

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 4096, merge_digits: bool = False) -> "BPETokenizer":
        """Classic BPE with incremental pair counts and a lazy-deletion heap:
        the reference's algorithm, so the same texts give the same merges.

        merge_digits=False (the default) bans merges whose expansion is all
        ASCII digits (and spaces, with at least two digits): digit sequences
        are content (codes, measurements, years) that OCR must read digit by
        digit from the pixels."""
        word_counts: Counter = Counter()
        for t in texts:
            for m in cls._WORD_RE.finditer(t.encode("utf-8")):
                word_counts[m.group(0)] += 1
        words: Dict[bytes, List[int]] = {w: list(w) for w in word_counts}

        pair_counts: Counter = Counter()
        pair_words = defaultdict(set)
        for w, ids in words.items():
            c = word_counts[w]
            for p in zip(ids, ids[1:]):
                pair_counts[p] += c
                pair_words[p].add(w)
        heap = [(-c, p) for p, c in pair_counts.items()]
        heapq.heapify(heap)

        n_merges = max(0, vocab_size - FIRST_MERGE_ID)
        merges: List[Tuple[int, int]] = []
        expand: Dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        next_id = FIRST_MERGE_ID
        while len(merges) < n_merges and heap:
            negc, pair = heapq.heappop(heap)
            if pair_counts.get(pair, 0) != -negc:  # a stale heap entry
                continue
            if -negc < 2:
                break
            if not merge_digits:
                exp = expand.get(pair[0], b"") + expand.get(pair[1], b"")
                n_digits = sum(0x30 <= b <= 0x39 for b in exp)
                if n_digits >= 2 and all(0x30 <= b <= 0x39 or b == 0x20 for b in exp):
                    pair_counts.pop(pair, None)  # banned: a multi-digit merge
                    pair_words.pop(pair, None)
                    continue
            merges.append(pair)
            expand[next_id] = expand.get(pair[0], b"") + expand.get(pair[1], b"")
            a, b = pair
            touched: Counter = Counter()
            for w in list(pair_words.get(pair, ())):
                ids = words[w]
                c = word_counts[w]
                out: List[int] = []
                j = 0
                while j < len(ids):
                    if j + 1 < len(ids) and ids[j] == a and ids[j + 1] == b:
                        out.append(next_id)
                        j += 2
                    else:
                        out.append(ids[j])
                        j += 1
                for p in zip(ids, ids[1:]):
                    touched[p] -= c
                for p in zip(out, out[1:]):
                    touched[p] += c
                    pair_words[p].add(w)
                words[w] = out
            del pair_counts[pair]
            pair_words.pop(pair, None)
            for p, dc in touched.items():
                if dc == 0 or p == pair:
                    continue
                pair_counts[p] = pair_counts.get(p, 0) + dc
                if pair_counts[p] <= 0:
                    pair_counts.pop(p, None)
                else:
                    heapq.heappush(heap, (-pair_counts[p], p))
            next_id += 1
        return cls(merges)

    def _encode_word(self, wb: bytes) -> Tuple[int, ...]:
        cached = self._word_cache.get(wb)
        if cached is not None:
            return cached
        parts = list(wb)
        while len(parts) >= 2:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rk = self._rank.get((parts[i], parts[i + 1]))
                if rk is not None and (best_rank is None or rk[0] < best_rank[0]):
                    best_rank = rk
                    best_i = i
            if best_rank is None:
                break
            a, b = parts[best_i], parts[best_i + 1]
            tid = best_rank[1]
            out: List[int] = []
            j = 0
            while j < len(parts):
                if j + 1 < len(parts) and parts[j] == a and parts[j + 1] == b:
                    out.append(tid)
                    j += 2
                else:
                    out.append(parts[j])
                    j += 1
            parts = out
        result = tuple(parts)
        if len(self._word_cache) < 65536:
            self._word_cache[wb] = result
        return result

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        for m in self._WORD_RE.finditer(text.encode("utf-8")):
            ids.extend(self._encode_word(m.group(0)))
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        chunks = []
        for i in ids:
            exp = self._expand.get(int(i))
            if exp is not None:
                chunks.append(exp)
        return b"".join(chunks).decode("utf-8", errors="replace")

    def encode_batch(self, texts: Sequence[str], max_len: int, add_bos: bool = False) -> tuple:
        return _encode_batch(self, texts, max_len, add_bos)

    def expansions(self) -> Dict[int, bytes]:
        """token id -> byte expansion (text tokens only; no specials)."""
        return dict(self._expand)


def get_tokenizer(cfg=None, merges_path=None):
    """Tokenizer for a model config: DecoderConfig.tokenizer selects 'byte',
    'bpe' (the default merges) or 'bpe:<file>.json' (a merges file in this
    directory); the vocab size is checked against the config's: equal, or,
    for a decoder built from `layer_types` (a published architecture with a
    vocabulary of its own), at least the tokenizer's (rows past it are never
    emitted: the task masks close them)."""
    if isinstance(cfg, str):
        kind = cfg
    else:
        kind = getattr(getattr(cfg, "decoder", cfg), "tokenizer", "byte") if cfg else "byte"
    if kind == "byte":
        return ByteTokenizer()
    if kind.startswith("bpe"):
        if merges_path is None and ":" in kind:
            merges_path = Path(__file__).parent / kind.split(":", 1)[1]
        tok = BPETokenizer.load(merges_path)
        dec = getattr(cfg, "decoder", cfg)
        want = getattr(dec, "vocab", tok.vocab_size)
        wider = bool(getattr(dec, "layer_types", ())) and tok.vocab_size < want
        if tok.vocab_size != want and not wider:
            raise ValueError(f"BPE vocab {tok.vocab_size} != model vocab {want}")
        return tok
    raise ValueError(f"unknown tokenizer kind {kind!r}")
