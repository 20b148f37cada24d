"""Question answering: retrieval on the device and a cited answer. The port
of vision_compression_project_tpu/pipeline/qa.py.

`answer_question(doc_id, question, top_k, max_chars_per_page, ...)` ->
{answer_md, retrieved}, with the reference's surface: the evidence pack
'[Page N | memory_id=...]\n<content cut to max_chars + "... [truncated]">'
joined by '\n\n---\n\n', the 'Not found in provided pages.' sentinel on an
empty retrieval, inline citations '(doc_id p.N)' and 250-char excerpts.

Retrieval is one masked-similarity kernel launch and a top-k on the card.
Answering has three engines: 'analytic' (deterministic aggregation,
pipeline/aggregate.py), 'extractive' (evidence sentences ranked by embedding
similarity, composed into cited markdown) and 'lm' (the decoder,
`VLMRunner.answer`). 'auto' tries analytic first for aggregation-shaped
questions, then 'lm' when a shipped checkpoint declares answer-task training,
else 'extractive'. 'lm' uses an injected `runner`, else the shipped
answer-trained checkpoint's (`_get_answer_runner`, on the card).
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .. import config
from ..config import EXCERPT_CHARS, RUNTIME, TRUNCATION_MARKER
from ..utils import METRICS
from .ingest import _get_embedder

NOT_FOUND = "Not found in provided pages."
_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_STOPWORDS = frozenset(
    "a an and are as at be by can could do does did for from has have how in "
    "is it its may might of on or shall should that the this to was we were "
    "what when where which who whom why will with would".split()
)


def lm_answer_available() -> bool:
    """True when an answer-task-trained checkpoint resolves: the condition
    under which engine 'auto' selects generation over extraction."""
    return config.resolve_answer_preset() is not None


_ANSWER_RUNNER_CACHE: Dict[tuple, object] = {}
_ANSWER_RUNNER_LOCK = threading.Lock()  # the server's request threads share the cache


def _get_answer_runner():
    """The runner serving generated answers: the extraction runner when its
    preset is the answer preset, else a runner of the best answer-trained
    shipped checkpoint, built once per (preset, checkpoint) on RUNTIME.device."""
    from .extract import _get_runner

    resolved = config.resolve_answer_preset()
    if resolved is None:
        return _get_runner()  # engine forced to 'lm': use what serves extraction
    preset, ckpt = resolved
    if preset == config.resolve_model_preset():
        return _get_runner()
    with _ANSWER_RUNNER_LOCK:
        if resolved not in _ANSWER_RUNNER_CACHE:
            from ..models import get_preset
            from ..train.checkpoint import load_runner

            _ANSWER_RUNNER_CACHE[resolved] = load_runner(get_preset(preset), ckpt, device=config.RUNTIME.device)
        return _ANSWER_RUNNER_CACHE[resolved]


def _extract_result_info(result, manifest: Optional[Dict]):
    """(memory_id, page, content) from a search result, using the manifest
    reverse lookup when metadata lacks the page
    (reference: qa.py:102-156)."""
    if isinstance(result, dict):
        memory_id = result.get("id") or result.get("memory_id", "")
        metadata = result.get("metadata", {}) or {}
        content = result.get("content") or result.get("text")
    else:  # duck-typed objects
        memory_id = getattr(result, "id", "")
        metadata = getattr(result, "metadata", {}) or {}
        content = getattr(result, "content", None) or getattr(result, "text", None)

    page_number = metadata.get("page")
    if page_number is None and manifest:
        for entry in manifest.get("pages", []):
            if entry.get("memory_id") == memory_id:
                page_number = entry.get("page")
                break
    if page_number is None:
        return None
    if content is None:
        content = str(result) if result else ""
    elif not isinstance(content, str):
        content = str(content)
    if not content.strip():
        return None
    return memory_id, page_number, content


def _build_evidence_pack(
    results: List, manifest: Optional[Dict], doc_id: str, max_chars_per_page: int
) -> str:
    sections = []
    for result in results:
        info = _extract_result_info(result, manifest)
        if info is None:
            continue
        memory_id, page_number, content = info
        if len(content) > max_chars_per_page:
            content = content[:max_chars_per_page] + TRUNCATION_MARKER
        sections.append(f"[Page {page_number} | memory_id={memory_id}]\n{content}")
    return "\n\n---\n\n".join(sections)


def rewrite_query(question: str, max_phrases: int = 3) -> List[str]:
    """Deterministic query rewrite: content-word phrases (the CLI-only
    feature the reference implemented with an extra Gemini round-trip,
    reference scripts/qa_with_supermemory_and_gemini.py:189-232)."""
    words = re.findall(r"[A-Za-z0-9][A-Za-z0-9'-]*", question.lower())
    content = [w for w in words if w not in _STOPWORDS and len(w) > 1]
    if not content:
        return [question]
    phrases = [" ".join(content)]
    if len(content) > 3:
        phrases.append(" ".join(content[: len(content) // 2]))
        phrases.append(" ".join(content[len(content) // 2 :]))
    return phrases[:max_phrases]


def rewrite_query_learned(
    question: str, embedder, max_phrases: int = 3
) -> List[str]:
    """MODEL-BASED query rewrite — the learned counterpart of the
    reference's extra Gemini round trip (reference
    scripts/qa_with_supermemory_and_gemini.py:189-232).

    Candidate content-word n-gram phrases are scored by the embedding
    model IN THE SAME SPACE the index searches (cosine to the full-question
    embedding), so the rewrites are optimized for what retrieval can
    actually match, and near-duplicate phrases are suppressed by mutual
    similarity.  Returns [full content phrase, top-scoring diverse
    sub-phrases...], falling back to the deterministic rewrite when no
    candidates survive."""
    words = re.findall(r"[A-Za-z0-9][A-Za-z0-9'-]*", question.lower())
    content = [w for w in words if w not in _STOPWORDS and len(w) > 1]
    if len(content) < 2:
        return rewrite_query(question, max_phrases)
    full = " ".join(content)
    cands: List[str] = []
    for n in range(2, min(4, len(content)) + 1):
        for i in range(len(content) - n + 1):
            phrase = " ".join(content[i : i + n])
            if phrase != full and phrase not in cands:
                cands.append(phrase)
    if not cands:
        return [full]
    vecs = np.asarray(embedder.embed([question] + cands), np.float32)
    qv, cv = vecs[0], vecs[1:]
    sims = cv @ qv
    order = np.argsort(-sims)
    chosen: List[int] = []
    for idx in order:
        if len(chosen) >= max_phrases - 1:
            break
        # diversity: skip candidates that mostly repeat a chosen phrase
        if any(float(cv[idx] @ cv[j]) > 0.9 for j in chosen):
            continue
        chosen.append(int(idx))
    return [full] + [cands[i] for i in chosen]


def _compose_extractive_answer(
    question: str,
    results: List[Dict],
    manifest: Optional[Dict],
    doc_id: str,
    max_chars_per_page: int,
    embedder,
    max_claims: int = 5,
    question_vec=None,
) -> str:
    """Rank evidence sentences by embedding similarity to the question and
    compose cited markdown.  Citations are correct by construction: each
    sentence cites the page it came from.

    When the index stored per-sentence vectors (multi-vector mode), they are
    reused here: answer composition then embeds nothing but the question."""
    candidates = []  # (sentence, page)
    stored_vecs = []  # aligned stored vectors (or None)
    for result in results:
        info = _extract_result_info(result, manifest)
        if info is None:
            continue
        _, page_number, content = info
        sentences_meta = result.get("metadata", {}).get("sentences") if isinstance(result, dict) else None
        vectors = result.get("vectors") if isinstance(result, dict) else None
        if sentences_meta and vectors is not None and len(vectors) >= 1:
            # vectors row 0 is the pooled page vector; rows 1.. align with sentences_meta.
            for j, sentence in enumerate(sentences_meta):
                if j + 1 < len(vectors) and 20 <= len(sentence) <= 500:
                    candidates.append((sentence, page_number))
                    stored_vecs.append(np.asarray(vectors[j + 1]))
            continue
        content = content[:max_chars_per_page]
        for sentence in _SENT_RE.split(" ".join(content.split())):
            sentence = sentence.strip()
            if 20 <= len(sentence) <= 500:
                candidates.append((sentence, page_number))
                stored_vecs.append(None)
    if not candidates:
        return NOT_FOUND
    if question_vec is None:
        question_vec = embedder.embed([question])[0]
    missing = [i for i, v in enumerate(stored_vecs) if v is None]
    if missing:
        fresh = embedder.embed([candidates[i][0] for i in missing])
        for i, v in zip(missing, fresh):
            stored_vecs[i] = v
    vecs = np.stack(stored_vecs)
    sims = vecs @ np.asarray(question_vec)
    order = np.argsort(-sims)
    chosen = []
    seen = set()
    for idx in order:
        sentence, page = candidates[int(idx)]
        key = sentence.lower()[:80]
        if key in seen:
            continue
        seen.add(key)
        chosen.append((sentence, page, float(sims[int(idx)])))
        if len(chosen) >= max_claims:
            break
    if not chosen or chosen[0][2] <= 0.0:
        return NOT_FOUND
    lines = []
    for sentence, page, _ in chosen:
        lines.append(f"- {sentence} ({doc_id} p.{page})")
    pages_cited = sorted({page for _, page, _ in chosen})
    cite_all = ", ".join(f"p.{p}" for p in pages_cited)
    header = f"Based on the retrieved pages ({doc_id} {cite_all}):\n"
    return header + "\n" + "\n".join(lines)


def answer_question(
    doc_id: str,
    question: str,
    top_k: int = 8,
    max_chars_per_page: int = 1500,
    model: Optional[str] = None,
    manifest_path: Optional[Path] = None,
    store=None,
    embedder=None,
    runner=None,
    engine: Optional[str] = None,
) -> Dict:
    """Retrieve + answer.  Returns {"answer_md": str, "retrieved": [
    {"page", "memory_id", "excerpt"}]} exactly like the reference, with the
    reference's signature. `model` is accepted and unused, as there (the HTTP
    layer passes it). `runner` serves engine 'lm' (a VLMRunner of an
    answer-trained preset)."""
    embedder = embedder or _get_embedder()
    if store is None:
        from ..index import get_default_store

        store = get_default_store(dim=embedder.dim)
    engine = engine or RUNTIME.answer_engine
    # 'auto' resolves AFTER retrieval: aggregation-shaped questions go to
    # the deterministic analytic engine first (strictly more reliable than
    # generation on computable claims — pipeline/aggregate.py), then the
    # trained LM, then extraction.

    manifest = None
    if manifest_path and Path(manifest_path).exists():
        try:
            manifest = json.loads(Path(manifest_path).read_text(encoding="utf-8"))
        except Exception:  # an unreadable manifest is ignored, as in the reference
            pass

    with METRICS.timer("qa.retrieve"):
        if getattr(store, "mode", "single") == "multi":
            # Query SET for late-interaction scoring: the question plus its
            # full content-word rewrite.
            query_vec = embedder.embed([question] + rewrite_query(question)[:1])
        else:
            query_vec = embedder.embed([question])
        results = store.search(query_vec, top_k=top_k, doc_id=doc_id)[0]
    METRICS.count("qa.queries", 1)
    if not results:
        return {"answer_md": NOT_FOUND, "retrieved": []}

    evidence_pack = _build_evidence_pack(results, manifest, doc_id, max_chars_per_page)
    if not evidence_pack:
        return {"answer_md": NOT_FOUND, "retrieved": []}

    answer_md = None
    if engine in ("auto", "analytic"):
        from .aggregate import try_analytic_answer

        answer_md = try_analytic_answer(
            question, results, manifest, doc_id, max_chars_per_page
        )
        if answer_md is None:
            engine = (
                "lm" if engine == "auto" and lm_answer_available()
                else "extractive"
            )
    if answer_md is not None:
        pass
    elif engine == "lm":
        if runner is None:
            runner = _get_answer_runner()
        answer_md = runner.answer(question, evidence_pack)
        if not answer_md.strip():
            answer_md = NOT_FOUND
    elif engine == "extractive":
        answer_md = _compose_extractive_answer(
            question, results, manifest, doc_id, max_chars_per_page, embedder,
            question_vec=np.asarray(query_vec)[0],
        )
    else:
        raise ValueError(f"unknown answer engine {engine!r}")

    retrieved = []
    for result in results:
        info = _extract_result_info(result, manifest)
        if info:
            memory_id, page_number, content = info
            retrieved.append(
                {
                    "page": page_number,
                    "memory_id": memory_id,
                    "excerpt": content[:EXCERPT_CHARS],
                }
            )
    return {"answer_md": answer_md, "retrieved": retrieved}
