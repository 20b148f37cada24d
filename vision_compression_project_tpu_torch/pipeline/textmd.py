"""Deterministic text-layer -> {markdown, entities, summary} structuring: the
port's copy of vision_compression_project_tpu/pipeline/textmd.py.

The "text engine": when a PDF carries a text layer (extracted by the C++
engine), structured page JSON is produced without any model in the loop —
exact, fast, and deterministic.  Scanned/image-only pages fall through to
the VLM engine.  Output matches the normalized page-JSON contract the
reference guaranteed after its Gemini call
(reference: backend/app/pipeline/pdf_extract.py:171-189).
"""

from __future__ import annotations

import re
from typing import Dict, List

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_ENTITY_RE = re.compile(
    r"\b(?:[A-Z][A-Za-z0-9&.-]*(?:\s+[A-Z][A-Za-z0-9&.-]*){0,3})\b"
)
_NUMBER_RE = re.compile(r"\b\d[\d,.]*%?\b")


def text_to_markdown(text: str) -> str:
    """Heuristic markdown: short standalone lines become headings, paragraph
    breaks are preserved, list-ish lines become bullets."""
    out_lines: List[str] = []
    paragraphs = re.split(r"\n\s*\n", text.strip())
    for pi, para in enumerate(paragraphs):
        lines = [ln.strip() for ln in para.splitlines() if ln.strip()]
        if not lines:
            continue
        if len(lines) == 1 and len(lines[0]) < 64 and not lines[0].endswith("."):
            level = "#" if pi == 0 else "##"
            out_lines.append(f"{level} {lines[0]}")
        else:
            for ln in lines:
                if re.match(r"^([-*•]|\d+[.)])\s+", ln):
                    ln = re.sub(r"^[•]\s*", "- ", ln)
                    out_lines.append(ln)
                else:
                    out_lines.append(ln)
        out_lines.append("")
    return "\n".join(out_lines).strip()


def extract_entities(text: str, cap: int = 20) -> List[str]:
    """Capitalized phrases + salient numbers, de-duplicated, first-seen order."""
    seen = set()
    entities: List[str] = []
    for match in _ENTITY_RE.finditer(text):
        phrase = match.group(0).strip()
        if len(phrase) < 3 or phrase.lower() in ("the", "this", "that"):
            continue
        key = phrase.lower()
        if key not in seen:
            seen.add(key)
            entities.append(phrase)
        if len(entities) >= cap:
            return entities
    for match in _NUMBER_RE.finditer(text):
        num = match.group(0)
        if len(num) < 2:
            continue
        if num not in seen:
            seen.add(num)
            entities.append(num)
        if len(entities) >= cap:
            break
    return entities


def summarize(text: str, max_chars: int = 300) -> str:
    """First sentences up to max_chars."""
    flat = " ".join(text.split())
    sentences = _SENT_RE.split(flat)
    out = ""
    for s in sentences:
        if not s:
            continue
        if out and len(out) + len(s) + 1 > max_chars:
            break
        out = (out + " " + s).strip()
        if len(out) >= max_chars:
            out = out[:max_chars].rstrip()
            break
    return out


def structure_page(text: str, page_number: int) -> Dict:
    """Full text-engine page record with the guaranteed four keys."""
    return {
        "page_number": page_number,
        "markdown": text_to_markdown(text),
        "entities": extract_entities(text),
        "summary": summarize(text),
    }
