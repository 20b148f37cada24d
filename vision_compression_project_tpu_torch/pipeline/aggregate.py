"""Analytic aggregation answer engine: the port's copy of
vision_compression_project_tpu/pipeline/aggregate.py. Deterministic count /
sum / superlative answers computed from the evidence, with citations correct
by construction; `try_analytic_answer` returns None whenever the question
does not parse as an aggregation or the evidence does not support a
confident computation, so the engine never guesses.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_NUM_RE = r"(\d[\d,]*(?:\.\d+)?)"

# Question shapes.  Each returns (kind, slots) or None.
_COUNT_PAGES_RE = re.compile(
    r"how many pages\s+(?:mention|cover|discuss|contain|reference|describe)"
    r"\s+(?:the\s+)?(.+?)\s*\??$",
    re.IGNORECASE,
)
_SUM_RE = re.compile(
    r"how many\s+([a-z][\w ]*?)\s+(?:were|was|are|is|have|had)\b.*?"
    r"\b(?:in total|total|altogether|combined)\b",
    re.IGNORECASE,
)
_SUM_ACROSS_RE = re.compile(r"across all\s+([a-z]\w*?)s\b", re.IGNORECASE)
_MAX_RE = re.compile(
    r"which\s+([a-z]\w*)\s+(?:produced|had|has|recorded|reported|generated|"
    r"logged|showed|handled|processed)\s+the\s+"
    r"(most|highest|largest|greatest|fewest|least|lowest|smallest)\s+"
    r"([a-z][\w ]*?)\s*\??$",
    re.IGNORECASE,
)


def classify_question(question: str) -> Optional[Tuple[str, Dict]]:
    """(kind, slots) for aggregation-shaped questions, else None."""
    q = " ".join(question.split())
    m = _MAX_RE.search(q)
    if m:
        is_min = m.group(2).lower() in ("fewest", "least", "lowest", "smallest")
        return ("min" if is_min else "max",
                {"subject": m.group(1).lower(), "item": m.group(3).lower(),
                 "word": m.group(2).lower()})
    m = _COUNT_PAGES_RE.search(q)
    if m:
        return "count", {"phrase": m.group(1).lower()}
    m = _SUM_RE.search(q)
    if m:
        across = _SUM_ACROSS_RE.search(q)
        return "sum", {"item": m.group(1).lower(),
                       "subject": across.group(1).lower() if across else None}
    return None


def _item_head(item: str) -> str:
    """Head noun of an item phrase ('defect reports' -> 'reports')."""
    words = item.strip().split()
    return words[-1] if words else item


def _numeric_facts(
    pages: List[Tuple[int, str]], item: str, subject: Optional[str]
) -> List[Dict]:
    """(page, name, value, sentence) for sentences stating '<N> <item>'.
    The entity name binds to the token after the subject word when given
    ('plant delta produced ...' -> 'delta'), else to the sentence's first
    capitalized non-initial token."""
    head = re.escape(_item_head(item))
    num_item = re.compile(rf"\b{_NUM_RE}\s+(?:\w+\s+)?{head}\b", re.IGNORECASE)
    facts = []
    for page, content in pages:
        for sent in _SENT_RE.split(" ".join(content.split())):
            m = num_item.search(sent)
            if not m:
                continue
            try:
                value = float(m.group(1).replace(",", ""))
            except ValueError:
                continue
            name = None
            if subject:
                nm = re.search(rf"\b{re.escape(subject)}\s+([\w-]+)", sent,
                               re.IGNORECASE)
                if nm:
                    name = nm.group(1).lower()
            if name is None:
                caps = re.findall(r"(?<!^)(?<![.!?]\s)\b([A-Z][a-z]+)", sent)
                name = caps[0].lower() if caps else None
            facts.append({"page": page, "name": name, "value": value,
                          "sentence": sent.strip()})
    return facts


def _fmt_value(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def _compose(doc_id: str, cited: List[int], claim: str,
             support: List[Tuple[str, int]]) -> str:
    cite_str = ", ".join(f"p.{p}" for p in sorted(set(cited)))
    lines = [f"- {claim} ({doc_id} {cite_str})"]
    for sent, page in support[:4]:
        lines.append(f"- {sent} ({doc_id} p.{page})")
    return (
        f"Based on the retrieved pages ({doc_id} {cite_str}):\n\n"
        + "\n".join(lines)
    )


def try_analytic_answer(
    question: str,
    results: List[Dict],
    manifest: Optional[Dict],
    doc_id: str,
    max_chars_per_page: int,
) -> Optional[str]:
    """Deterministic aggregation answer, or None when the question isn't
    aggregation-shaped / the evidence doesn't support a confident one."""
    parsed = classify_question(question)
    if parsed is None:
        return None
    kind, slots = parsed

    from .qa import _extract_result_info

    pages: List[Tuple[int, str]] = []
    for result in results:
        info = _extract_result_info(result, manifest)
        if info is None:
            continue
        _, page_number, content = info
        pages.append((page_number, content[:max_chars_per_page]))
    if not pages:
        return None

    if kind == "count":
        phrase = slots["phrase"]
        hits = [
            (p, c) for p, c in pages
            if phrase in " ".join(c.split()).lower()
        ]
        if not hits:
            return None
        claim = (
            f"{len(hits)} of the {len(pages)} pages mention the {phrase}"
        )
        support = []
        for p, c in hits:
            for sent in _SENT_RE.split(" ".join(c.split())):
                if phrase in sent.lower():
                    support.append((sent.strip(), p))
                    break
        return _compose(doc_id, [p for p, _ in hits], claim, support)

    facts = _numeric_facts(pages, slots["item"], slots.get("subject"))
    if kind == "sum":
        if len(facts) < 2:
            return None  # a "total" over one number is not aggregation
        total = sum(f["value"] for f in facts)
        subject = slots.get("subject")
        claim = (
            f"The {subject}s produced {_fmt_value(total)} {slots['item']} "
            f"in total" if subject else
            f"In total, {_fmt_value(total)} {slots['item']}"
        )
        return _compose(
            doc_id, [f["page"] for f in facts], claim,
            [(f["sentence"], f["page"]) for f in facts],
        )

    # max / min
    named = [f for f in facts if f["name"]]
    if len(named) < 2:
        return None
    pick = (max if kind == "max" else min)(named, key=lambda f: f["value"])
    best_v = pick["value"]
    if sum(1 for f in named if f["value"] == best_v) > 1:
        return None  # tie: no single answer
    word = "most" if kind == "max" else "fewest"
    subject = slots["subject"]
    claim = (
        f"{subject.capitalize()} {pick['name']} produced the {word} "
        f"{slots['item']} ({_fmt_value(best_v)})"
    )
    return _compose(doc_id, [pick["page"]], claim,
                    [(pick["sentence"], pick["page"])])
