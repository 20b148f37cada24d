"""Tolerant JSON helpers: the port's copy of
vision_compression_project_tpu/utils/json_utils.py. Legacy page artifacts
store model output wrapped in markdown code fences and sometimes cut off
mid-stream; these helpers read them."""

from __future__ import annotations

import json
from typing import Any, Optional


def strip_code_fences(text: str) -> str:
    """Remove a leading ```/```json fence and a trailing ``` fence if present."""
    if not isinstance(text, str):
        return text
    s = text.strip()
    if s.startswith("```"):
        first_newline = s.find("\n")
        if first_newline != -1:
            s = s[first_newline + 1 :]
        else:
            s = ""
    if s.rstrip().endswith("```"):
        s = s.rstrip()
        s = s[: -3]
    return s.strip()


def repair_truncated_json(text: str) -> Optional[Any]:
    """Parse JSON cut off mid-stream (a model hitting its token budget mid
    string).  Scans string/escape state and the open
    bracket stack, trims a dangling escape/comma/colon, closes the open
    string and brackets, then parses.  Returns None if still unparseable."""
    stack = []
    in_str = False
    esc = False
    for ch in text:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch in "{[":
            stack.append(ch)
        elif ch in "}]":
            if stack:
                stack.pop()
    if not stack and not in_str:
        return None  # nothing was open: not a truncation problem
    fixed = text
    if esc:
        fixed = fixed[:-1]  # truncated mid escape sequence
    if in_str:
        fixed += '"'
    stripped = fixed.rstrip()
    if stripped.endswith(","):
        stripped = stripped[:-1]
    elif stripped.endswith(":"):
        stripped += " null"
    fixed = stripped + "".join("}" if c == "{" else "]" for c in reversed(stack))
    try:
        return json.loads(fixed)
    except (json.JSONDecodeError, ValueError):
        return None


def safe_json_loads(text: str) -> Optional[Any]:
    """Parse JSON after stripping code fences; return None on failure.

    Recovery ladder beyond the reference's parse (reference
    backend/app/pipeline/utils.py:34-53, which returns None on anything
    non-well-formed): outermost-braces salvage for prose-wrapped JSON, then
    truncation repair — so a page whose extraction was cut off mid-markdown
    still yields its real text instead of the raw fenced blob."""
    if text is None:
        return None
    if not isinstance(text, str):
        return None
    candidate = strip_code_fences(text)
    if not candidate:
        return None
    try:
        return json.loads(candidate)
    except (json.JSONDecodeError, ValueError):
        pass
    # Salvage: find the outermost {...} span (models sometimes prepend prose).
    start = candidate.find("{")
    end = candidate.rfind("}")
    if start != -1 and end > start:
        try:
            return json.loads(candidate[start : end + 1])
        except (json.JSONDecodeError, ValueError):
            pass
    if start != -1:
        return repair_truncated_json(candidate[start:])
    return None
