"""API request/response schemas without pydantic: the port's counterpart of
vision_compression_project_tpu/schemas.py.

The six models are dataclasses with the reference's fields, defaults, bounds
and key order (`model_dump()`). `ChatRequest.model_validate_json(body)`
parses and validates a request body as pydantic v2 does in its lax mode for
these field types, and raises this module's `ValidationError`, whose
`.errors()` carry pydantic's `type`, `loc`, `msg`, `input` and `ctx`, in
pydantic's key order, and whose `.json()` is pydantic's compact JSON of them.

Two known differences from pydantic: no error carries a `url` (it names a
pydantic version), and for `json_invalid` the wording of `msg` and
`ctx.error` comes from Python's JSON parser, not pydantic's. A body that is
not UTF-8 is `json_invalid` here; pydantic reports the same error but fails
to serialise it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

from .config import DEFAULT_MAX_CHARS_PER_PAGE, DEFAULT_TOP_K

# Characters stripped around a numeric string (Unicode White_Space, as
# pydantic trims them; Python's str.strip() would also take U+001C-U+001F).
_WHITESPACE = "".join(
    chr(c)
    for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
              0x205F, 0x3000)
)
# An integer string: ASCII digits with single underscores between them, and
# an optional fraction of zeros only.
_INT_STRING = re.compile(r"([+-]?)([0-9]+(?:_[0-9]+)*)(?:\.0+)?")
_MAX_INT_DIGITS = 4300  # longer integer strings are "exceeded maximum size"
_MAX_JSON_DEPTH = 200  # a value inside more containers is refused as JSON


class ValidationError(ValueError):
    """Validation errors of one model, each a dict with pydantic's keys."""

    def __init__(self, errors: List[Dict[str, Any]], title: str):
        self._errors = errors
        super().__init__(f"{len(errors)} validation error{'s' if len(errors) > 1 else ''} for {title}")

    def errors(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._errors]

    def json(self) -> str:
        return _dumps(self._errors)


def _error(type_: str, loc: Tuple, msg: str, value: Any, ctx: Optional[Dict] = None) -> Dict[str, Any]:
    err = {"type": type_, "loc": list(loc), "msg": msg, "input": value}
    if ctx is not None:
        err["ctx"] = ctx
    return err


def _float_json(x: float) -> str:
    """A float as pydantic writes it: shortest round-trip digits, the
    decimal form from 1e-5 up to 1e16, else an exponent with no '+' and no
    leading zeros ("1e16", "1e-7")."""
    if not math.isfinite(x):
        return "NaN" if math.isnan(x) else ("Infinity" if x > 0 else "-Infinity")
    text = repr(x)
    if "e" not in text:
        return text
    mantissa, exp = text.split("e")
    exp = int(exp)
    if exp == -5:  # repr() writes 1e-05; pydantic writes 0.00001
        sign, digits = ("-", mantissa[1:]) if mantissa.startswith("-") else ("", mantissa)
        return f"{sign}0.0000{digits.replace('.', '')}"
    return f"{mantissa}e{exp}"


def _dumps(value: Any) -> str:
    """Compact JSON with raw (not escaped) non-ASCII text, as pydantic
    serialises errors."""
    if isinstance(value, dict):
        return "{" + ",".join(f"{_dumps(str(k))}:{_dumps(v)}" for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(_dumps(v) for v in value) + "]"
    if isinstance(value, float):
        return _float_json(value)
    return json.dumps(value, ensure_ascii=False)


def _too_deep(value: Any) -> bool:
    stack = [(value, 0)]
    while stack:
        item, depth = stack.pop()
        if depth > _MAX_JSON_DEPTH:
            return True
        if isinstance(item, dict):
            stack.extend((v, depth + 1) for v in item.values())
        elif isinstance(item, list):
            stack.extend((v, depth + 1) for v in item)
    return False


def _has_lone_surrogate(value: Any) -> bool:
    stack = [value]
    while stack:
        item = stack.pop()
        if isinstance(item, str):
            if any("\ud800" <= c <= "\udfff" for c in item):
                return True
        elif isinstance(item, dict):
            stack.extend(item.keys())
            stack.extend(item.values())
        elif isinstance(item, list):
            stack.extend(item)
    return False


def _parse_json(data, title: str) -> Any:
    """The body as a JSON value, or ValidationError([json_invalid])."""
    def invalid(reason: str, text: str):
        return ValidationError(
            [_error("json_invalid", (), f"Invalid JSON: {reason}", text, {"error": reason})], title
        )

    if isinstance(data, (bytes, bytearray)):
        try:
            text = bytes(data).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise invalid(str(exc), bytes(data).decode("utf-8", "replace")) from None
    else:
        text = data
    try:
        value = json.loads(text)
    except (ValueError, RecursionError) as exc:
        raise invalid(str(exc) or "recursion limit exceeded", text) from None
    if _too_deep(value):
        raise invalid("recursion limit exceeded", text)
    if _has_lone_surrogate(value):
        raise invalid("lone surrogate in a string escape", text)
    return value


def _as_int(value: Any) -> Tuple[Optional[int], Optional[Tuple[str, str]]]:
    """(int, None), or (None, (error type, message)): pydantic's lax int from
    a JSON value."""
    if isinstance(value, bool):
        return int(value), None
    if isinstance(value, int):
        return value, None
    if isinstance(value, float):
        if not math.isfinite(value):
            return None, ("finite_number", "Input should be a finite number")
        if value != math.floor(value):
            return None, ("int_from_float", "Input should be a valid integer, got a number with a fractional part")
        if abs(value) >= 2.0**63:
            return None, ("int_parsing_size", "Unable to parse input string as an integer, exceeded maximum size")
        return int(value), None
    if isinstance(value, str):
        match = _INT_STRING.fullmatch(value.strip(_WHITESPACE))
        if match is None:
            return None, ("int_parsing", "Input should be a valid integer, unable to parse string as an integer")
        sign, digits = match.group(1), match.group(2).replace("_", "").lstrip("0") or "0"
        if len(digits) > _MAX_INT_DIGITS:
            return None, ("int_parsing_size", "Unable to parse input string as an integer, exceeded maximum size")
        return int(sign + digits), None
    return None, ("int_type", "Input should be a valid integer")


@dataclasses.dataclass(frozen=True)
class _Field:
    name: str
    type: type
    required: bool = True
    ge: Optional[int] = None
    le: Optional[int] = None


def _validate_fields(fields: Tuple[_Field, ...], data: Dict[str, Any]):
    """(values, errors) of a JSON object against the fields, in field order.
    Absent optional fields are left out of the values (the dataclass
    default applies, unvalidated, as in pydantic)."""
    values, errors = {}, []
    for field in fields:
        loc = (field.name,)
        if field.name not in data:
            if field.required:
                errors.append(_error("missing", loc, "Field required", data))
            continue
        raw = data[field.name]
        if field.type is str:
            if not isinstance(raw, str):
                errors.append(_error("string_type", loc, "Input should be a valid string", raw))
                continue
            values[field.name] = raw
            continue
        number, problem = _as_int(raw)
        if problem is not None:
            errors.append(_error(problem[0], loc, problem[1], raw))
        elif field.ge is not None and number < field.ge:
            errors.append(_error("greater_than_equal", loc, f"Input should be greater than or equal to {field.ge}",
                                 raw, {"ge": field.ge}))
        elif field.le is not None and number > field.le:
            errors.append(_error("less_than_equal", loc, f"Input should be less than or equal to {field.le}",
                                 raw, {"le": field.le}))
        else:
            values[field.name] = number
    return values, errors


class _Model:
    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(kw_only=True)
class ChatRequest(_Model):
    doc_id: str  # Document ID
    question: str  # Question to answer
    top_k: int = DEFAULT_TOP_K  # Number of top results to retrieve, in [1, 50]
    max_chars_per_page: int = DEFAULT_MAX_CHARS_PER_PAGE  # per page in the evidence pack, in [100, 10000]

    _FIELDS = (
        _Field("doc_id", str),
        _Field("question", str),
        _Field("top_k", int, required=False, ge=1, le=50),
        _Field("max_chars_per_page", int, required=False, ge=100, le=10000),
    )

    def __post_init__(self):
        values, errors = _validate_fields(self._FIELDS, vars(self))
        if errors:
            raise ValidationError(errors, type(self).__name__)
        vars(self).update(values)

    @classmethod
    def model_validate_json(cls, data) -> "ChatRequest":
        """Parse a JSON body (bytes or str) and validate it."""
        value = _parse_json(data, cls.__name__)
        if not isinstance(value, dict):
            raise ValidationError(
                [_error("model_type", (), "Input should be an object", value, {"class_name": cls.__name__})],
                cls.__name__,
            )
        values, errors = _validate_fields(cls._FIELDS, value)
        if errors:
            raise ValidationError(errors, cls.__name__)
        return cls(**values)


@dataclasses.dataclass(kw_only=True)
class RetrievedPage(_Model):
    page: int  # Page number
    memory_id: str  # Memory ID in the vector index
    excerpt: str  # Excerpt from the page (first 250 chars)


@dataclasses.dataclass(kw_only=True)
class ChatResponse(_Model):
    doc_id: str  # Document ID
    answer_md: str  # Answer in markdown format with citations
    retrieved: List[RetrievedPage]  # List of retrieved pages


@dataclasses.dataclass(kw_only=True)
class FailedPage(_Model):
    page: int  # Page number
    error: str  # Error message


@dataclasses.dataclass(kw_only=True)
class IngestResponse(_Model):
    doc_id: str  # Generated document ID
    pages_total: int  # Total number of pages processed
    pages_ingested: int  # Number of successfully ingested pages
    failed_pages: List[FailedPage] = dataclasses.field(default_factory=list)
    manifest_path: str  # Path to the ingest manifest file


@dataclasses.dataclass(kw_only=True)
class HealthResponse(_Model):
    ok: bool  # Health status
