"""The port's schemas (dataclasses, no pydantic) against the JAX package's
pydantic models: `ChatRequest.model_validate_json` on a list of bodies and on
random JSON objects over its four fields, and `model_dump` of every model.

Accepted bodies give equal dumps; refused bodies give equal errors (type,
loc, msg, input, ctx in pydantic's key order) and equal `.json()` once
pydantic's `url` is dropped. For `json_invalid` the msg and ctx wording comes
from each side's own JSON parser, so there only type, loc and input are held
equal (the port's README lists both differences)."""

import json
import re

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from pydantic import ValidationError as PydanticValidationError

from vision_compression_project_tpu import schemas as jschemas
from vision_compression_project_tpu_torch import schemas as tschemas

_URL = re.compile(r',"url":"https://errors\.pydantic\.dev/[^"]*"')


def _tk(value: str) -> bytes:
    return ('{"doc_id":"x","question":"q","top_k":%s}' % value).encode()


def _mc(value: str) -> bytes:
    return ('{"doc_id":"x","question":"q","max_chars_per_page":%s}' % value).encode()


BODIES = [
    # The contract's cases: lax coercions and each error type.
    _tk('"5"'), _tk("true"), _tk("5.0"), b'{"doc_id": "x"}', _tk("51"), b'{"doc_id": 1, "question": "q"}',
    b"[]", b"not json",
    # Every bound's edge.
    _tk("0"), _tk("1"), _tk("50"), _tk("51"), _mc("99"), _mc("100"), _mc("10000"), _mc("10001"),
    _tk("-1"), _tk("false"), _mc("true"), _tk("51.0"), _tk("0.0"), _tk("-0.0"), _tk("-0"),
    # Defaults, extra keys, key order, duplicates, whitespace around the body.
    b'{"doc_id":"x","question":"q"}', b'{"question":"q","doc_id":"x","extra":[1,{"a":null}],"top_k":3}',
    b'{"doc_id":"a","doc_id":"b","question":"q"}', b'  {"doc_id":"x","question":"q"}\n',
    # null in each field, several errors at once, missing everything.
    b'{"doc_id":null,"question":"q"}', b'{"doc_id":"x","question":null}', _tk("null"), _mc("null"),
    b'{"doc_id":null}', b"{}", b'{"top_k":0,"max_chars_per_page":10001}',
    b'{"doc_id":["x"],"question":{"q":1},"top_k":[],"max_chars_per_page":{}}',
    # Floats with a fraction, huge and non-finite numbers.
    _tk("5.5"), _tk("0.25"), _tk("1e-7"), _tk("1.5e-05"), _tk("1e-5"), _tk("0.30000000000000004"), _tk("1E2"),
    _tk("1e16"), _tk("1e15"), _tk("1e20"), _tk("9.2e18"), _tk("9.3e18"), _tk("-9.3e18"), _tk("1.7976931348623157e308"),
    _tk("1e400"), _tk("NaN"), _tk("Infinity"), _tk("-Infinity"), _tk("99999999999999999999999"),
    _tk("9223372036854775808.0"), _tk("9223372036854774784.0"), _tk("1.0000000000000001"),
    # Numeric strings: signs, zeros, underscores, decimal zeros, whitespace.
    _tk('" 5 "'), _tk('"5.0"'), _tk('"5.00"'), _tk('" +5.0"'), _tk('"05"'), _tk('"-5"'), _tk('"+0"'), _tk('"-0"'),
    _tk('"1_0"'), _tk('"0_5"'), _tk('"1_0.0"'), _tk('"5_000"'), _tk('"_1"'), _tk('"1_"'), _tk('"1__0"'),
    _tk('"5.5"'), _tk('"5."'), _tk('".5"'), _tk('"5.0_0"'), _tk('"5.-0"'), _tk('"1e1"'), _tk('"0x5"'),
    _tk('"abc"'), _tk('""'), _tk('"  "'), _tk('"5 6"'), _tk('"NaN"'), _tk('"inf"'), _tk('"++5"'),
    _tk('"99999999999999999999999"'), _tk('"-9223372036854775809"'), _tk('"5.000000000000000000000000000001"'),
    _tk('"\\u00a05"'), _tk('"\\u20005"'), _tk('"\\u30005"'), _tk('"\\u00855"'), _tk('"\\u000b5"'), _tk('"\\r5\\n"'),
    _tk('"\\u001c5"'), _tk('"\\u200b5"'), _tk('"\\ufeff5"'), _tk('"\\u0665"'), _tk('"\\uff15"'), _tk('"\\u00005"'),
    _tk('"%s"' % ("1" + "0" * 4299)), _tk('"%s"' % ("1" + "0" * 4300)), _tk('"%s"' % ("0" * 5000 + "5")),
    # Strings that are not ASCII, escapes, and JSON that is not an object.
    '{"doc_id":"é","question":"\\u4e2d\\ud83d\\ude00 /"}'.encode(), b'{"doc_id":"\\/x","question":"\\"q\\t"}',
    b'"str"', b"null", b"1", b"true", b'[{"doc_id":"x","question":"q"}]',
    # Not JSON: empty, trailing data, bad numbers, bad strings, too deep.
    b"", b"\n", b'{"doc_id":"x","question":"q"} x', _tk("01"), _tk("-"), _tk(".5"), _tk("5."), _tk("nan"),
    b'{"doc_id":"x","question":"q",}', b"{'doc_id':'x'}", b'{"doc_id":"a\tb","question":"q"}',
    _tk('"\\ud800"'), _tk('"\\udc00"'), b'\xef\xbb\xbf{"doc_id":"x","question":"q"}',
    b"[" * 201 + b"]" * 201, b"[" * 202 + b"]" * 202,
    b'{"doc_id":"x","question":"q","x":' + b"[" * 200 + b"]" * 200 + b"}",
    b'{"doc_id":"x","question":"q","x":' + b"[" * 201 + b"]" * 201 + b"}",
    b'{"doc_id":"x","question":"q","x":' + b'{"a":' * 199 + b"1" + b"}" * 199 + b"}",
    b'{"doc_id":"x","question":"q","x":' + b'{"a":' * 200 + b"1" + b"}" * 200 + b"}",
]


def _both(body):
    """(port outcome, JAX outcome): ("ok", dump) or ("err", errors, json)."""
    out = []
    for module, error in ((tschemas, tschemas.ValidationError), (jschemas, PydanticValidationError)):
        try:
            out.append(("ok", module.ChatRequest.model_validate_json(body).model_dump()))
        except error as exc:
            out.append(("err", exc.errors(), exc.json()))
    return out


def _without_url(errors):
    return [{k: v for k, v in e.items() if k != "url"} for e in errors]


def _check_equal(body):
    got, want = _both(body)
    assert got[0] == want[0], (body, got, want)
    if got[0] == "ok":
        assert got[1] == want[1] and [type(v) for v in got[1].values()] == [type(v) for v in want[1].values()]
        return
    got_errors, want_errors = got[1], _without_url(want[1])
    if want_errors[0]["type"] == "json_invalid":
        assert len(got_errors) == len(want_errors) == 1
        g, w = got_errors[0], want_errors[0]
        assert list(g) == list(w) == ["type", "loc", "msg", "input", "ctx"]
        w_input = w["input"].decode() if isinstance(w["input"], bytes) else w["input"]
        assert (g["type"], g["loc"], g["input"]) == (w["type"], list(w["loc"]), w_input)
        assert g["msg"].startswith("Invalid JSON: ") and list(g["ctx"]) == ["error"]
        return
    assert [list(e) for e in got_errors] == [list(e) for e in want_errors]
    assert got[2] == _URL.sub("", want[2]), body


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_chat_request_equal_to_pydantic(body):
    _check_equal(body)


def test_lax_coercions_and_errors_of_the_contract():
    ok = tschemas.ChatRequest.model_validate_json
    assert ok(_tk('"5"')).top_k == 5 and ok(_tk("true")).top_k == 1 and ok(_tk("5.0")).top_k == 5
    assert ok(b'{"doc_id":"x","question":"q"}').model_dump() == {
        "doc_id": "x", "question": "q", "top_k": 8, "max_chars_per_page": 1500}
    with pytest.raises(tschemas.ValidationError) as exc:
        ok(b"[]")
    assert exc.value.errors() == [{"type": "model_type", "loc": [], "msg": "Input should be an object",
                                   "input": [], "ctx": {"class_name": "ChatRequest"}}]
    with pytest.raises(tschemas.ValidationError) as exc:
        ok(_tk("51"))
    assert exc.value.json() == ('[{"type":"less_than_equal","loc":["top_k"],"msg":"Input should be less than '
                                'or equal to 50","input":51,"ctx":{"le":50}}]')


def test_body_that_is_not_utf8_is_json_invalid():
    """pydantic reports json_invalid too, then fails to serialise it."""
    with pytest.raises(tschemas.ValidationError) as exc:
        tschemas.ChatRequest.model_validate_json(b'{"doc_id":"\xff","question":"q"}')
    (err,) = exc.value.errors()
    assert (err["type"], err["loc"]) == ("json_invalid", [])
    with pytest.raises(PydanticValidationError) as jexc:
        jschemas.ChatRequest.model_validate_json(b'{"doc_id":"\xff","question":"q"}')
    assert jexc.value.errors()[0]["type"] == "json_invalid"


def test_constructing_a_request_validates_it():
    assert tschemas.ChatRequest(doc_id="d", question="q", top_k="7").top_k == 7
    for kw in ({"top_k": 0}, {"top_k": 51}, {"max_chars_per_page": 99}, {"max_chars_per_page": 10001}):
        with pytest.raises(tschemas.ValidationError):
            tschemas.ChatRequest(doc_id="d", question="q", **kw)
        with pytest.raises(PydanticValidationError):
            jschemas.ChatRequest(doc_id="d", question="q", **kw)


def test_response_models_dump_as_pydantic():
    def build(module):
        retrieved = [module.RetrievedPage(page=p, memory_id=f"m{p}", excerpt=f"text {p} é") for p in (3, 1)]
        failed = [module.FailedPage(page=2, error="boom")]
        return [
            module.ChatResponse(doc_id="d", answer_md="**a** (d p.3)", retrieved=retrieved),
            module.ChatResponse(doc_id="d", answer_md="Not found in provided pages.", retrieved=[]),
            module.IngestResponse(doc_id="d", pages_total=3, pages_ingested=2, failed_pages=failed,
                                  manifest_path="tmp/d/supermemory_manifest.json"),
            module.IngestResponse(doc_id="d", pages_total=1, pages_ingested=1, manifest_path="m.json"),
            module.HealthResponse(ok=True),
            module.FailedPage(page=1, error="e"),
        ]

    for got, want in zip(build(tschemas), build(jschemas)):
        assert json.dumps(got.model_dump()) == json.dumps(want.model_dump())


_JSON_SCALARS = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2**70), max_value=2**70), st.integers(min_value=-3, max_value=10_003),
    st.floats(allow_nan=True, allow_infinity=True), st.floats(min_value=-20, max_value=20_000),
    st.text(max_size=12),
    st.from_regex(r"[ \t\n\u00a0\u3000\x1c]{0,2}[+-]?[0-9_]{1,6}(\.[0-9_]{0,3})?[ \t\n\u00a0\u200b]{0,2}",
                  fullmatch=True),
)
_JSON_VALUES = st.recursive(_JSON_SCALARS, lambda inner: st.lists(inner, max_size=3)
                            | st.dictionaries(st.text(max_size=4), inner, max_size=3), max_leaves=6)
_FIELDS = ("doc_id", "question", "top_k", "max_chars_per_page")


@st.composite
def _request_objects(draw):
    obj = {}
    for name in draw(st.permutations(_FIELDS + ("extra",))):
        if draw(st.booleans()) or (name in ("doc_id", "question") and draw(st.booleans())):
            obj[name] = draw(st.text(max_size=8) if name in ("doc_id", "question") and draw(st.booleans())
                             else _JSON_VALUES)
    return obj


@settings(max_examples=400, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])
@given(_request_objects())
def test_random_objects_agree_with_pydantic(obj):
    """Both accept or both refuse, with the same error types and locations in
    the same order (and the same `.json()` without url)."""
    body = json.dumps(obj).encode()
    got, want = _both(body)
    assert got[0] == want[0], (obj, got, want)
    if got[0] == "err":
        assert [(e["type"], e["loc"]) for e in got[1]] == [(e["type"], list(e["loc"])) for e in want[1]]
    _check_equal(body)
