"""The port's HTTP server against the JAX package's, request by request.

Both servers run here on 127.0.0.1:0, each set up as tests/test_serve.py sets
its server up (the hash embedder at dim 128 with 2048 buckets, an IndexStore
in a temporary directory), with doc ids and memory ids drawn from the same
counter on both sides. Every request of tests/test_serve.py and
tests/test_frontend_compat.py, and the other 400, 404 and 422 cases, is sent
to both; statuses, headers other than Date, and body bytes must be equal.
The one masked part is each server's temporary root in `manifest_path`
(the two roots have the same length, so Content-Length still compares).
422 bodies are compared once pydantic's `url` is dropped (so without
Content-Length), and for `json_invalid` without its parser's wording.
/metrics runs under a fake clock in both metrics modules, so its timers
compare too. Pages are read by the text engine (tests/conftest.py sets
VCP_ANSWER_ENGINE=extractive), so no model runs.
"""

import http.client
import itertools
import json
import re
import threading

import numpy as np
import pytest
from PIL import Image

from vision_compression_project_tpu.index import IndexStore as JIndexStore
from vision_compression_project_tpu.index import vector_index as jvi
from vision_compression_project_tpu.models import EmbedderConfig as JEmbedderConfig
from vision_compression_project_tpu.models import HashNGramEmbedder as JHashNGramEmbedder
from vision_compression_project_tpu.raster import make_pdf
from vision_compression_project_tpu.serve import httpd as jhttpd
from vision_compression_project_tpu.utils import metrics as jmetrics
from vision_compression_project_tpu_torch.index import IndexStore
from vision_compression_project_tpu_torch.index import vector_index as tvi
from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
from vision_compression_project_tpu_torch.models.embedder import HashNGramEmbedder
from vision_compression_project_tpu_torch.serve import httpd as thttpd
from vision_compression_project_tpu_torch.utils import metrics as tmetrics

ORIGIN = "http://localhost:3000"  # the reference frontend's dev origin
_URL = re.compile(r',"url":"https://errors\.pydantic\.dev/[^"]*"')


class _FakeClock:
    """perf_counter in steps of 0.25 s, time() fixed: timers become a
    function of the calls made, the same on both sides."""

    def __init__(self):
        self._ticks = itertools.count()

    def perf_counter(self):
        return next(self._ticks) * 0.25

    def time(self):
        return 0.0


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"jax": (url, base_tmp), "port": (url, base_tmp)}."""
    tmp = tmp_path_factory.mktemp("serve_parity")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for httpd_mod, vi_mod in ((jhttpd, jvi), (thttpd, tvi)):
            doc_ids, mem_ids = itertools.count(), itertools.count()
            mp.setattr(httpd_mod, "generate_doc_id", lambda c=doc_ids: f"20240101_000000_{next(c):06d}")
            mp.setattr(vi_mod, "_new_memory_id", lambda c=mem_ids: f"mem{next(c):019d}")
        started = []
        for name, base in (("jax", tmp / "j" / "tmp"), ("port", tmp / "t" / "tmp")):
            if name == "jax":
                srv = jhttpd.create_server(host="127.0.0.1", port=0, base_tmp=base)
                srv.vcp_state._embedder = JHashNGramEmbedder(JEmbedderConfig(dim=128, ngram_buckets=2048))
                srv.vcp_state._store = JIndexStore(tmp / "j" / "index", dim=128)
            else:
                srv = thttpd.create_server(host="127.0.0.1", port=0, base_tmp=base)
                srv.vcp_state._embedder = HashNGramEmbedder(EmbedderConfig(dim=128, ngram_buckets=2048),
                                                            device="cpu")
                srv.vcp_state._store = IndexStore(tmp / "t" / "index", dim=128, device="cpu")
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            started.append(srv)
            out[name] = ("127.0.0.1", srv.server_address[1], base)
        yield out
        for srv in started:
            srv.shutdown()
            srv.server_close()


@pytest.fixture(scope="module")
def pdf_bytes(tmp_path_factory):
    """test_serve.py's and test_frontend_compat.py's PDFs."""
    tmp = tmp_path_factory.mktemp("pdfs")
    serve_pdf = make_pdf(["Solar Energy Report\nSolar panels convert sunlight into electricity.",
                          "Wind Power\nWind turbines generate power from moving air."], tmp / "a.pdf")
    compat_pdf = make_pdf(["First page about optical compression.", "Second page about indexes."], tmp / "b.pdf")
    return {"serve": serve_pdf.read_bytes(), "compat": compat_pdf.read_bytes()}


def _exchange(server, method, path, body=None, headers=None):
    """(status, headers without Date, body bytes) of one request."""
    host, port, _ = server
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, [(k, v) for k, v in resp.getheaders() if k != "Date"], resp.read()
    finally:
        conn.close()


def _multipart(filename, filedata, fields=None, boundary="testboundary123"):
    """test_serve.py's form: the fields, then the file part."""
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in (fields or {}).items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
                 f"Content-Type: application/pdf\r\n\r\n".encode() + filedata + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _browser_multipart(filename, filedata):
    """test_frontend_compat.py's form: one 'file' part, WebKit boundary, with an Origin."""
    body, headers = _multipart(filename, filedata, boundary="----WebKitFormBoundary7MA4YWxkTrZu0gW")
    return body, {**headers, "Origin": ORIGIN}


def _json(payload, origin=False):
    headers = {"Content-Type": "application/json"}
    if origin:
        headers["Origin"] = ORIGIN
    return json.dumps(payload).encode() if not isinstance(payload, bytes) else payload, headers


def _same(servers, method, path, body=None, headers=None):
    """Send one request to both servers; assert equal; return the parsed
    JSON body (or the raw bytes when it is not JSON)."""
    got = _exchange(servers["port"], method, path, body, headers)
    want = _exchange(servers["jax"], method, path, body, headers)
    assert got[0] == want[0], (path, got, want)
    g_body, w_body = got[2], want[2]
    g_headers, w_headers = got[1], want[1]
    if got[0] == 422 and path == "/chat":
        g_detail, w_detail = json.loads(g_body)["detail"], json.loads(w_body)["detail"]
        w_detail = _URL.sub("", w_detail)
        g_errors, w_errors = json.loads(g_detail), json.loads(w_detail)
        if w_errors and w_errors[0]["type"] == "json_invalid":
            for e in g_errors + w_errors:
                e["msg"], e["ctx"] = "<parser wording>", {"error": "<parser wording>"}
            assert g_errors == w_errors
        else:
            assert g_detail == w_detail
        assert list(json.loads(g_body)) == ["detail"]
        drop = ("Content-Length",)
        assert dict(g_headers)["Content-Length"] == str(len(g_body))
        g_headers = [h for h in g_headers if h[0] not in drop]
        w_headers = [h for h in w_headers if h[0] not in drop]
    else:
        masked = [b.replace(str(server[2]).encode(), b"<tmp>")
                  for b, server in ((g_body, servers["port"]), (w_body, servers["jax"]))]
        assert masked[0] == masked[1], (path, g_body[:400], w_body[:400])
    assert g_headers == w_headers, path
    try:
        return got[0], json.loads(g_body)
    except ValueError:
        return got[0], g_body


def _same_artifacts(servers, doc_id):
    """The upload's files on disk: page JSON and manifest bytes equal (the
    root masked), PNGs equal pixel for pixel, the PDF saved as sent."""
    roots = [servers[name][2] / doc_id for name in ("port", "jax")]
    names = sorted(p.name for p in (roots[1] / "pages").iterdir())
    assert names == sorted(p.name for p in (roots[0] / "pages").iterdir()) and names
    for name in names + ["../supermemory_manifest.json", "../uploaded.pdf"]:
        texts = [(root / "pages" / name).read_bytes().replace(str(root.parent).encode(), b"<tmp>")
                 for root in roots]
        assert texts[0] == texts[1], name
    pngs = sorted(p.name for p in (roots[1] / "images").iterdir())
    assert pngs == sorted(p.name for p in (roots[0] / "images").iterdir()) and pngs
    for name in pngs:
        got, want = (np.asarray(Image.open(root / "images" / name)) for root in roots)
        assert got.shape == want.shape and np.array_equal(got, want), name


# -- tests/test_serve.py's requests --------------------------------------------


def test_health(servers):
    assert _same(servers, "GET", "/health") == (200, {"ok": True})


def test_root_info(servers):
    status, body = _same(servers, "GET", "/")
    assert status == 200 and body["message"] == "Vision Compression Backend API"


@pytest.mark.parametrize("path", ["/ingest", "/chat", "/health"])
def test_cors_preflight(servers, path):
    assert _same(servers, "OPTIONS", path)[0] == 200


def test_ingest_rejects_non_pdf(servers):
    body, headers = _multipart("notes.txt", b"hello")
    assert _same(servers, "POST", "/ingest", body, headers) == (400, {"detail": "File must be a PDF"})


def test_ingest_then_chat_flow(servers, pdf_bytes):
    body, headers = _multipart("doc.pdf", pdf_bytes["serve"], fields={"dpi": "72"})
    status, ingest = _same(servers, "POST", "/ingest", body, headers)
    assert status == 200 and ingest["pages_ingested"] == 2 and ingest["failed_pages"] == []
    _same_artifacts(servers, ingest["doc_id"])
    payload = {"doc_id": ingest["doc_id"], "question": "How do solar panels work?", "top_k": 2}
    status, chat = _same(servers, "POST", "/chat", *_json(payload))
    assert status == 200 and chat["retrieved"][0]["page"] == 1


def test_chat_validation_error(servers):
    assert _same(servers, "POST", "/chat", *_json({"doc_id": "x"}))[0] == 422


def test_chat_unknown_doc(servers):
    status, body = _same(servers, "POST", "/chat", *_json({"doc_id": "missing_doc", "question": "hi"}))
    assert status == 200 and body["answer_md"] == "Not found in provided pages."


def test_ui_served(servers):
    status, body = _same(servers, "GET", "/ui")
    assert status == 200 and b"Vision Compression Document QA" in body
    assert _same(servers, "GET", "/ui/")[0] == 200


def test_metrics_endpoint(servers, pdf_bytes, monkeypatch):
    for module in (jmetrics, tmetrics):
        monkeypatch.setattr(module, "time", _FakeClock())
        module.METRICS.reset()
        monkeypatch.setattr(module.METRICS, "_started", 0.0)
    body, headers = _multipart("doc.pdf", pdf_bytes["serve"], fields={"dpi": "72", "start_page": "2"})
    status, ingest = _same(servers, "POST", "/ingest", body, headers)
    assert status == 200 and ingest["pages_ingested"] == 1
    _same(servers, "POST", "/chat", *_json({"doc_id": ingest["doc_id"], "question": "What moves the turbines?"}))
    status, metrics = _same(servers, "GET", "/metrics")
    assert status == 200 and metrics["counters"] == {"extract.pages": 1.0, "ingest.pages": 1.0, "qa.queries": 1.0}
    assert set(metrics["timers"]) == {"extract.batch", "ingest.batch", "qa.retrieve"}


# -- tests/test_frontend_compat.py's requests ----------------------------------


def test_health_poll(servers):
    assert _same(servers, "GET", "/health", headers={"Origin": ORIGIN}) == (200, {"ok": True})


def test_ingest_chat_roundtrip(servers, pdf_bytes):
    """The UI's upload (only 'file', so dpi 150) and its chat body."""
    status, ingest = _same(servers, "POST", "/ingest", *_browser_multipart("mydoc.pdf", pdf_bytes["compat"]))
    assert status == 200 and ingest["pages_total"] == 2
    _same_artifacts(servers, ingest["doc_id"])
    payload = {"doc_id": ingest["doc_id"], "question": "What is this about?", "top_k": 8,
               "max_chars_per_page": 1500}
    status, chat = _same(servers, "POST", "/chat", *_json(payload, origin=True))
    assert status == 200 and chat["retrieved"]


def test_chat_preflight_cors(servers):
    headers = {"Origin": ORIGIN, "Access-Control-Request-Method": "POST",
               "Access-Control-Request-Headers": "content-type"}
    assert _same(servers, "OPTIONS", "/chat", headers=headers)[0] == 200


def test_error_detail_contract(servers):
    status, body = _same(servers, "POST", "/ingest", *_browser_multipart("notes.txt", b"plain text, not a pdf"))
    assert status == 400 and "detail" in body


# -- the other 400, 404 and 422 cases ------------------------------------------


@pytest.mark.parametrize("method,path", [("GET", "/missing"), ("POST", "/missing"), ("GET", "/health/"),
                                         ("GET", "/health?x=1"), ("POST", "/health")])
def test_not_found(servers, method, path):
    body, headers = _json({"doc_id": "x", "question": "q"})
    assert _same(servers, method, path, body if method == "POST" else None,
                 headers if method == "POST" else None) == (404, {"detail": "Not Found"})


def test_ingest_needs_multipart(servers):
    assert _same(servers, "POST", "/ingest", *_json({"file": "x"})) == (400, {"detail": "Expected multipart/form-data"})


def test_ingest_needs_a_file_part(servers):
    boundary = "b0undary"
    body = f'--{boundary}\r\nContent-Disposition: form-data; name="dpi"\r\n\r\n72\r\n--{boundary}--\r\n'.encode()
    headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    assert _same(servers, "POST", "/ingest", body, headers) == (422, {"detail": "Missing file field"})


@pytest.mark.parametrize("body", [
    {"doc_id": "x", "question": "q", "top_k": 51}, {"doc_id": "x", "question": "q", "top_k": 0},
    {"doc_id": "x", "question": "q", "max_chars_per_page": 99}, {"doc_id": 1, "question": "q"},
    {"doc_id": "x", "question": "q", "top_k": 5.5}, {"doc_id": "x", "question": "q", "top_k": "five"},
    {"question": None}, [], "text", b"not json", b"", b'{"doc_id":"x",}',
    '{"doc_id":"é","question":"q","top_k":"é"}'.encode(),
], ids=range(13))
def test_chat_422(servers, body):
    status, detail = _same(servers, "POST", "/chat", *_json(body))
    assert status == 422 and isinstance(detail["detail"], str)


@pytest.mark.parametrize("body", [{"doc_id": "missing_doc", "question": "q", "top_k": "5"},
                                  {"doc_id": "missing_doc", "question": "q", "top_k": True, "extra": 1}])
def test_chat_lax_fields(servers, body):
    assert _same(servers, "POST", "/chat", *_json(body))[0] == 200


def test_fastapi_factory_gated():
    """create_app raises a clear error when fastapi is absent (this image)."""
    from vision_compression_project_tpu_torch.serve.app import create_app

    try:
        import fastapi  # noqa: F401
        pytest.skip("fastapi installed here; gating not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="stdlib server"):
        create_app()
