"""HTTP service: the port of vision_compression_project_tpu/serve/httpd.py,
byte-compatible with it and with the reference's FastAPI surface.

Endpoints, request/response shapes, CORS behavior, doc_id format and on-disk
layout match the reference exactly (reference: backend/app/main.py:30-213 —
GET /, GET /health, POST /ingest multipart, POST /chat JSON;
tmp/<doc_id>/{pages,images}, uploaded.pdf, supermemory_manifest.json;
CORS allow_origins=['*'], allow_credentials off), so the reference's
Next.js frontend works unchanged against this server.

Implemented on stdlib ThreadingHTTPServer: each request runs on its own
thread, and the device state (runners, index, embedder) is shared. Request
bodies are validated by the port's schemas (no pydantic). Question
embeddings ride a BatchingQueue so concurrent /chat requests coalesce into
one device batch.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import string
import threading
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..config import (
    BASE_TMP_DIR,
    DEFAULT_DPI,
    DEFAULT_START_PAGE,
    RUNTIME,
)
from ..schemas import (
    ChatRequest,
    ChatResponse,
    FailedPage,
    IngestResponse,
    RetrievedPage,
    ValidationError,
)
from .batching import BatchingQueue

# Parsed once at import: a malformed value falls back instead of raising
# ValueError on every single-text chat request (advisor r2).
try:
    _CHAT_EMBED_TIMEOUT_S = float(os.environ.get("VCP_CHAT_EMBED_TIMEOUT_S", "120"))
except ValueError:
    _CHAT_EMBED_TIMEOUT_S = 120.0

logger = logging.getLogger(__name__)

API_INFO = {
    "message": "Vision Compression Backend API",
    "version": "1.0.0",
    "docs": "/docs",
    "health": "/health",
    "endpoints": {
        "GET /health": "Health check",
        "POST /ingest": "Ingest PDF file",
        "POST /chat": "Answer questions about ingested documents",
    },
}

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS, HEAD, PATCH",
    "Access-Control-Allow-Headers": "*",
    "Access-Control-Expose-Headers": "*",
    "Access-Control-Max-Age": "3600",
}


def generate_doc_id() -> str:
    """Timestamp + 6 random lowercase-alnum chars (reference main.py:49-53)."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    suffix = "".join(random.choices(string.ascii_lowercase + string.digits, k=6))
    return f"{timestamp}_{suffix}"


# ---------------------------------------------------------------------------
# Multipart parsing (stdlib-only)
# ---------------------------------------------------------------------------


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser -> {name: value}; file parts map to
    {'filename': ..., 'data': bytes}."""
    match = re.search(r'boundary="?([^";]+)"?', content_type)
    if not match:
        raise ValueError("missing multipart boundary")
    boundary = b"--" + match.group(1).encode()
    fields = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" in part:
            head, _, payload = part.partition(b"\r\n\r\n")
        else:
            head, _, payload = part.partition(b"\n\n")
        disp = re.search(rb'name="([^"]+)"', head)
        if not disp:
            continue
        name = disp.group(1).decode()
        fname = re.search(rb'filename="([^"]*)"', head)
        if fname:
            fields[name] = {"filename": fname.group(1).decode(), "data": payload}
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields


# ---------------------------------------------------------------------------
# Service backend
# ---------------------------------------------------------------------------


class ServiceState:
    """Shared, lazily-initialized heavy state (embedder, index, batcher)."""

    def __init__(self, base_tmp: Path = None):
        self.base_tmp = Path(base_tmp or BASE_TMP_DIR)
        # RLock: the lazy properties nest (chat_embed_batcher -> embedder).
        self._lock = threading.RLock()
        self._embedder = None
        self._store = None
        self._chat_embed_batcher = None

    @property
    def embedder(self):
        with self._lock:
            if self._embedder is None:
                from ..pipeline.ingest import _get_embedder

                self._embedder = _get_embedder()
            return self._embedder

    @property
    def store(self):
        with self._lock:
            if self._store is None:
                from ..index import get_default_store

                self._store = get_default_store(dim=self.embedder.dim)
            return self._store

    @property
    def chat_embed_batcher(self) -> BatchingQueue:
        with self._lock:
            if self._chat_embed_batcher is None:
                embedder = self.embedder

                def embed_batch(questions):
                    vecs = embedder.embed(questions)
                    return [vecs[i] for i in range(len(questions))]

                self._chat_embed_batcher = BatchingQueue(
                    embed_batch, max_batch=RUNTIME.embed_batch_size, max_wait_ms=4.0
                )
            return self._chat_embed_batcher

    # -- endpoint logic (framework-agnostic; shared with the FastAPI app) ---

    def ingest(
        self,
        filename: str,
        data: bytes,
        dpi: int = DEFAULT_DPI,
        start_page: int = DEFAULT_START_PAGE,
        end_page=None,
        overwrite: bool = False,
    ) -> IngestResponse:
        from ..pipeline import extract, ingest as ingest_mod

        if not filename.endswith(".pdf"):
            raise HttpError(400, "File must be a PDF")
        doc_id = generate_doc_id()
        doc_dir = self.base_tmp / doc_id
        pages_dir = doc_dir / "pages"
        images_dir = doc_dir / "images"
        pages_dir.mkdir(parents=True, exist_ok=True)
        images_dir.mkdir(parents=True, exist_ok=True)
        pdf_path = doc_dir / "uploaded.pdf"
        try:
            pdf_path.write_bytes(data)
        except Exception as exc:
            raise HttpError(500, f"Failed to save PDF: {exc}")
        try:
            extract_stats = extract.extract_pdf_to_page_jsons(
                pdf_path=pdf_path,
                out_pages_dir=pages_dir,
                images_dir=images_dir,
                dpi=dpi,
                start_page=start_page,
                end_page=end_page,
                overwrite=overwrite,
            )
        except Exception as exc:
            raise HttpError(500, f"Extraction failed: {exc}")
        manifest_path = doc_dir / "supermemory_manifest.json"
        try:
            manifest = ingest_mod.ingest_pages_dir(
                pages_dir=pages_dir,
                pdf_path=pdf_path,
                doc_id=doc_id,
                manifest_path=manifest_path,
                overwrite=overwrite,
                embedder=self.embedder,
                store=self.store,
            )
        except Exception as exc:
            raise HttpError(500, f"Ingestion failed: {exc}")

        pages_ingested = len(
            [p for p in manifest.get("pages", []) if "error" not in p]
        )
        failed = [
            FailedPage(page=fp["page"], error=fp["error"])
            for fp in manifest.get("failed_pages", [])
        ]
        for fp in extract_stats.get("failed_pages", []):
            if not any(f.page == fp["page"] for f in failed):
                failed.append(FailedPage(page=fp["page"], error=fp["error"]))
        return IngestResponse(
            doc_id=doc_id,
            pages_total=extract_stats["pages_total"],
            pages_ingested=pages_ingested,
            failed_pages=failed,
            manifest_path=str(manifest_path),
        )

    def chat(self, request: ChatRequest) -> ChatResponse:
        from ..pipeline import qa

        manifest_path = self.base_tmp / request.doc_id / "supermemory_manifest.json"
        manifest_path = manifest_path if manifest_path.exists() else None
        try:
            result = qa.answer_question(
                doc_id=request.doc_id,
                question=request.question,
                top_k=request.top_k,
                max_chars_per_page=request.max_chars_per_page,
                model=None,
                manifest_path=manifest_path,
                store=self.store,
                embedder=_BatchedEmbedder(self),
            )
        except HttpError:
            raise
        except Exception as exc:
            raise HttpError(500, f"QA failed: {exc}")
        return ChatResponse(
            doc_id=request.doc_id,
            answer_md=result["answer_md"],
            retrieved=[
                RetrievedPage(
                    page=r["page"], memory_id=r["memory_id"], excerpt=r["excerpt"]
                )
                for r in result["retrieved"]
            ],
        )


class _BatchedEmbedder:
    """Embedder facade routing single-question embeds through the batcher
    while bulk calls (extractive answer sentence ranking) go direct."""

    def __init__(self, state: ServiceState):
        self._state = state
        self.dim = state.embedder.dim

    def embed(self, texts):
        import numpy as np

        if len(texts) == 1:
            # Generous bound: this is a lost-worker guard, not a latency SLA
            # — a cold first query can legitimately sit behind a kernel
            # build on a loaded host (warmup covers the common case).
            return np.stack(
                [
                    self._state.chat_embed_batcher.submit(
                        texts[0], timeout=_CHAT_EMBED_TIMEOUT_S
                    )
                ]
            )
        return self._state.embedder.embed(texts)


class HttpError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


# ---------------------------------------------------------------------------
# Handler
# ---------------------------------------------------------------------------


class VCPRequestHandler(BaseHTTPRequestHandler):
    state: ServiceState = None  # injected by create_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, status: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in CORS_HEADERS.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def do_OPTIONS(self):  # CORS preflight
        self.send_response(200)
        for k, v in CORS_HEADERS.items():
            self.send_header(k, v)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        if self.path == "/health":
            self._send_json(200, {"ok": True})
        elif self.path == "/":
            self._send_json(200, API_INFO)
        elif self.path == "/metrics":
            from ..utils.metrics import METRICS

            self._send_json(200, METRICS.snapshot())
        elif self.path in ("/ui", "/ui/"):
            from .ui import UI_HTML

            body = UI_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"detail": "Not Found"})

    def do_POST(self):
        try:
            if self.path == "/ingest":
                self._handle_ingest()
            elif self.path == "/chat":
                self._handle_chat()
            else:
                self._send_json(404, {"detail": "Not Found"})
        except HttpError as exc:
            self._send_json(exc.status, {"detail": exc.detail})
        except Exception as exc:  # parity with FastAPI's 500 behavior
            logger.error("unhandled error: %s", exc, exc_info=True)
            self._send_json(500, {"detail": str(exc)})

    def _handle_ingest(self):
        content_type = self.headers.get("Content-Type", "")
        if "multipart/form-data" not in content_type:
            raise HttpError(400, "Expected multipart/form-data")
        fields = parse_multipart(self._read_body(), content_type)
        file_part = fields.get("file")
        if not isinstance(file_part, dict):
            raise HttpError(422, "Missing file field")

        def _int(name, default):
            try:
                return int(fields.get(name, default))
            except (TypeError, ValueError):
                return default

        end_page = fields.get("end_page")
        end_page = int(end_page) if end_page not in (None, "", "None") else None
        overwrite = str(fields.get("overwrite", "false")).lower() in ("true", "1")
        response = self.state.ingest(
            filename=file_part["filename"],
            data=file_part["data"],
            dpi=_int("dpi", DEFAULT_DPI),
            start_page=_int("start_page", DEFAULT_START_PAGE),
            end_page=end_page,
            overwrite=overwrite,
        )
        self._send_json(200, response.model_dump())

    def _handle_chat(self):
        try:
            request = ChatRequest.model_validate_json(self._read_body())
        except ValidationError as exc:
            raise HttpError(422, exc.json())
        response = self.state.chat(request)
        self._send_json(200, response.model_dump())


def create_server(host: str = "0.0.0.0", port: int = 8080, base_tmp=None):
    state = ServiceState(base_tmp=base_tmp)
    handler = type("BoundHandler", (VCPRequestHandler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    server.vcp_state = state
    return server


def warmup(state: ServiceState) -> None:
    """Pay the first-use costs before taking traffic: on the card, compile
    the kernels (nvcc); build the PDF engine (g++); embed once on the
    batcher's single-query path, so the first /ingest and /chat do not pay
    them inside a user's request."""
    import time

    t0 = time.time()
    logger.info("warmup: building the kernels and the PDF engine, embedding once")
    if state.embedder.device.type == "cuda":
        from .. import kernels

        for name in kernels.SOURCES:
            kernels.build(name)
    from ..raster.rasterizer import build_library

    build_library()
    state.embedder.embed(["warmup text for compilation"])
    try:
        state.chat_embed_batcher.submit("warmup query", timeout=300)
    except Exception:  # pragma: no cover - warmup is best-effort
        logger.warning("warmup: chat embed path failed", exc_info=True)
    logger.info("warmup: done in %.1fs", time.time() - t0)


def serve_forever(host: str = "0.0.0.0", port: int = 8080, do_warmup: bool = True):
    server = create_server(host, port)
    if do_warmup:
        # Warm in the background so /health responds immediately.
        threading.Thread(
            target=warmup, args=(server.vcp_state,), daemon=True
        ).start()
    logger.info("serving on %s:%d", host, port)
    server.serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    serve_forever()
