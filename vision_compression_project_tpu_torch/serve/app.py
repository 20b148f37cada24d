"""Optional FastAPI application factory: the port of
vision_compression_project_tpu/serve/app.py.

The primary server (httpd.py) is stdlib-only; this factory produces the
same surface as a FastAPI/uvicorn app for deployments that have those
packages (the reference deployed exactly that shape,
reference backend/Dockerfile:29 `uvicorn app.main:app`).  Import is gated:
calling create_app() without fastapi installed raises a clear error.
"""

from __future__ import annotations

from typing import Optional


def create_app(base_tmp=None):
    try:
        from fastapi import FastAPI, File, Form, HTTPException, UploadFile
        from fastapi.middleware.cors import CORSMiddleware
    except ImportError as exc:  # pragma: no cover - exercised only with fastapi
        raise ImportError(
            "fastapi is not installed; use vision_compression_project_tpu_torch.serve"
            ".httpd (stdlib server) or install fastapi+uvicorn"
        ) from exc

    from ..config import DEFAULT_DPI, DEFAULT_START_PAGE
    from ..schemas import ChatRequest, ChatResponse, HealthResponse, IngestResponse
    from .httpd import API_INFO, HttpError, ServiceState

    state = ServiceState(base_tmp=base_tmp)
    app = FastAPI(title="Vision Compression Backend", version="1.0.0")
    app.add_middleware(
        CORSMiddleware,
        allow_origins=["*"],
        allow_credentials=False,
        allow_methods=["GET", "POST", "PUT", "DELETE", "OPTIONS", "HEAD", "PATCH"],
        allow_headers=["*"],
        expose_headers=["*"],
        max_age=3600,
    )

    @app.get("/")
    async def root():
        return API_INFO

    @app.get("/health", response_model=HealthResponse)
    async def health():
        return {"ok": True}

    @app.post("/ingest", response_model=IngestResponse)
    async def ingest(
        file: UploadFile = File(...),
        dpi: int = Form(default=DEFAULT_DPI),
        start_page: int = Form(default=DEFAULT_START_PAGE),
        end_page: Optional[int] = Form(default=None),
        overwrite: bool = Form(default=False),
    ):
        data = await file.read()
        try:
            return state.ingest(
                filename=file.filename, data=data, dpi=dpi,
                start_page=start_page, end_page=end_page, overwrite=overwrite,
            )
        except HttpError as exc:
            raise HTTPException(status_code=exc.status, detail=exc.detail)

    @app.post("/chat", response_model=ChatResponse)
    async def chat(request: ChatRequest):
        try:
            return state.chat(request)
        except HttpError as exc:
            raise HTTPException(status_code=exc.status, detail=exc.detail)

    return app
