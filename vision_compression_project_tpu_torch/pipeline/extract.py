"""PDF -> per-page structured JSON: the port of
vision_compression_project_tpu/pipeline/extract.py, `/ingest`'s entry point.

`extract_pdf_to_page_jsons` writes page_###.json files with the four keys
{page_number, markdown, entities, summary} and returns {pages_total,
processed_pages, failed_pages}. Pages whose JSON exists are skipped (resume),
and a chunk whose extraction raises lands in failed_pages, one entry per page.

Engines: "text" structures the PDF's text layer (pipeline/textmd.py, no
model); "vlm" reads pages with the VLM on the device; "auto" takes "text"
when the PDF has a text layer. The VLM engine reads chunks of `batch_size`
pages, the last one padded to the full batch and trimmed after. A worker
thread renders chunk i+1 on the host (C++ engine) while the device reads
chunk i. When no PNGs are saved, a chunk whose pages all have no images or
embedded fonts, at most 2048 glyphs and at most 64 rects, ships its glyphs
and rects instead of pixels, and the device draws the pages
(`VLMRunner.extract_batch_async_glyphs`); otherwise the host renders pixels.
"""

from __future__ import annotations

import json
import logging
import re
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import RUNTIME
from ..raster import PdfDocument
from ..utils.metrics import METRICS
from .textmd import structure_page

logger = logging.getLogger(__name__)

_PAGE_JSON = "page_{:03d}.json"
_PAGE_PNG = "page_{:03d}.png"
GLYPH_MAX = 2048  # glyphs per page that glyph transport takes
RECT_MAX = 64  # rects per page that glyph transport takes


_RUNNER_LOCK = threading.Lock()  # the server's request threads share one runner


def _get_runner():
    """The VLM runner of the configured preset, built once on
    RUNTIME.device: the shipped (or VCP_CHECKPOINT_DIR) checkpoint's weights
    when there is one, else seeded random weights."""
    global _RUNNER
    with _RUNNER_LOCK:
        try:
            return _RUNNER
        except NameError:
            from .. import config
            from ..models import VLMRunner, get_preset

            preset = config.resolve_model_preset()
            cfg = get_preset(preset)
            ckpt = config.resolve_checkpoint_dir(preset)
            if ckpt:
                from ..train.checkpoint import load_runner

                _RUNNER = load_runner(cfg, ckpt, device=config.RUNTIME.device)
            else:
                _RUNNER = VLMRunner(cfg, device=config.RUNTIME.device)
            return _RUNNER


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _save_png(img: np.ndarray, path: Path) -> None:
    """(H, W) gray or (H, W, 3) RGB uint8 -> an 8-bit PNG, with the standard
    library's zlib (no filter on any row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def extract_pdf_to_page_jsons(
    pdf_path,
    out_pages_dir,
    images_dir=None,
    dpi: int = 150,
    start_page: int = 1,
    end_page: Optional[int] = None,
    overwrite: bool = False,
    engine: Optional[str] = None,
    batch_size: Optional[int] = None,
    runner=None,
    save_images: bool = True,
) -> Dict:
    """Extract pages [start_page, end_page] (1-indexed, inclusive) to
    page_###.json files. Returns {pages_total, processed_pages, failed_pages}."""
    pdf_path = Path(pdf_path)
    out_pages_dir = Path(out_pages_dir)
    out_pages_dir.mkdir(parents=True, exist_ok=True)
    if images_dir is not None:
        images_dir = Path(images_dir)
        images_dir.mkdir(parents=True, exist_ok=True)
    engine = engine or RUNTIME.extract_engine
    batch_size = batch_size or RUNTIME.extract_batch_size

    processed_pages: List[int] = []
    failed_pages: List[Dict] = []

    with PdfDocument(pdf_path) as doc:
        pages_total = doc.page_count
        last = pages_total if end_page is None else min(end_page, pages_total)
        first = max(1, start_page)
        todo: List[int] = []
        for page in range(first, last + 1):
            if (out_pages_dir / _PAGE_JSON.format(page)).exists() and not overwrite:
                processed_pages.append(page)  # resume
                continue
            todo.append(page)

        if engine == "auto":
            engine = "text" if doc.has_text_layer() else "vlm"
        logger.info("extract: %s pages_total=%d todo=%d engine=%s", pdf_path.name, pages_total, len(todo), engine)

        chunks = [todo[i : i + batch_size] for i in range(0, len(todo), batch_size)]
        if engine == "vlm":
            if runner is not None:
                model_image_size = runner.cfg.vision.image_size
            else:
                from ..config import resolve_model_preset
                from ..models.configs import PRESETS

                model_image_size = PRESETS[resolve_model_preset()].vision.image_size
        else:
            model_image_size = None

        def _render(chunk):
            return _render_chunk(doc, chunk, dpi, engine, images_dir, save_images, model_image_size)

        def _write_records(chunk, records):
            for page, record in zip(chunk, records):
                try:
                    (out_pages_dir / _PAGE_JSON.format(page)).write_text(
                        json.dumps(record, indent=2, ensure_ascii=False), encoding="utf-8"
                    )
                    processed_pages.append(page)
                except Exception as exc:
                    failed_pages.append({"page": page, "error": str(exc)})

        def _fail_chunk(chunk, exc):
            logger.error("extract batch failed: %s", exc, exc_info=True)
            for page in chunk:
                failed_pages.append({"page": page, "error": str(exc)})

        if engine == "vlm" and chunks and runner is None:
            runner = _get_runner()

        # One worker thread renders chunk i + 1 while the device reads chunk i.
        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            raster_futures = {}
            if chunks:
                raster_futures[0] = prefetcher.submit(_render, chunks[0])
            for ci, chunk in enumerate(chunks):
                if ci + 1 < len(chunks):
                    raster_futures[ci + 1] = prefetcher.submit(_render, chunks[ci + 1])
                try:
                    rasters = raster_futures.pop(ci).result()
                    if engine == "vlm":
                        # A ragged (last) chunk is padded to the full batch;
                        # collect_extract keeps the real pages only. The runner
                        # decodes inside the dispatch, so the timer takes both:
                        # the device's work, which the reference's timer waits on.
                        pad = batch_size - len(chunk)
                        with METRICS.timer("extract.batch"):
                            if isinstance(rasters, dict) and "glyphs" in rasters:
                                prims = rasters["glyphs"] + [rasters["glyphs"][-1]] * pad
                                handle = runner.extract_batch_async_glyphs(prims, rasters["hw"], page_numbers=chunk)
                            else:
                                stacked = _stack_rasters(rasters, chunk)
                                if pad:
                                    stacked = np.concatenate([stacked, np.repeat(stacked[-1:], pad, axis=0)])
                                handle = runner.extract_batch_async(stacked, page_numbers=chunk)
                            records = runner.collect_extract(handle)
                    else:
                        with METRICS.timer("extract.batch"):
                            records = _extract_chunk(
                                doc, chunk, dpi, engine, images_dir, runner, save_images, rasters=rasters
                            )
                except Exception as exc:
                    _fail_chunk(chunk, exc)
                    continue
                METRICS.count("extract.pages", len(chunk))
                _write_records(chunk, records)

    processed_pages.sort()
    return {"pages_total": pages_total, "processed_pages": processed_pages, "failed_pages": failed_pages}


def _model_dpi(doc: PdfDocument, pages: List[int], dpi: int, image_size: int) -> int:
    """DPI that renders the longest page side at about the model's input
    size: the resize on the device would discard anything finer."""
    max_pts = 1.0
    for page in pages:
        w, h = doc.page_size_pts(page - 1)
        max_pts = max(max_pts, w, h)
    return max(36, min(dpi, int(72.0 * image_size / max_pts + 0.999)))


def _render_chunk(
    doc: PdfDocument,
    pages: List[int],
    dpi: int,
    engine: str,
    images_dir: Optional[Path],
    save_images: bool,
    model_image_size: Optional[int] = None,
):
    """Host work for a chunk, on the prefetch thread: the chunk's glyph
    primitives ({"glyphs": [(glyphs, rects)], "hw": (h, w)}) or its rasters
    ({page: (H, W, 3) uint8}, with PNG artifacts when asked), or None when
    the engine needs neither."""
    need_artifacts = images_dir is not None and save_images
    if engine != "vlm" and not need_artifacts:
        return None
    render_dpi = dpi
    if engine == "vlm" and not need_artifacts and model_image_size:
        render_dpi = _model_dpi(doc, pages, dpi, model_image_size)
        # Glyph transport, unless a page has images or embedded fonts (which
        # the device renderer cannot draw) or is too dense: then the whole
        # chunk ships pixels.
        primitives = []
        max_w = max_h = 0
        for page in pages:
            if doc.page_complexity(page - 1) != 0:
                primitives = None
                break
            glyphs, rects = doc.page_primitives(page - 1, dpi=render_dpi)
            if len(glyphs) > GLYPH_MAX or len(rects) > RECT_MAX:
                primitives = None
                break
            primitives.append((glyphs, rects))
            w_pts, h_pts = doc.page_size_pts(page - 1)
            max_w = max(max_w, int(w_pts * render_dpi / 72.0 + 0.5))
            max_h = max(max_h, int(h_pts * render_dpi / 72.0 + 0.5))
        if primitives is not None:
            return {"glyphs": primitives, "hw": (max_h, max_w)}
    lo, hi = min(pages) - 1, max(pages) - 1
    if hi - lo + 1 == len(pages) and len(pages) > 1:  # contiguous: one batched render
        rasters = {lo + 1 + j: img for j, img in enumerate(doc.render_batch(lo, hi, dpi=render_dpi))}
    else:
        rasters = {page: doc.render_page(page - 1, dpi=render_dpi) for page in pages}
    if need_artifacts:
        for page, img in rasters.items():
            _save_png(img, images_dir / _PAGE_PNG.format(page))
    return rasters


def _extract_chunk(
    doc: PdfDocument,
    pages: List[int],
    dpi: int,
    engine: str,
    images_dir: Optional[Path],
    runner,
    save_images: bool,
    rasters: Optional[Dict[int, np.ndarray]] = None,
) -> List[Dict]:
    """One chunk of 1-indexed pages as one batch, rendered here unless
    `rasters` is given."""
    if rasters is None:
        image_size = runner.cfg.vision.image_size if runner is not None else None
        rasters = _render_chunk(doc, pages, dpi, engine, images_dir, save_images, image_size)
    if engine == "text":
        return [structure_page(doc.extract_text(page - 1), page) for page in pages]
    if engine == "vlm":
        runner = runner or _get_runner()
        return runner.extract_batch(_stack_rasters(rasters, pages), page_numbers=pages)
    raise ValueError(f"unknown extract engine {engine!r}")


def _is_grayscale(img: np.ndarray) -> bool:
    return bool(np.array_equal(img[..., 0], img[..., 1]) and np.array_equal(img[..., 1], img[..., 2]))


def _stack_rasters(rasters: Dict[int, np.ndarray], pages: List[int]) -> np.ndarray:
    """Per-page rasters -> one (B, H, W, 3) batch, padded with white where
    page sizes differ; (B, H, W) when every page is gray (a third of the
    bytes to the device, which broadcasts after the resize)."""
    gray = all(_is_grayscale(rasters[p]) for p in pages)
    channels = () if gray else (3,)
    shapes = {rasters[p].shape[:2] for p in pages}
    if len(shapes) == 1:
        if gray:
            return np.stack([np.ascontiguousarray(rasters[p][..., 0]) for p in pages])
        return np.stack([rasters[p] for p in pages])
    h = max(s[0] for s in shapes)
    w = max(s[1] for s in shapes)
    stacked = np.full((len(pages), h, w, *channels), 255, np.uint8)
    for j, p in enumerate(pages):
        img = rasters[p]
        stacked[j, : img.shape[0], : img.shape[1]] = img[..., 0] if gray else img
    return stacked


def create_manifest(
    pdf_path,
    manifest_path,
    stats: Dict,
    dpi: int,
    start_page: int,
    end_page: Optional[int],
    model_name: str,
) -> Dict:
    """manifest.json with the reference CLI's key set."""
    manifest = {
        "pdf_path": str(pdf_path),
        "total_pages": stats["pages_total"],
        "processed_pages": stats["processed_pages"],
        "failed_pages": stats["failed_pages"],
        "model_name": model_name,
        "dpi": dpi,
        "start_page": start_page,
        "end_page": end_page if end_page is not None else stats["pages_total"],
        "timestamp": datetime.now().isoformat(),
    }
    Path(manifest_path).write_text(json.dumps(manifest, indent=2, ensure_ascii=False), encoding="utf-8")
    return manifest


def create_combined_markdown(pages_dir, out_path) -> Path:
    """combined.md: per page '# Page N\\n\\n' + its markdown (else its
    raw_response) + '\\n\\n' + '---\\n\\n', the separator after the last page
    too."""
    parts: List[str] = []
    for json_path in sorted(Path(pages_dir).glob("page_*.json")):
        try:
            data = json.loads(json_path.read_text(encoding="utf-8"))
        except Exception:
            continue
        match = re.search(r"page_(\d+)\.json$", json_path.name)
        page_no = int(match.group(1)) if match else data.get("page_number", 0)
        parts.append(f"# Page {page_no}\n\n")
        if "markdown" in data:
            parts.append(f"{data['markdown']}\n\n")
        elif "raw_response" in data:
            parts.append(f"{data['raw_response']}\n\n")
        parts.append("---\n\n")
    out_path = Path(out_path)
    out_path.write_text("".join(parts), encoding="utf-8")
    return out_path
