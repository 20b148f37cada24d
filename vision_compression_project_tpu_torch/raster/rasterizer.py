"""ctypes binding for the batched C++ PDF engine (vcpraster): the port's copy
of vision_compression_project_tpu/raster/rasterizer.py.

One `PdfDocument` parses the file once; `page_count` comes from the page
tree, and `render_batch` renders a page range into one contiguous uint8
buffer with a C++ thread pool. `page_primitives` exports a page's glyphs and
rects for the on-device renderer (ops/glyph_render.py).

The engine's sources are the port's own copy under `cpp/`; they build with
g++ (and zlib) on first use into the package's `_build/` (see `native`).
Engine calls release the GIL; a `PdfDocument` is read-only after parsing, so
one may render on a worker thread while another thread reads it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import native

_CPP_DIR = Path(__file__).resolve().parent / "cpp"
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class RasterError(RuntimeError):
    pass


def build_library() -> Path:
    """Build the engine (g++, zlib) into the package's `_build/` unless it is there."""
    return native.build("vcpraster", [_CPP_DIR / "pdf_engine.cc"], native.RASTER_LIBS)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = build_library()
        except RuntimeError as exc:
            raise RasterError(f"failed to build vcpraster: {str(exc)[-2000:]}") from None
        lib = ctypes.CDLL(str(path))
        lib.vcpr_open.restype = ctypes.c_void_p
        lib.vcpr_open.argtypes = [ctypes.c_char_p]
        lib.vcpr_close.argtypes = [ctypes.c_void_p]
        lib.vcpr_page_count.restype = ctypes.c_int
        lib.vcpr_page_count.argtypes = [ctypes.c_void_p]
        lib.vcpr_page_size_pts.restype = ctypes.c_int
        lib.vcpr_page_size_pts.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.vcpr_render_page.restype = ctypes.c_int
        lib.vcpr_render_page.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.vcpr_render_batch.restype = ctypes.c_int
        lib.vcpr_render_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.vcpr_extract_text.restype = ctypes.c_long
        lib.vcpr_extract_text.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_long
        ]
        lib.vcpr_get_glyphs.restype = ctypes.c_long
        lib.vcpr_get_glyphs.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.vcpr_get_rects.restype = ctypes.c_long
        lib.vcpr_get_rects.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.vcpr_glyph_atlas.restype = ctypes.c_int
        lib.vcpr_glyph_atlas.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.vcpr_page_complexity.restype = ctypes.c_int
        lib.vcpr_page_complexity.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def glyph_atlas() -> np.ndarray:
    """(95, 16, 8) uint8 0/1 bitmaps for ASCII 32..126 (the engine's font)."""
    lib = _load_library()
    out = np.zeros((95, 16, 8), np.uint8)
    lib.vcpr_glyph_atlas(out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out


class PdfDocument:
    """Parsed PDF; read-only and safe for concurrent rendering."""

    def __init__(self, path):
        self._lib = _load_library()
        self._handle = self._lib.vcpr_open(str(path).encode())
        if not self._handle:
            raise RasterError(f"could not parse PDF: {path}")
        self.path = Path(path)

    def close(self):
        if self._handle:
            self._lib.vcpr_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def page_count(self) -> int:
        return self._lib.vcpr_page_count(self._handle)

    def page_size_pts(self, page: int) -> Tuple[float, float]:
        w = ctypes.c_double()
        h = ctypes.c_double()
        rc = self._lib.vcpr_page_size_pts(self._handle, page, w, h)
        if rc != 0:
            raise RasterError(f"bad page index {page}")
        return w.value, h.value

    def render_page(self, page: int, dpi: float = 150.0) -> np.ndarray:
        """(H, W, 3) uint8."""
        w_pts, h_pts = self.page_size_pts(page)
        W = int(w_pts * dpi / 72.0 + 0.5)
        H = int(h_pts * dpi / 72.0 + 0.5)
        buf = np.empty((H, W, 3), np.uint8)
        ow = ctypes.c_int()
        oh = ctypes.c_int()
        rc = self._lib.vcpr_render_page(
            self._handle, page, dpi,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            buf.nbytes, ow, oh,
        )
        if rc != 0:
            raise RasterError(f"render failed for page {page}")
        return buf[: oh.value, : ow.value]

    def render_batch(
        self,
        first: int,
        last: int,
        dpi: float = 150.0,
        n_threads: int = 8,
    ) -> List[np.ndarray]:
        """Render 0-based pages [first, last] into one contiguous buffer
        (C++ thread pool); returns per-page views trimmed to actual dims."""
        first = max(0, first)
        last = min(self.page_count - 1, last)
        if last < first:
            return []
        n = last - first + 1
        # Uniform stride sized for the largest page in the range.
        max_bytes = 0
        for p in range(first, last + 1):
            w_pts, h_pts = self.page_size_pts(p)
            W = int(w_pts * dpi / 72.0 + 0.5)
            H = int(h_pts * dpi / 72.0 + 0.5)
            max_bytes = max(max_bytes, W * H * 3)
        buf = np.empty((n, max_bytes), np.uint8)
        dims = np.zeros((n, 2), np.int32)
        rendered = self._lib.vcpr_render_batch(
            self._handle, first, last, dpi,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            max_bytes,
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            n_threads,
        )
        if rendered != n:
            raise RasterError(f"batch render returned {rendered}, expected {n}")
        out = []
        for i in range(n):
            w, h = int(dims[i, 0]), int(dims[i, 1])
            if w == 0 or h == 0:
                raise RasterError(f"page {first + i} failed to render")
            out.append(buf[i, : h * w * 3].reshape(h, w, 3))
        return out

    def page_primitives(self, page: int, dpi: float = 150.0):
        """Drawable primitives for on-device rasterization: ~KBs per page
        instead of MBs of pixels (see ops/glyph_render.py).

        Returns (glyphs (N,4) f32 [ascii, x_px, y_px_baseline, size_px],
        rects (M,5) f32 [x0,y0,x1,y1,gray255])."""
        cap = 65536
        buf = np.zeros((cap, 4), np.float32)
        n = self._lib.vcpr_get_glyphs(
            self._handle, page, dpi,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        )
        if n < 0:
            raise RasterError(f"glyph export failed for page {page}")
        glyphs = buf[: min(n, cap)].copy()
        rbuf = np.zeros((4096, 5), np.float32)
        m = self._lib.vcpr_get_rects(
            self._handle, page, dpi,
            rbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 4096,
        )
        if m < 0:
            raise RasterError(f"rect export failed for page {page}")
        rects = rbuf[: min(m, 4096)].copy()
        return glyphs, rects

    def page_complexity(self, page: int) -> int:
        """Content the on-device glyph renderer cannot reproduce: bit 0 =
        image XObjects, bit 1 = embedded-outline fonts.  Nonzero means the
        extract pipeline must ship pixels, not primitives."""
        flags = self._lib.vcpr_page_complexity(self._handle, page)
        if flags < 0:
            raise RasterError(f"bad page index {page}")
        return flags

    def extract_text(self, page: int, cap: int = 1 << 20) -> str:
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.vcpr_extract_text(self._handle, page, buf, cap)
        if n < 0:
            raise RasterError(f"text extraction failed for page {page}")
        return buf.raw[:n].decode("utf-8", errors="replace")

    def has_text_layer(self, sample_pages: int = 3) -> bool:
        """Heuristic: does this PDF carry extractable text?"""
        for p in range(min(self.page_count, sample_pages)):
            if len(self.extract_text(p).strip()) > 20:
                return True
        return False
