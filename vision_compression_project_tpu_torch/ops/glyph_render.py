"""Page rasterization on the device from glyph streams: the port of
vision_compression_project_tpu/ops/glyph_render.py.

The PDF engine exports a page's drawable primitives (positioned glyphs and
rects, `PdfDocument.page_primitives`, a few KB) instead of its pixels, and the
device draws the page. Every glyph texel scales to an axis-aligned pixel
rectangle; a rectangle is the outer product of a row indicator and a column
indicator, so the count of rectangles covering each pixel is one matrix
product A^T B, A (R, H) row indicators and B (R, W) column indicators. The
geometry is the C++ renderer's (nearest-neighbour glyph scaling, truncation
to int, baseline at 3/4 of the cell), and the page equals the JAX function's
pixel for pixel: the counts are small integers, exact in any float type, and
only `count > 0` is read.

Texels with no ink, and texels of glyphs past a page's glyph count, are empty
rectangles in the reference; here they are dropped before the product, which
leaves every count as it was.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GLYPH_H, GLYPH_W = 16, 8
EM = 12.0  # cell height covering ascent + descent (cf. pdf_engine.cc draw_glyph)
# XLA compiles the reference's `size / EM` as a product with the f32
# reciprocal, which rounds differently at some sizes (25 px: 12 * sy is
# 25.000002, not 25); the port takes the same product so that its pages equal
# the JAX function's at every dpi.
_INV_EM = float(np.float32(1.0 / EM))
RECT_CHUNK = 8192  # rectangles per indicator product


@functools.lru_cache(maxsize=1)
def _atlas() -> np.ndarray:
    from ..raster.rasterizer import glyph_atlas

    return glyph_atlas().astype(np.float32)  # (95, 16, 8)


def _glyph_rects(glyphs: torch.Tensor, n_glyphs: int, atlas: torch.Tensor):
    """(G, 4) glyph records -> the (Y0, Y1, X0, X1) int32 texel rectangles
    that hold ink, flattened."""
    g = glyphs.shape[0]
    code = glyphs[:, 0].to(torch.int32)
    x, y, size = glyphs[:, 1], glyphs[:, 2], glyphs[:, 3]
    sy = torch.clamp(size * _INV_EM, min=1e-3)
    gw = torch.clamp(torch.ceil(GLYPH_W * sy), min=1.0)
    gh = torch.clamp(torch.ceil(GLYPH_H * sy), min=1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y - gh * 0.75)

    dev = glyphs.device
    ty = torch.arange(GLYPH_H, dtype=torch.float32, device=dev)[None, :, None]
    tx = torch.arange(GLYPH_W, dtype=torch.float32, device=dev)[None, None, :]
    syb = sy[:, None, None]
    # Target-pixel span of texel (ty, tx): [ceil(t*s), ceil((t+1)*s)), clipped
    # to the glyph box: the pixels whose nearest source texel is t.
    py0 = torch.ceil(ty * syb)
    py1 = torch.minimum(torch.ceil((ty + 1.0) * syb), gh[:, None, None])
    px0 = torch.ceil(tx * syb)
    px1 = torch.minimum(torch.ceil((tx + 1.0) * syb), gw[:, None, None])

    ink = atlas[torch.clamp(code - 32, 0, 94).long()]  # (G, 16, 8)
    valid = (
        (ink > 0)
        & ((code >= 32) & (code <= 126) & (torch.arange(g, device=dev) < n_glyphs))[:, None, None]
        & (py1 > py0)
        & (px1 > px0)
    )
    y0b, x0b = y0[:, None, None], x0[:, None, None]
    corners = [(y0b + py0), (y0b + py1), (x0b + px0), (x0b + px1)]
    return [c.expand_as(valid)[valid].to(torch.int32) for c in corners]


def _count_image(Y0, Y1, X0, X1, h: int, w: int) -> torch.Tensor:
    """(h, w) count of the rectangles covering each pixel, by chunked
    indicator products (bf16 on the card, f32 on the CPU; exact either way)."""
    dev = Y0.device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rows = torch.arange(h, dtype=torch.int32, device=dev)[None, :]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    count = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for s in range(0, Y0.shape[0], RECT_CHUNK):
        sl = slice(s, s + RECT_CHUNK)
        a = ((rows >= Y0[sl, None]) & (rows < Y1[sl, None])).to(dtype)
        b = ((cols >= X0[sl, None]) & (cols < X1[sl, None])).to(dtype)
        count += (a.T @ b).float()
    return count


def render_pages_from_glyphs(
    glyphs: torch.Tensor,
    n_glyphs: torch.Tensor,
    rects: torch.Tensor,
    n_rects: torch.Tensor,
    h: int,
    w: int,
) -> torch.Tensor:
    """Draw a batch of pages on the inputs' device.

    glyphs: (B, G, 4) f32 [ascii, x_px, y_px_baseline, size_px]
    n_glyphs: (B,) valid glyph counts
    rects: (B, M, 5) f32 [x0, y0, x1, y1, gray255]
    n_rects: (B,) valid rect counts
    Returns (B, h, w) uint8 grayscale: white background, rects under text.
    """
    dev = glyphs.device
    atlas = torch.from_numpy(_atlas()).to(dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    ng, nr = n_glyphs.tolist(), n_rects.tolist()
    pages = []
    for i in range(glyphs.shape[0]):
        text_count = _count_image(*_glyph_rects(glyphs[i], ng[i], atlas), h, w)
        # Rects (usually none): darkness = max over rects of indicator * (255 - gray).
        dark = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for rx0, ry0, rx1, ry1, gray in rects[i, : nr[i]]:
            ind = ((rows >= ry0) & (rows < ry1)).float()[:, None] * ((cols >= rx0) & (cols < rx1)).float()[None, :]
            dark = torch.maximum(dark, ind * (255.0 - gray))
        img = torch.where(text_count > 0, torch.zeros_like(dark), 255.0 - dark)
        pages.append(torch.clamp(torch.round(img), 0, 255).to(torch.uint8))
    return torch.stack(pages)


def pack_primitives(primitives, g_max: int = 2048, m_max: int = 64):
    """Host side: list of (glyphs (n, 4), rects (m, 5)) -> padded arrays
    (glyphs (B, g_max, 4), n_glyphs (B,), rects (B, m_max, 5), n_rects (B,))."""
    b = len(primitives)
    glyphs = np.zeros((b, g_max, 4), np.float32)
    n_glyphs = np.zeros((b,), np.int32)
    rects = np.zeros((b, m_max, 5), np.float32)
    n_rects = np.zeros((b,), np.int32)
    for i, (g, r) in enumerate(primitives):
        n = min(len(g), g_max)
        glyphs[i, :n] = g[:n]
        n_glyphs[i] = n
        m = min(len(r), m_max)
        rects[i, :m] = r[:m]
        n_rects[i] = m
    return glyphs, n_glyphs, rects, n_rects
