from .pdfgen import make_pdf
from .rasterizer import PdfDocument, RasterError, glyph_atlas

__all__ = ["PdfDocument", "RasterError", "glyph_atlas", "make_pdf"]
