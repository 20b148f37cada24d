"""Minimal synthetic PDF writer (pure Python, stdlib only): the port's copy of
vision_compression_project_tpu/raster/pdfgen.py.

Produces simple multi-page text PDFs for tests and benchmarks, so the suite
never depends on external documents.  Streams can optionally be Flate-
compressed to exercise the C++ engine's decode path.

Fonts: each page draws with either the non-embedded /Helvetica (rendered by
the engine's builtin atlas) or an EMBEDDED TrueType font (`fonts=` paths to
.ttf files — FontFile2 + accurate /Widths from the font's own hmtx/cmap via
raster/ttf.py), so synthetic training pages can rotate real glyph designs.
The reference app only ever consumed PDFs (Poppler, reference
backend/app/pipeline/pdf_extract.py:107-122); generation exists here for the
training/eval loop the reference lacked.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Union

PAGE_W, PAGE_H = 612, 792  # US Letter, points

# Font spec aliases accepted anywhere a font is named (train CLIs, bench
# env knobs, ship meta): "builtin" or a .ttf path / alias below.
FONT_ALIASES = {
    "dejavu_sans": "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "dejavu_serif": "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "dejavu_mono": "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "dejavu_sans_bold": "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "dejavu_serif_bold": "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
}


def resolve_font(spec: str) -> str:
    """Alias/path -> canonical spec ("builtin" or absolute .ttf path)."""
    if spec in (None, "", "builtin"):
        return "builtin"
    return FONT_ALIASES.get(spec, spec)


def _escape(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def _tounicode_cmap() -> bytes:
    """Identity latin-1 ToUnicode CMap (codes 32..255)."""
    return (
        b"/CIDInit /ProcSet findresource begin\n"
        b"12 dict begin\nbegincmap\n"
        b"/CMapName /VCP-Latin1 def\n/CMapType 2 def\n"
        b"1 begincodespacerange\n<20> <ff>\nendcodespacerange\n"
        b"1 beginbfrange\n<20> <ff> <0020>\nendbfrange\n"
        b"endcmap\nCMapName currentdict /CMap defineresource pop\nend\nend\n"
    )


def make_pdf(
    pages: Sequence[Union[str, List[str]]],
    path,
    compress: bool = False,
    font_size: int = 12,
    margin: int = 72,
    fonts: Optional[Sequence[str]] = None,
    page_fonts: Optional[Sequence[int]] = None,
) -> Path:
    """Write a PDF where each element of `pages` is the page's text
    (string with newlines, or list of lines).

    fonts: font specs available to pages — "builtin" (non-embedded
    Helvetica, engine atlas) or a .ttf path/alias (embedded TrueType).
    page_fonts: per-page index into `fonts` (default: all pages use
    fonts[0]).  Default is the historical single builtin font.
    """
    path = Path(path)
    fonts = [resolve_font(f) for f in (fonts or ["builtin"])]
    n_pages = len(pages)
    if page_fonts is None:
        page_fonts = [0] * n_pages
    if len(page_fonts) != n_pages:
        raise ValueError("page_fonts must have one entry per page")

    header = b"%PDF-1.4\n%\xc7\xec\x8f\xa2\n"
    out = bytearray(header)
    offsets = {}

    def emit(num: int, body: bytes):
        offsets[num] = len(out)
        out.extend(f"{num} 0 obj\n".encode())
        out.extend(body)
        out.extend(b"\nendobj\n")

    # Object numbering plan: 1 catalog, 2 pages root, then font objects
    # (builtin: 1 obj; embedded TTF: font + descriptor + FontFile2 +
    # ToUnicode = 4 objs), then per page: page dict + contents.
    next_obj = 3
    font_obj_ids: List[int] = []
    font_emits = []  # deferred (num, body) pairs, emitted after pages root
    for spec in fonts:
        if spec == "builtin":
            fid = next_obj
            next_obj += 1
            font_emits.append(
                (fid, b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
            )
        else:
            from .ttf import load_metrics

            m = load_metrics(spec)
            raw = m.data
            ff = zlib.compress(raw)
            fid, desc_id, ff_id, tu_id = range(next_obj, next_obj + 4)
            next_obj += 4
            base = Path(spec).stem.replace(" ", "")
            fdv = m.pdf_font_descriptor_values()
            widths = " ".join(str(w) for w in m.pdf_widths(32, 255))
            font_emits.append((fid, (
                f"<< /Type /Font /Subtype /TrueType /BaseFont /{base} "
                f"/FirstChar 32 /LastChar 255 /Widths [{widths}] "
                f"/Encoding /WinAnsiEncoding /FontDescriptor {desc_id} 0 R "
                f"/ToUnicode {tu_id} 0 R >>"
            ).encode()))
            bbox = " ".join(str(v) for v in fdv["FontBBox"])
            font_emits.append((desc_id, (
                f"<< /Type /FontDescriptor /FontName /{base} /Flags 32 "
                f"/FontBBox [{bbox}] /ItalicAngle 0 "
                f"/Ascent {fdv['Ascent']} /Descent {fdv['Descent']} "
                f"/CapHeight {fdv['CapHeight']} /StemV 80 "
                f"/FontFile2 {ff_id} 0 R >>"
            ).encode()))
            font_emits.append((ff_id, (
                f"<< /Length {len(ff)} /Length1 {len(raw)} "
                f"/Filter /FlateDecode >>"
            ).encode() + b"\nstream\n" + ff + b"\nendstream"))
            tu = _tounicode_cmap()
            font_emits.append((tu_id, (
                f"<< /Length {len(tu)} >>".encode()
                + b"\nstream\n" + tu + b"\nendstream"
            )))
        font_obj_ids.append(fid)

    first_page_obj = next_obj
    kids = " ".join(f"{first_page_obj + 2 * i} 0 R" for i in range(n_pages))
    emit(1, b"<< /Type /Catalog /Pages 2 0 R >>")
    emit(
        2,
        f"<< /Type /Pages /Kids [{kids}] /Count {n_pages} "
        f"/MediaBox [0 0 {PAGE_W} {PAGE_H}] >>".encode(),
    )
    for num, body in font_emits:
        emit(num, body)

    for i, page in enumerate(pages):
        lines = page.splitlines() if isinstance(page, str) else list(page)
        fk = page_fonts[i]
        leading = int(font_size * 1.4)
        ops = [b"BT", f"/F{fk + 1} {font_size} Tf".encode(), f"{leading} TL".encode()]
        ops.append(f"{margin} {PAGE_H - margin} Td".encode())
        for line in lines:
            ops.append(b"(" + _escape(line).encode("latin-1", "replace") + b") Tj T*")
        ops.append(b"ET")
        stream = b"\n".join(ops)
        if compress:
            stream = zlib.compress(stream)
            cdict = f"<< /Length {len(stream)} /Filter /FlateDecode >>".encode()
        else:
            cdict = f"<< /Length {len(stream)} >>".encode()
        res = " ".join(
            f"/F{k + 1} {oid} 0 R" for k, oid in enumerate(font_obj_ids)
        )
        emit(
            first_page_obj + 2 * i,
            f"<< /Type /Page /Parent 2 0 R /Resources << /Font << {res} >> >> "
            f"/Contents {first_page_obj + 2 * i + 1} 0 R >>".encode(),
        )
        emit(first_page_obj + 2 * i + 1, cdict + b"\nstream\n" + stream + b"\nendstream")

    # xref
    n_obj = first_page_obj - 1 + 2 * n_pages
    xref_pos = len(out)
    out.extend(f"xref\n0 {n_obj + 1}\n".encode())
    out.extend(b"0000000000 65535 f \n")
    for num in range(1, n_obj + 1):
        out.extend(f"{offsets[num]:010d} 00000 n \n".encode())
    out.extend(
        f"trailer\n<< /Size {n_obj + 1} /Root 1 0 R >>\n"
        f"startxref\n{xref_pos}\n%%EOF\n".encode()
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))
    return path
