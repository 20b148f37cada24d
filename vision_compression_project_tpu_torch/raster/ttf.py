"""Minimal TrueType metrics reader (pure stdlib) for PDF font embedding: the
port's copy of vision_compression_project_tpu/raster/ttf.py.

Reads just enough of a .ttf to embed it as a PDF simple-TrueType font
(pdfgen.make_pdf `fonts=` parameter): unitsPerEm (head), ascender/descender
(hhea), advance widths (hmtx) and the unicode cmap (format 4 or 12), so the
generated /Widths array matches the outlines the C++ engine rasterizes from
FontFile2 (raster/cpp/pdf_engine.cc — code_to_gid resolves through the same
cmap).  The reference never synthesizes PDFs (it only consumes them via
Poppler, reference backend/app/pipeline/pdf_extract.py:107-122); this
exists so training/eval pages can rotate REAL system fonts instead of the
engine's builtin atlas — font-diverse synthetic data for the OCR model.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path
from typing import Dict, Tuple


class TtfMetrics:
    """Parsed metrics of one TrueType font file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        data = self.path.read_bytes()
        self.data = data
        if len(data) < 12:
            raise ValueError(f"not a TrueType file: {self.path}")
        (tag,) = struct.unpack(">I", data[:4])
        if tag not in (0x00010000, 0x74727565):  # 1.0 | 'true'
            raise ValueError(f"unsupported sfnt version in {self.path}")
        (num_tables,) = struct.unpack(">H", data[4:6])
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(num_tables):
            off = 12 + 16 * i
            name, _, t_off, t_len = struct.unpack(">4sIII", data[off : off + 16])
            self.tables[name] = (t_off, t_len)
        self._parse_head()
        self._parse_hhea()
        self._parse_hmtx()
        self._parse_cmap()

    def _table(self, name: bytes) -> bytes:
        off, length = self.tables[name]
        return self.data[off : off + length]

    def _parse_head(self) -> None:
        head = self._table(b"head")
        self.units_per_em = struct.unpack(">H", head[18:20])[0] or 1000
        self.bbox = struct.unpack(">4h", head[36:44])  # xMin yMin xMax yMax

    def _parse_hhea(self) -> None:
        hhea = self._table(b"hhea")
        self.ascent, self.descent = struct.unpack(">2h", hhea[4:8])
        (self.num_hmetrics,) = struct.unpack(">H", hhea[34:36])

    def _parse_hmtx(self) -> None:
        hmtx = self._table(b"hmtx")
        n = self.num_hmetrics
        self._advances = [
            struct.unpack(">H", hmtx[4 * i : 4 * i + 2])[0] for i in range(n)
        ]

    def _parse_cmap(self) -> None:
        cmap = self._table(b"cmap")
        (n_sub,) = struct.unpack(">H", cmap[2:4])
        best = None
        for i in range(n_sub):
            plat, enc, off = struct.unpack(">HHI", cmap[4 + 8 * i : 12 + 8 * i])
            if (plat, enc) in ((3, 1), (0, 3), (0, 4), (3, 10)):
                fmt = struct.unpack(">H", cmap[off : off + 2])[0]
                if fmt in (4, 12) and (best is None or fmt == 4):
                    best = (fmt, off)
        if best is None:
            raise ValueError(f"no unicode cmap in {self.path}")
        fmt, off = best
        self.char_to_gid: Dict[int, int] = {}
        if fmt == 4:
            seg2 = struct.unpack(">H", cmap[off + 6 : off + 8])[0]
            segs = seg2 // 2
            ends = struct.unpack(f">{segs}H", cmap[off + 14 : off + 14 + seg2])
            p = off + 16 + seg2
            starts = struct.unpack(f">{segs}H", cmap[p : p + seg2])
            p += seg2
            deltas = struct.unpack(f">{segs}h", cmap[p : p + seg2])
            p += seg2
            range_off_pos = p
            range_offs = struct.unpack(f">{segs}H", cmap[p : p + seg2])
            for s in range(segs):
                if starts[s] > ends[s] or ends[s] == 0xFFFF and starts[s] == 0xFFFF:
                    continue
                for c in range(starts[s], min(ends[s], 0x2FFF) + 1):
                    if range_offs[s] == 0:
                        gid = (c + deltas[s]) & 0xFFFF
                    else:
                        gpos = (
                            range_off_pos
                            + 2 * s
                            + range_offs[s]
                            + 2 * (c - starts[s])
                        )
                        gid = struct.unpack(">H", cmap[gpos : gpos + 2])[0]
                        if gid:
                            gid = (gid + deltas[s]) & 0xFFFF
                    if gid:
                        self.char_to_gid[c] = gid
        else:  # format 12
            (n_groups,) = struct.unpack(">I", cmap[off + 12 : off + 16])
            for g in range(n_groups):
                p = off + 16 + 12 * g
                start, end, start_gid = struct.unpack(">3I", cmap[p : p + 12])
                for c in range(start, min(end, 0x2FFF) + 1):
                    self.char_to_gid[c] = start_gid + (c - start)

    # -- public metrics -----------------------------------------------------

    def advance(self, codepoint: int) -> int:
        """Advance width in font units for a unicode codepoint (glyph 0's
        width when unmapped — matching what the renderer will draw)."""
        gid = self.char_to_gid.get(codepoint, 0)
        if gid >= len(self._advances):
            gid = len(self._advances) - 1  # monospace tail shares the last
        return self._advances[gid]

    def advance_em(self, codepoint: int) -> float:
        return self.advance(codepoint) / self.units_per_em

    def text_width_em(self, text: str) -> float:
        """Width of `text` in ems (multiply by font size for points)."""
        return sum(self.advance_em(ord(c)) for c in text)

    def pdf_widths(self, first: int = 32, last: int = 255) -> list:
        """/Widths array in 1000-unit glyph space (latin-1 charcodes)."""
        scale = 1000.0 / self.units_per_em
        return [round(self.advance(c) * scale) for c in range(first, last + 1)]

    def pdf_font_descriptor_values(self) -> dict:
        scale = 1000.0 / self.units_per_em
        x0, y0, x1, y1 = self.bbox
        return {
            "FontBBox": [round(v * scale) for v in (x0, y0, x1, y1)],
            "Ascent": round(self.ascent * scale),
            "Descent": round(self.descent * scale),
            "CapHeight": round(self.ascent * scale),
        }


@functools.lru_cache(maxsize=16)
def load_metrics(path: str) -> TtfMetrics:
    return TtfMetrics(path)


# Candidate system fonts for font-diverse synthetic pages, in preference
# order; use `available_system_fonts()` to get the ones present.
SYSTEM_FONT_PATHS = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
)


def available_system_fonts() -> list:
    return [p for p in SYSTEM_FONT_PATHS if Path(p).exists()]
