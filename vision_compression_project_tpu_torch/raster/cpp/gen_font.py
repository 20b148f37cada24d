#!/usr/bin/env python3
"""Generate font.h: an 8x16 monochrome ASCII glyph atlas for the rasterizer.

Renders ASCII 32..126 with PIL's built-in bitmap font into fixed 8x16 cells
and emits them as a C array (16 bytes per glyph, one byte per row, MSB left).
Run once at build time (Makefile dependency); the generated header is
committed so the C++ build has no Python dependency.
"""

from pathlib import Path

from PIL import Image, ImageDraw, ImageFont

CELL_W, CELL_H = 8, 16


def main() -> None:
    font = ImageFont.load_default()
    lines = [
        "// Generated by gen_font.py - 8x16 ASCII glyphs (32..126), 1bpp rows.",
        "#pragma once",
        "#include <cstdint>",
        f"constexpr int kGlyphW = {CELL_W};",
        f"constexpr int kGlyphH = {CELL_H};",
        "constexpr int kGlyphFirst = 32;",
        "constexpr int kGlyphLast = 126;",
        "constexpr uint8_t kGlyphs[95][16] = {",
    ]
    for code in range(32, 127):
        img = Image.new("L", (CELL_W, CELL_H), 0)
        draw = ImageDraw.Draw(img)
        draw.text((0, 2), chr(code), fill=255, font=font)
        rows = []
        for y in range(CELL_H):
            byte = 0
            for x in range(CELL_W):
                if img.getpixel((x, y)) > 96:
                    byte |= 0x80 >> x
            rows.append(f"0x{byte:02x}")
        lines.append(
            "  {" + ",".join(rows) + "}, // " + repr(chr(code))
        )
    lines.append("};")
    Path(__file__).with_name("font.h").write_text("\n".join(lines) + "\n")
    print("wrote font.h")


if __name__ == "__main__":
    main()
