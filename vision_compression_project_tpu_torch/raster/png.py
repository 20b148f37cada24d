"""A PNG reader in numpy and zlib, for page rasters written by other tools.

`read_png(path)` -> (H, W, C) uint8 array, C = 1 (gray), 3 (RGB) or 4
(RGBA). It reads 8-bit, non-interlaced files of those colour types, with all
five row filters (PNG specification, section 9); any other file (16-bit,
palette, gray + alpha, bit depths under 8, interlaced) raises ValueError.
`to_rgb` gives the (H, W, 3) array an RGB conversion gives: gray repeated,
alpha dropped.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of a (left), b (up), c (up-left), as int16."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, channels: int) -> np.ndarray:
    """Undo the row filters of `raw` (height rows of a filter byte and
    width x channels bytes) -> (height, width, channels) uint8.

    A pixel's prediction reads the decoded pixels to its left, above and
    above-left (one pixel, bpp bytes, back: each channel on its own), so the
    pixels on one anti-diagonal y + x = d depend only on earlier diagonals:
    each diagonal is decoded in one vector step, whatever each row's filter."""
    rows = raw.reshape(height, 1 + width * channels)
    kinds = rows[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"PNG: unknown row filter {int(kinds.max())}")
    data = rows[:, 1:].reshape(height, width, channels).astype(np.int16)
    # Decoded pixels with a zero row above and a zero column to the left.
    out = np.zeros((height + 1, width + 1, channels), np.int16)
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        xs = d - ys
        left, up, upleft = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        f = kinds[ys][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3], [np.zeros_like(left), left, up, (left + up) >> 1],
                         default=_paeth(left, up, upleft))
        out[ys + 1, xs + 1] = (data[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit gray, RGB or RGBA PNG."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}: only 8-bit gray, RGB and RGBA are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown compression or filter method")
    channels = _CHANNELS[colour]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, expected {height * (stride + 1)}")
    return _unfilter(raw, height, width, channels)


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8: gray repeated to three channels, alpha dropped."""
    if pixels.shape[-1] == 1:
        return np.repeat(pixels, 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])
