"""The port's PNG reader (raster/png.py, numpy and zlib) against PIL, which
only the test imports: files PIL writes, and files written here with one
row filter each (None, Sub, Up, Average, Paeth, and all five in turn) that
PIL decodes. Gray, RGB and RGBA, odd widths; bit-exact. 16-bit, palette and
interlaced files raise, as do a bad CRC and truncated image data.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vision_compression_project_tpu_torch.raster.png import read_png, to_rgb

MODES = {1: "L", 3: "RGB", 4: "RGBA"}
COLOUR_TYPES = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_bytes(width, height, depth, colour, interlace, raw: bytes) -> bytes:
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _filtered(pixels: np.ndarray, kind: int) -> bytes:
    """The PNG image data of (H, W, C) uint8 pixels with row filter `kind`
    (-1: row y takes filter y % 5), written from the specification."""
    h, w, c = pixels.shape
    out, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        line = pixels[y].reshape(-1).astype(np.int64)
        f = y % 5 if kind < 0 else kind
        res = np.zeros_like(line)
        for x in range(w * c):
            a = line[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            res[x] = (line[x] - pred) & 0xFF
        out.append(bytes([f]) + res.astype(np.uint8).tobytes())
        prev = line
    return b"".join(out)


def _pixels(seed, h, w, c):
    """Seeded pixels with smooth gradients and noise, so every filter sees
    carries, wraps and each Paeth branch."""
    rng = np.random.default_rng(seed)
    ramp = (np.arange(h)[:, None, None] * 37 + np.arange(w)[None, :, None] * 11 + np.arange(c) * 61) % 256
    noise = rng.integers(0, 256, (h, w, c))
    return np.where(rng.random((h, w, c)) < 0.5, ramp, noise).astype(np.uint8)


def _pil(path):
    arr = np.asarray(Image.open(path))
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("width,height", [(1, 1), (13, 7), (64, 3), (257, 9)])
def test_pil_written_files(tmp_path, channels, width, height):
    px = _pixels(width * height, height, width, channels)
    path = tmp_path / "pil.png"
    Image.fromarray(px[..., 0] if channels == 1 else px, MODES[channels]).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (height, width, channels)
    assert np.array_equal(got, px) and np.array_equal(got, _pil(path))
    assert np.array_equal(to_rgb(got), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, -1], ids=["none", "sub", "up", "average", "paeth", "all"])
def test_each_row_filter(tmp_path, channels, kind):
    px = _pixels(kind + 10, 6, 11, channels)
    path = tmp_path / "filtered.png"
    path.write_bytes(_png_bytes(11, 6, 8, COLOUR_TYPES[channels], 0, _filtered(px, kind)))
    assert np.array_equal(_pil(path), px)  # the file is right: PIL reads it back
    assert np.array_equal(read_png(path), px)


def test_refuses_16_bit(tmp_path):
    path = tmp_path / "deep.png"
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 4000).save(path)  # mode I;16
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(path)


def test_refuses_palette(tmp_path):
    path = tmp_path / "palette.png"
    Image.fromarray(_pixels(1, 5, 5, 3), "RGB").convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(path)


def test_refuses_interlaced(tmp_path):
    path = tmp_path / "interlaced.png"
    px = _pixels(2, 4, 4, 3)
    path.write_bytes(_png_bytes(4, 4, 8, 2, 1, _filtered(px, 0)))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


def test_refuses_corrupt_files(tmp_path):
    px = _pixels(3, 4, 5, 3)
    good = _png_bytes(5, 4, 8, 2, 0, _filtered(px, 4))
    bad_crc = tmp_path / "crc.png"
    bad_crc.write_bytes(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    with pytest.raises(ValueError, match="CRC"):
        read_png(bad_crc)
    short = tmp_path / "short.png"
    short.write_bytes(_png_bytes(5, 4, 8, 2, 0, _filtered(px, 4)[:-3]))
    with pytest.raises(ValueError, match="image data"):
        read_png(short)
    other = tmp_path / "other.png"
    other.write_bytes(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(other)
