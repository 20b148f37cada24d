"""8x8 JPEG-style DCT re-encode and decode: the port of
vision_compression_project_tpu/ops/dct.py.

Page rasters kept at rest as quantized 8x8-DCT coefficients (int16, mostly
zero) instead of uint8 pixels. The 2D DCT of an 8x8 block is C @ X @ C^T:
two small matrix products per block, which the reference leaves to XLA
(no Pallas kernel), so they are plain tensor products here, on the device
of the input. Rounding is half to even on both sides.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Standard JPEG luminance quantization table (quality ~50).
JPEG_LUMA_QTABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    c = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            c[k, n] = np.cos(np.pi * (2 * n + 1) * k / 16.0)
    c *= np.sqrt(2.0 / 8.0)
    c[0] *= 1.0 / np.sqrt(2.0)
    return c


def _tables(device: torch.device, quality_scale: float):
    c = torch.from_numpy(_dct_matrix()).to(device)
    q = torch.from_numpy(JPEG_LUMA_QTABLE).to(device) * quality_scale
    return c, q


def _to_blocks(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//8, W//8, 8, 8)."""
    *lead, h, w = img.shape
    return img.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    *lead, hb, wb, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, hb * 8, wb * 8)


def dct8x8_encode(img_u8: torch.Tensor, quality_scale: float = 1.0) -> torch.Tensor:
    """uint8 (..., H, W) grayscale plane -> int16 quantized DCT coefficients
    (..., H//8, W//8, 8, 8). H, W must be multiples of 8."""
    c, q = _tables(img_u8.device, quality_scale)
    x = _to_blocks(img_u8.to(torch.float32) - 128.0)
    coeffs = torch.einsum("ij,...jk,lk->...il", c, x, c)
    return torch.round(coeffs / q).to(torch.int16)


def dct8x8_decode(coeffs_i16: torch.Tensor, quality_scale: float = 1.0) -> torch.Tensor:
    """Inverse of dct8x8_encode; returns uint8 (..., H, W)."""
    c, q = _tables(coeffs_i16.device, quality_scale)
    x = coeffs_i16.to(torch.float32) * q
    blocks = torch.einsum("ji,...jk,kl->...il", c, x, c)
    img = _from_blocks(blocks) + 128.0
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
