"""Page-raster preprocessing: uint8 pages -> normalized patch tokens, as the
JAX package does it (vision_compression_project_tpu/ops/preprocess.py):
f32 convert, separable bilinear resize, gray -> RGB broadcast after the
resize, normalize, patchify in (row, col, channel) order, cast."""

from __future__ import annotations

import torch

from .resize import resize_bilinear

# Map uint8 [0, 255] -> [-1, 1], the same in every channel.
NORM_MEAN = 127.5
NORM_STD = 127.5


def patchify_normalize(
    images: torch.Tensor, patch: int = 16, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """(B, H, W, C) float/uint8 -> (B, (H//patch)*(W//patch), patch*patch*C)."""
    b, h, w, c = images.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} is not a multiple of patch {patch}")
    x = (images.to(torch.float32) - NORM_MEAN) / NORM_STD
    x = x.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c).to(out_dtype)


def preprocess_pages(
    pages_u8: torch.Tensor,
    target_h: int = 1024,
    target_w: int = 1024,
    patch: int = 16,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, W), (B, H, W, 1) or (B, H, W, 3) uint8 pages ->
    (B, (target_h//patch)*(target_w//patch), patch*patch*3) tokens.

    Gray pages are resized as one channel and broadcast to RGB afterwards."""
    if pages_u8.dim() == 3:
        pages_u8 = pages_u8[..., None]
    resized = resize_bilinear(pages_u8, target_h, target_w)
    if resized.shape[-1] == 1:
        resized = resized.expand(*resized.shape[:-1], 3)
    return patchify_normalize(resized, patch=patch, out_dtype=out_dtype)
