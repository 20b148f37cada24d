"""Separable bilinear (area-like when downscaling) resize as two matrix
products, `R_h @ img @ R_w^T`, with the banded interpolation matrices of the
JAX package (vision_compression_project_tpu/ops/resize.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix.

    When downscaling, this is a triangle (tent) filter scaled by the
    downsample ratio, matching jax.image.resize(..., method='bilinear',
    antialias=True). Callers must not write to the cached array.
    """
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    support = max(scale, 1.0)
    out = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        for j in range(lo, hi + 1):
            if j < 0 or j >= in_size:
                # Out-of-range taps are dropped and the row renormalized.
                continue
            weight = max(0.0, 1.0 - abs(j - center) / support)
            out[i, j] += weight
        s = out[i].sum()
        if s > 0:
            out[i] /= s
    return out


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (..., H, W, C) uint8 or float images to f32."""
    h, w = images.shape[-3], images.shape[-2]
    r_h = torch.from_numpy(bilinear_matrix(h, out_h)).to(images.device)
    r_w = torch.from_numpy(bilinear_matrix(w, out_w)).to(images.device)
    x = images.to(torch.float32)
    x = torch.einsum("oh,...hwc->...owc", r_h, x)
    return torch.einsum("pw,...owc->...opc", r_w, x)
