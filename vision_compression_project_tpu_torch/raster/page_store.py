"""Compressed at-rest page-raster store: the port of
vision_compression_project_tpu/raster/page_store.py.

Pages are kept as quantized 8x8-DCT coefficients (ops/dct.py): the luma
plane at full resolution and the two chroma planes subsampled 2x2, one
`page_NNN.dct.npz` a page with the reference's keys and dtypes (h, w int32;
q float32; y, cb, cr int16), so either package reads the pages the other
wrote. The transforms run on `device`, the card unless the caller asks for
the CPU; the colour conversion and the files stay on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from ..ops.dct import dct8x8_decode, dct8x8_encode


def _to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.float32)
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = 128.0 - 0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1] + 0.5 * rgb[..., 2]
    cr = 128.0 + 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1] - 0.081312 * rgb[..., 2]
    return np.stack([y, cb, cr], axis=-1).clip(0, 255).astype(np.uint8)


def _to_rgb(ycbcr: np.ndarray) -> np.ndarray:
    y = ycbcr[..., 0].astype(np.float32)
    cb = ycbcr[..., 1].astype(np.float32) - 128.0
    cr = ycbcr[..., 2].astype(np.float32) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.stack([r, g, b], axis=-1).clip(0, 255).astype(np.uint8)


def _pad_to8(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, (-h) % 8), (0, (-w) % 8)), mode="edge")


class PageStore:
    """Directory of DCT-compressed page rasters for one document."""

    def __init__(self, root, quality_scale: float = 1.0, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PageStore: device 'cuda' asked for, but no CUDA device is available")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.quality_scale = quality_scale

    def _path(self, page: int) -> Path:
        return self.root / f"page_{page:03d}.dct.npz"

    def _encode(self, plane: np.ndarray) -> np.ndarray:
        return dct8x8_encode(torch.from_numpy(plane).to(self.device), self.quality_scale).cpu().numpy()

    def _decode(self, coeffs: np.ndarray, q: float) -> np.ndarray:
        return dct8x8_decode(torch.from_numpy(coeffs).to(self.device), q).cpu().numpy()

    def put(self, page: int, rgb: np.ndarray) -> Path:
        h, w = rgb.shape[:2]
        ycc = _to_ycbcr(rgb)
        out = {
            "h": np.int32(h),
            "w": np.int32(w),
            "q": np.float32(self.quality_scale),
            "y": self._encode(_pad_to8(ycc[..., 0])),
            # 2x2 chroma subsample.
            "cb": self._encode(_pad_to8(ycc[::2, ::2, 1])),
            "cr": self._encode(_pad_to8(ycc[::2, ::2, 2])),
        }
        path = self._path(page)
        np.savez_compressed(path, **out)
        return path

    def get(self, page: int) -> np.ndarray:
        with np.load(self._path(page)) as data:
            h, w = int(data["h"]), int(data["w"])
            q = float(data["q"])
            y = self._decode(data["y"], q)[:h, :w]
            ch, cw = -(-h // 2), -(-w // 2)
            cb = self._decode(data["cb"], q)[:ch, :cw]
            cr = self._decode(data["cr"], q)[:ch, :cw]
        cb = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
        cr = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
        return _to_rgb(np.stack([y, cb, cr], axis=-1))

    def pages(self) -> List[int]:
        return sorted(int(p.name[5:8]) for p in self.root.glob("page_*.dct.npz"))

    def stats(self) -> Dict:
        files = list(self.root.glob("page_*.dct.npz"))
        return {"pages": len(files), "bytes": sum(f.stat().st_size for f in files)}
