"""Two-stage vision encoder: windowed attention over patch tokens, a strided
convolution that downsamples the token grid, then global attention. The port
of vision_compression_project_tpu/models/vit.py; the window reshapes match it
exactly, and every block, local and global, is rematerialised in training as
the reference's `nn.remat(EncoderBlock)` is."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import VisionConfig
from .layers import Attention, Dense, RMSNorm, SwiGLU, remat, torch_dtype


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: str = "bfloat16"):
        super().__init__()
        self.norm1 = RMSNorm(dim)
        self.attn = Attention(dim, heads, heads, dim // heads, dtype=dtype)
        self.norm2 = RMSNorm(dim)
        self.mlp = SwiGLU(dim, dim * 4, dtype=dtype)

    def forward(self, x: torch.Tensor, kv_len=None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), kv_len=kv_len)
        return x + self.mlp(self.norm2(x))


class VisionEncoder(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.dt = torch_dtype(cfg.dtype)
        grid = cfg.grid
        patch_dim = cfg.patch * cfg.patch * 3
        self.patch_embed = Dense(patch_dim, cfg.dim_local, True, self.dt)
        self.pos_embed = nn.Parameter(torch.zeros(grid * grid, cfg.dim_local))
        self.local_blocks = nn.ModuleList(
            EncoderBlock(cfg.dim_local, cfg.heads_local, cfg.dtype) for _ in range(cfg.depth_local)
        )
        ds = cfg.downsample
        self.downsample = nn.Conv2d(cfg.dim_local, cfg.dim_global, kernel_size=ds, stride=ds)
        self.global_blocks = nn.ModuleList(
            EncoderBlock(cfg.dim_global, cfg.heads_global, cfg.dtype) for _ in range(cfg.depth_global)
        )
        self.norm_out = RMSNorm(cfg.dim_global)

    def forward(self, patch_tokens: torch.Tensor) -> torch.Tensor:
        """(B, grid*grid, patch*patch*3) -> (B, tokens_out, dim_global)."""
        cfg = self.cfg
        b, p, _ = patch_tokens.shape
        grid = cfg.grid
        if p != grid * grid:
            raise ValueError(f"{p} patch tokens, expected {grid * grid}")
        dl = cfg.dim_local
        x = self.patch_embed(patch_tokens) + self.pos_embed.to(self.dt)[None]

        # Stage 1: attention inside (window x window) tiles of the patch grid.
        win = min(cfg.window, grid)
        nw = grid // win
        for block in self.local_blocks:
            xw = x.reshape(b, nw, win, nw, win, dl).permute(0, 1, 3, 2, 4, 5)
            xw = remat(block, xw.reshape(b * nw * nw, win * win, dl))
            xw = xw.reshape(b, nw, nw, win, win, dl).permute(0, 1, 3, 2, 4, 5)
            x = xw.reshape(b, grid * grid, dl)

        # Token-grid downsample: VALID strided conv (kernel = stride = ds).
        ds = cfg.downsample
        side = grid // ds
        x2d = x.reshape(b, grid, grid, dl).permute(0, 3, 1, 2)
        x2d = F.conv2d(
            x2d, self.downsample.weight.to(self.dt), self.downsample.bias.to(self.dt), stride=ds
        )
        x = x2d.permute(0, 2, 3, 1).reshape(b, side * side, cfg.dim_global)

        # Stage 2: global attention over the compressed token set.
        for block in self.global_blocks:
            x = remat(block, x)
        return self.norm_out(x)
