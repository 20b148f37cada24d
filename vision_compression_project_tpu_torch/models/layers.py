"""Transformer building blocks: RMSNorm, RoPE, attention with GQA and a KV
cache, SwiGLU. The port of vision_compression_project_tpu/models/layers.py.

Numeric contract, as in the reference: parameters are stored in f32 and cast
to the compute dtype at use (flax's `Dense(dtype=...)`), RMSNorm computes in
f32, attention keeps scores and softmax in f32. Whole-sequence attention goes
through `ops.attention.flash_attention` (the kernel on a CUDA tensor) where
the reference runs its Pallas kernel (`use_flash`), and through the plain
version where the reference runs XLA; single-token decode attends to the
cache with plain tensor code. With grad enabled, the encoder's and the
decoder's blocks are rematerialised (`remat`) as the reference's `nn.remat`
does: the backward recomputes each block's activations.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import NEG_INF, flash_attention, mha_reference

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def use_flash(s: int, head_dim: int) -> bool:
    """Whether a whole-sequence attention call takes the kernel: the rule of
    vision_compression_project_tpu/models/layers.py::_use_flash. Shorter
    sequences (ocr_bpe's 64-token windows) take the plain version there as
    here."""
    return s >= 128 and head_dim % 8 == 0


def _attend(q, k, v, kv_len, causal: bool) -> torch.Tensor:
    attend = flash_attention if use_flash(q.shape[2], q.shape[3]) else mha_reference
    return attend(q, k, v, kv_len=kv_len, causal=causal)


def remat(block: nn.Module, *args, **kwargs):
    """block(*args, **kwargs), with its activations recomputed in the
    backward instead of stored (the reference's `nn.remat`) when grad is
    enabled; a plain call otherwise, so inference is untouched."""
    if not torch.is_grad_enabled():
        return block(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=False, **kwargs
    )


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax's lecun_normal: truncated normal at two std, std corrected for the truncation.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


@torch.no_grad()
def init_weights_(model: nn.Module, g: torch.Generator) -> None:
    """Seeded random weights for every submodule, in module order, with the
    JAX package's initializers: lecun-normal Linear and Conv2d kernels, zero
    biases, unit RMSNorm scales, N(0, 0.02) embeddings. Parameters held
    outside these modules (position embeddings) are the caller's."""
    for module in model.modules():
        if isinstance(module, RMSNorm):
            module.scale.fill_(1.0)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], g)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 0.02, generator=g)


class Dense(nn.Linear):
    """nn.Linear with f32 parameters that computes in `dtype`: input, weight
    and bias are cast first, as flax's Dense(dtype=...) does."""

    def __init__(self, in_features: int, out_features: int, bias: bool, dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.scale.to(torch.float32)).to(x.dtype)


def rope_table(head_dim: int, max_seq: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_seq, head_dim//2) f32 cos/sin tables."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (S, D//2) already sliced to the positions."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, None].to(x.dtype)
    sin = sin[None, None].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    """Multi-head attention with optional GQA, RoPE, causality and KV cache.

    `forward` and `prefill` process whole sequences; `decode` consumes one
    token per batch element against a cache that it updates in place."""

    def __init__(
        self,
        dim: int,
        heads: int,
        kv_heads: int,
        head_dim: int,
        causal: bool = False,
        rope: bool = False,
        rope_theta: float = 10000.0,
        max_seq: int = 4096,
        dtype: str = "bfloat16",
    ):
        super().__init__()
        dt = torch_dtype(dtype)
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.causal, self.rope, self.max_seq = causal, rope, max_seq
        self.wq = Dense(dim, heads * head_dim, False, dt)
        self.wk = Dense(dim, kv_heads * head_dim, False, dt)
        self.wv = Dense(dim, kv_heads * head_dim, False, dt)
        self.wo = Dense(heads * head_dim, dim, False, dt)
        if rope:
            cos, sin = rope_table(head_dim, max_seq, rope_theta)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def _qkv(self, x: torch.Tensor):
        b, s, _ = x.shape
        q = self.wq(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        k = self.wk(x).view(b, s, self.kv_heads, self.head_dim).transpose(1, 2)
        v = self.wv(x).view(b, s, self.kv_heads, self.head_dim).transpose(1, 2)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        b, _, s, _ = o.shape
        return self.wo(o.transpose(1, 2).reshape(b, s, self.heads * self.head_dim))

    def forward(self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = x.shape[1]
        q, k, v = self._qkv(x)
        if self.rope:
            cos, sin = self.rope_cos[:s], self.rope_sin[:s]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return self._out(_attend(q, k, v, kv_len, self.causal))

    def prefill(
        self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None, cache_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache]:
        """Like forward, and also returns the KV cache padded to `cache_len`
        (default max_seq)."""
        s = x.shape[1]
        cache_len = cache_len or self.max_seq
        q, k, v = self._qkv(x)
        if self.rope:
            cos, sin = self.rope_cos[:s], self.rope_sin[:s]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = _attend(q, k, v, kv_len, self.causal)
        pad = cache_len - s
        cache = {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}
        return self._out(o), cache

    def decode(
        self, x: torch.Tensor, cache: Cache, pos: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, Cache]:
        """x: (B, 1, dim); pos: an int (lockstep batch, every row at one
        position) or a (B,) tensor (ragged batch).

        The new k/v row is written into `cache` in place: at one position for
        the lockstep batch, at each row's own position for the ragged one.
        GQA folds the query heads as (kv_head, group) against the shared
        cache instead of repeating it."""
        b = x.shape[0]
        cache_len = cache["k"].shape[2]
        lockstep = not torch.is_tensor(pos)
        q, k_new, v_new = self._qkv(x)  # (B, H, 1, D), (B, Hkv, 1, D) x2
        if self.rope:
            cos = self.rope_cos[pos]  # (D/2,) or (B, D/2)
            sin = self.rope_sin[pos]
            if not lockstep:
                cos, sin = cos[:, None, None, :], sin[:, None, None, :]
            d2 = self.head_dim // 2

            def rot(t):
                t1, t2 = t[..., :d2], t[..., d2:]
                c, s = cos.to(t.dtype), sin.to(t.dtype)
                return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

            q, k_new = rot(q), rot(k_new)
        k, v = cache["k"], cache["v"]
        if lockstep:
            k[:, :, pos] = k_new[:, :, 0]
            v[:, :, pos] = v_new[:, :, 0]
            pos_b = torch.full((b,), pos, dtype=torch.long, device=x.device)
        else:
            rows = torch.arange(b, device=x.device)
            k[rows, :, pos] = k_new[:, :, 0]
            v[rows, :, pos] = v_new[:, :, 0]
            pos_b = pos
        group = self.heads // self.kv_heads
        qg = q.reshape(b, self.kv_heads, group, self.head_dim).to(torch.float32)
        scores = torch.einsum("bhgd,bhsd->bhgs", qg, k.to(torch.float32)) * (self.head_dim ** -0.5)
        idx = torch.arange(cache_len, device=x.device)[None, None, None, :]
        mask = idx <= pos_b[:, None, None, None]
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=x.device))
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhgs,bhsd->bhgd", p, v.to(torch.float32)).to(x.dtype)
        return self.wo(o.reshape(b, 1, self.heads * self.head_dim)), cache


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: str = "bfloat16"):
        super().__init__()
        dt = torch_dtype(dtype)
        self.gate = Dense(dim, hidden, False, dt)
        self.up = Dense(dim, hidden, False, dt)
        self.down = Dense(hidden, dim, False, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))
