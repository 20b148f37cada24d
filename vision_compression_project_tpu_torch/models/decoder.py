"""Causal LM decoder (RMSNorm + RoPE + GQA + SwiGLU / Switch-MoE) with a KV
cache. The port of vision_compression_project_tpu/models/decoder.py; the
unembed runs in f32. With experts, every `expert_every`-th block (block 0
first) takes a SwitchMoE for its MLP, as in the reference. The full-sequence
forward rematerialises every block in training, as the reference's
`nn.remat(DecoderBlock)` does for `__call__`; prefill and decode are not.

The MoE's load-balancing term leaves a block through its return value, not
as module state, so the remat recompute in the backward cannot overwrite or
repeat it: `forward(..., aux_losses=[])` appends one term per Switch-MoE
block (`TopKMoE` has none).

Hybrid decoders (the port's own, `DecoderConfig.layer_types`, as LFM2's
`lfm2_moe`): a block's mixing op is attention or a gated short convolution
(`ShortConv`), each behind its RMSNorm with the residual around it, then
the MLP behind its own; blocks before `num_dense_layers` keep the dense
MLP, the rest take experts (`TopKMoE` with the "sigmoid" router). The cache
of a conv block is its conv state, {"conv": (B, kernel - 1, dim)}, beside
the attention blocks' {"k", "v"}.

Tensor parallelism: with its `model` shard of the vocab, the token
embedding is vocab-parallel and the unembed's logits are gathered over
`model` before the f32 cross-entropy (models/layers.py has the blocks')."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .configs import DecoderConfig
from ..parallel.mesh import AXIS_MODEL
from ..parallel.tensor_parallel import copy_to, gather_from, reduce_from
from .layers import (Attention, Cache, Dense, RMSNorm, ShortConv, SwiGLU, SwitchMoE, TopKMoE, mesh_coord, remat,
                     torch_dtype)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, use_moe: bool = False, kind: str = "full_attention"):
        super().__init__()
        self.kind = kind
        self.norm1 = RMSNorm(cfg.dim, cfg.norm_eps)
        if kind == "conv":
            self.conv = ShortConv(cfg.dim, cfg.conv_kernel, dtype=cfg.dtype)
        else:
            self.attn = Attention(
                cfg.dim, cfg.heads, cfg.kv_heads, cfg.head_dim, causal=True, rope=True,
                rope_theta=cfg.rope_theta, max_seq=cfg.max_seq, dtype=cfg.dtype, seq_parallel=True,
                qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            )
        self.norm2 = RMSNorm(cfg.dim, cfg.norm_eps)
        self.use_moe = use_moe
        if use_moe and cfg.router == "sigmoid":
            self.mlp = TopKMoE(cfg.dim, cfg.num_experts, cfg.expert_dim, cfg.experts_per_token, dtype=cfg.dtype)
        elif use_moe:
            self.mlp = SwitchMoE(cfg.dim, cfg.num_experts, cfg.expert_dim, cfg.capacity_factor, dtype=cfg.dtype)
        else:
            self.mlp = SwiGLU(cfg.dim, cfg.mlp_dim, dtype=cfg.dtype)

    def _mlp(self, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the MLP's output on norm2(x), the MoE's aux term or None)."""
        if self.use_moe:
            return self.mlp(self.norm2(x))
        return self.mlp(self.norm2(x)), None

    def forward(self, x, kv_len=None):
        """(output, the MoE's aux term or None)."""
        h = self.norm1(x)
        x = x + (self.conv(h) if self.kind == "conv" else self.attn(h, kv_len=kv_len))
        h, aux = self._mlp(x)
        return x + h, aux

    def prefill(self, x, kv_len=None, cache_len=None):
        if self.kind == "conv":
            h, cache = self.conv.prefill(self.norm1(x), kv_len=kv_len)
        else:
            h, cache = self.attn.prefill(self.norm1(x), kv_len=kv_len, cache_len=cache_len)
        x = x + h
        return x + self._mlp(x)[0], cache

    def decode(self, x, cache, pos):
        if self.kind == "conv":
            h, cache = self.conv.decode(self.norm1(x), cache)
        else:
            h, cache = self.attn.decode(self.norm1(x), cache, pos)
        x = x + h
        return x + self._mlp(x)[0], cache


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dt = torch_dtype(cfg.dtype)
        self.embed = nn.Embedding(cfg.vocab, cfg.dim)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, use_moe=cfg.block_moe(i), kind=cfg.block_kind(i)) for i in range(cfg.depth)
        )
        self.norm_f = RMSNorm(cfg.dim, cfg.norm_eps)
        self.unembed = Dense(cfg.dim, cfg.vocab, False, torch.float32)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype. With its `model` shard of
        the vocab, a rank looks up the ids in its range, zeroes the others
        and the ranks' rows are summed (vocab-parallel): each id's row comes
        from exactly one rank, so the sum is exact."""
        w = self.embed.weight
        n = w.shape[0]
        if n == self.cfg.vocab:
            return F.embedding(ids, w).to(self.dt)
        local = ids - mesh_coord(AXIS_MODEL) * n
        inside = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), w) * inside[..., None].to(w.dtype)
        return reduce_from(rows, (AXIS_MODEL,)).to(self.dt)

    def hidden_to_logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits over the whole vocab; with a `model` shard of the
        unembed, each rank's block of the vocab is gathered."""
        h = self.norm_f(h).to(torch.float32)
        if self.unembed.weight.shape[0] == self.cfg.vocab:
            return self.unembed(h)
        return gather_from(self.unembed(copy_to(h, (AXIS_MODEL,))), AXIS_MODEL, -1)

    def forward(
        self, x_emb: torch.Tensor, kv_len: Optional[torch.Tensor] = None,
        aux_losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Full-sequence forward: (B, S, dim) embeddings -> (B, S, vocab).
        Under a mesh whose `seq` dimension holds n > 1 ranks, this rank's
        (B, S/n, dim) chunk -> its (B, S/n, vocab) logits, attention through
        the ring. Each MoE block's load-balancing term is appended to
        `aux_losses` when it is a list."""
        h = x_emb
        for block in self.blocks:
            h, aux = remat(block, h, kv_len=kv_len)
            if aux is not None and aux_losses is not None:
                aux_losses.append(aux)
        return self.hidden_to_logits(h)

    def prefill(
        self, x_emb: torch.Tensor, kv_len: Optional[torch.Tensor] = None, cache_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, List[Cache]]:
        """Returns (hidden states (B, S, dim), caches padded to cache_len).

        The hidden states, not the logits: generation needs the logits of one
        position per row, which `hidden_to_logits` gives from a gathered row."""
        h = x_emb
        caches = []
        for block in self.blocks:
            h, cache = block.prefill(h, kv_len=kv_len, cache_len=cache_len)
            caches.append(cache)
        return h, caches

    def decode_step(
        self, x_emb: torch.Tensor, caches: List[Cache], pos: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, List[Cache]]:
        """x_emb: (B, 1, dim); pos: int or (B,). Returns (logits (B, vocab),
        caches), the caches updated in place."""
        h = x_emb
        for i, block in enumerate(self.blocks):
            h, caches[i] = block.decode(h, caches[i], pos)
        return self.hidden_to_logits(h)[:, 0], caches


def init_cache(
    cfg: DecoderConfig, batch: int, dtype: torch.dtype = torch.bfloat16, device="cuda"
) -> List[Cache]:
    """Zero caches for `batch` sequences (used when skipping prefill): KV
    for an attention block, the conv state for a conv block."""
    shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    return [
        {"conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.dim), dtype=dtype, device=device)}
        if cfg.block_kind(i) == "conv" else
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for i in range(cfg.depth)
    ]
