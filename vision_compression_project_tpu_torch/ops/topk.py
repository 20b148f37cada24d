"""Masked cosine similarity and top-k over a device-resident embedding matrix.

`masked_similarity` routes on the device of `emb` alone: a CUDA tensor goes to
the hand-written kernel (kernels/masked_similarity.cu), a CPU tensor to
`masked_similarity_reference`, the plain version. It keeps the semantics of
vision_compression_project_tpu/ops/topk.py::masked_similarity: scores in f32,
-1e30 where the mask is not positive. Top-k runs outside the kernel
(`torch.topk`), as `lax.top_k` runs outside the Pallas kernel there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

NEG_INF = -1e30


def masked_similarity_reference(
    emb: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """scores[b, n] = <queries[b], emb[n]> in f32, NEG_INF where mask[n] <= 0."""
    s = queries.to(torch.float32) @ emb.to(torch.float32).T
    return torch.where(mask.reshape(1, -1) > 0, s, torch.tensor(NEG_INF, device=s.device))


def masked_similarity(emb: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """emb (N, D) unit-norm index rows (so dot == cosine), queries (B, D)
    unit-norm, mask (N,) row filter -> scores (B, N) f32. CUDA tensors run the
    kernel and nothing else; CPU tensors run the plain version. The kernel
    takes at most kernels.SIMILARITY_MAX_QUERIES queries a launch, so a
    larger batch is scored in chunks of that many: any B >= 1 is served, and
    a batch within the limit (a /chat question's one) is one launch."""
    if emb.device.type == "cpu":
        return masked_similarity_reference(emb, queries, mask)
    if emb.device.type != "cuda":
        raise ValueError(f"masked_similarity runs on cuda or cpu, not {emb.device.type}")
    emb, mask = emb.contiguous(), mask.to(torch.float32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    step = kernels.SIMILARITY_MAX_QUERIES
    if queries.shape[0] <= step:
        return kernels.masked_similarity(emb, queries, mask)
    return torch.cat([kernels.masked_similarity(emb, queries[i : i + step], mask)
                      for i in range(0, queries.shape[0], step)])


def cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k masked cosine matches: (values (B, k), indices (B, k))."""
    return torch.topk(masked_similarity(emb, queries, mask), k, dim=-1)
