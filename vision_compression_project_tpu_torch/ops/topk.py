"""Masked cosine similarity and top-k over a device-resident embedding matrix.

`masked_similarity` routes on the device of `emb` alone: a CUDA tensor goes to
the hand-written kernel (kernels/masked_similarity.cu), a CPU tensor to
`masked_similarity_reference`, the plain version. It keeps the semantics of
vision_compression_project_tpu/ops/topk.py::masked_similarity: scores in f32,
-1e30 where the mask is not positive. Top-k runs outside the kernel
(`topk_lowest_first`), as `lax.top_k` runs outside the Pallas kernel there,
and orders equal scores as `lax.top_k` does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

from .. import kernels

NEG_INF = -1e30


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """f32 matrix products on the card in true f32 (TF32 off) within the
    block, as the reference's f32 products are; the flag is put back after."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


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


def topk_lowest_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of f32 `scores`: (values (..., k), indices
    (..., k)), in the order of `jax.lax.top_k`: by value in IEEE total order
    (so +0.0 above -0.0), and among equal values the lower index first, also
    for the ones tied at the k-th value. `torch.topk` promises no order for
    equal values, so this is a stable sort of the floats' bit patterns mapped
    to integers that sort in total order."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k masked cosine matches: (values (B, k), indices (B, k)), equal
    scores ordered as `topk_lowest_first` orders them."""
    return topk_lowest_first(masked_similarity(emb, queries, mask), k)
