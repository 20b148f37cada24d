"""Collectives of retrieval and the sharded index: the port of
vision_compression_project_tpu/parallel/collectives.py.

The index rows are sharded over the mesh `data` dimension. A query is
answered by a masked similarity and a top-k on each rank's shard
(`local_topk`: K2, kernels/masked_similarity.cu, on the card), then an
all-gather of the k candidates of every shard, shard-major as the
reference's `all_gather(..., tiled=True)`, and a top-k over them
(`merge_topk`): k candidates a shard cross the network, never a score
vector. Both top-ks order equal scores as `lax.top_k` does, so ties go to the
lower position in the gathered list: the lower shard, then the lower row.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.topk import masked_similarity, topk_lowest_first
from .mesh import AXIS_DATA
from .tensor_parallel import gather_cat


def _all_gather_cat(x: torch.Tensor, mesh: DeviceMesh, dim: int) -> torch.Tensor:
    """Every data-rank's `x` concatenated along `dim` in rank order."""
    return gather_cat(x, AXIS_DATA, dim, mesh)


def merge_topk(all_vals: torch.Tensor, all_idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of the gathered candidates (..., n_shards * k), shard-major:
    (values, global row indices)."""
    vals, pos = topk_lowest_first(all_vals, k)
    return vals, torch.gather(all_idx, -1, pos)


def distributed_topk(mesh: DeviceMesh, scores_local: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of a score vector whose rows are sharded over `data`:
    scores_local is this rank's (rows_local,) block. Returns (values (k,),
    global row indices (k,)), the same on every rank."""
    rows_local = scores_local.shape[-1]
    vals, idx = topk_lowest_first(scores_local, k)
    gidx = idx + mesh.get_local_rank(AXIS_DATA) * rows_local
    return merge_topk(_all_gather_cat(vals, mesh, 0), _all_gather_cat(gidx, mesh, 0), k)


def local_topk(rows_l: torch.Tensor, mask_l: torch.Tensor, queries: torch.Tensor, k: int,
               shard: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's step of `sharded_cosine_topk`: scores of the queries (Q, D)
    against the shard's rows (r_local, D), -1e30 where mask_l <= 0 (one K2
    launch per 8 queries on the card, the plain version on the CPU), their
    top k, and the rows' global indices (shard * r_local + local row)."""
    vals, idx = topk_lowest_first(masked_similarity(rows_l, queries, mask_l), k)
    return vals, idx + shard * rows_l.shape[0]


def sharded_cosine_topk(
    mesh: DeviceMesh,
    rows_local: torch.Tensor,
    mask_local: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-query masked cosine top-k over row-sharded index embeddings:
    rows_local (r_local, D) and mask_local (r_local,) are this rank's
    shard, queries (Q, D) unit-norm and the same on every rank. Returns
    ((Q, k) values, (Q, k) global row indices), the same on every rank."""
    vals, gidx = local_topk(rows_local, mask_local, queries, k, mesh.get_local_rank(AXIS_DATA))
    return merge_topk(_all_gather_cat(vals, mesh, 1), _all_gather_cat(gidx, mesh, 1), k)


def ring_all_gather_rows(mesh: DeviceMesh, shard_rows: torch.Tensor) -> torch.Tensor:
    """The row shards of every data-rank stacked in rank order: the
    replicated matrix."""
    return _all_gather_cat(shard_rows, mesh, 0)
