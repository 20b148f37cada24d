"""The collectives of sharded training in the local view: what XLA inserts
for the reference's annotated shardings (`with_partitioning`,
`constrain`), written out over the mesh dimensions' process groups.

Tensor parallelism over `model` uses two autograd operators, as Megatron-LM
does: `copy_to` (identity forward, all-reduce of the gradient backward) in
front of a column-parallel projection, whose input every rank holds whole,
and `reduce_from` (all-reduce forward, identity backward) behind a
row-parallel one, whose outputs are partial sums. `gather_from` all-gathers
a dimension sharded over a mesh dimension (the vocab-parallel logits, the
expert-parallel router logits); its backward keeps this rank's slice of the
gradient. Every rank of a `model` or `expert` group computes the same loss,
so a parameter replicated over those dimensions gets the same gradient on
each of its ranks and is never reduced again over them; gradients are summed
over `data` and `seq`, whose ranks hold different tokens (`sum_over`).

Every operator takes its mesh from the argument or the active mesh
(`use_mesh`) and is the identity where there is none or where the
dimensions it names hold one rank each: a mesh of 1 changes no number.
Reductions of bf16 tensors run in f32 and round once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size
from .sharding import active_mesh


def _live_axes(mesh: Optional[DeviceMesh], axes: Sequence[str]) -> List[str]:
    """The dimensions of `axes` that hold more than one rank of `mesh`."""
    if mesh is None:
        return []
    return [a for a in axes if axis_size(mesh, a) > 1]


def group_size(mesh: Optional[DeviceMesh], axes: Sequence[str]) -> int:
    """The number of ranks spanned by the mesh dimensions `axes` together."""
    n = 1
    for a in _live_axes(mesh, axes):
        n *= axis_size(mesh, a)
    return n


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of `t` over the ranks of `axes` (a new tensor; bf16 summed in f32)."""
    buf = t.to(torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype).contiguous().clone()
    for a in axes:
        dist.all_reduce(buf, group=mesh.get_group(a))
    return buf.to(t.dtype)


def sum_over(t: torch.Tensor, axes: Sequence[str], mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The sum of `t` over the ranks of the mesh dimensions `axes`, without a
    gradient (counts, norms, losses, gradients); `t` itself where they hold
    one rank."""
    mesh = mesh if mesh is not None else active_mesh()
    live = _live_axes(mesh, axes)
    return _all_reduce(t, mesh, live) if live else t


def gather_cat(t: torch.Tensor, axis: str, dim: int, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every rank's `t` along the mesh dimension `axis`, concatenated along
    `dim` in rank order, without a gradient."""
    mesh = mesh if mesh is not None else active_mesh()
    if not _live_axes(mesh, [axis]):
        return t
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.n, ctx.idx, ctx.dim = axis_size(mesh, axis), mesh.get_local_rank(axis), dim
        return gather_cat(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.idx].contiguous(), None, None, None


def copy_to(x: torch.Tensor, axes: Sequence[str], mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """x, whose gradient is summed over the ranks of `axes` in the backward:
    the input of a projection sharded over them, which every rank holds whole."""
    mesh = mesh if mesh is not None else active_mesh()
    live = _live_axes(mesh, axes)
    return _CopyTo.apply(x, mesh, tuple(live)) if live else x


def reduce_from(x: torch.Tensor, axes: Sequence[str], mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The sum of the partial results `x` over the ranks of `axes`; the
    gradient passes through unchanged to every rank's part."""
    mesh = mesh if mesh is not None else active_mesh()
    live = _live_axes(mesh, axes)
    return _ReduceFrom.apply(x, mesh, tuple(live)) if live else x


def gather_from(x: torch.Tensor, axis: str, dim: int, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The ranks' shards `x` of a dimension sharded over `axis`, concatenated
    along `dim`; the gradient of each shard is its slice."""
    mesh = mesh if mesh is not None else active_mesh()
    if not _live_axes(mesh, [axis]):
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)
