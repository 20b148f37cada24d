"""Logical-axis rules and the active mesh: the port of
vision_compression_project_tpu/parallel/sharding.py.

The reference annotates arrays with logical axis names and lets XLA shard
them over the mesh; `LOGICAL_RULES` maps each name onto a mesh dimension.
Here every rank holds its own shard, so the rules say which slice of a
global tensor a rank holds (`local_shard`) and over which dimensions the
slices are gathered back (`gather_shards`). `use_mesh` stands in for the
reference's `with mesh:`: model code under it reads the mesh through
`active_mesh()` and takes its mesh-dependent paths (the sequence-parallel
ring in models/layers.py). Sharding parameters by these rules (tensor and
expert parallelism) is not ported yet, nor the reference's `constrain`: in
the local view each rank already holds only its shard of an activation, so
it has nothing to pin until that slice shards parameters.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_SEQ, axis_size

# logical axis -> mesh axis (None = replicated).
LOGICAL_RULES = (
    ("batch", AXIS_DATA),          # page/example batch
    ("seq", AXIS_SEQ),             # activation sequence (SP/CP)
    ("embed", None),               # residual stream: replicated
    ("vit_embed", None),           # vision-encoder output width
    ("embed_out", None),           # projection output width
    ("heads", AXIS_MODEL),         # attention heads (TP)
    ("kv_heads", AXIS_MODEL),
    ("head_dim", None),
    ("mlp", AXIS_MODEL),           # FFN hidden (TP)
    ("vocab", AXIS_MODEL),         # embedding/unembedding vocab shard (TP)
    ("expert", AXIS_EXPERT),       # MoE experts (EP)
    ("patch", None),
    ("index_rows", AXIS_DATA),     # vector-index rows shard over data axis
    ("index_dim", None),
)
_RULES = dict(LOGICAL_RULES)

_active = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make `mesh` the active mesh of this thread within the block (the
    reference's `with mesh:`); blocks nest, the innermost wins."""
    stack = _active.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def active_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost `use_mesh` block of this thread, or None
    (single-device serving, CPU tests)."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


def _mesh_axes(mesh: DeviceMesh, logical_axes: Sequence[Optional[str]]):
    """(tensor dim, mesh axis) for each dim whose logical name maps onto a
    mesh dimension of more than one rank."""
    out = []
    for dim, name in enumerate(logical_axes):
        axis = _RULES.get(name) if name is not None else None
        if axis is not None and axis_size(mesh, axis) > 1:
            out.append((dim, axis))
    return out


def local_shard(x: torch.Tensor, mesh: DeviceMesh, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of the global tensor `x` whose dims carry
    `logical_axes` (the local counterpart of `device_put` with the logical
    sharding): each dim mapped onto a mesh dimension of n ranks is cut into
    n equal chunks and the chunk at this rank's coordinate kept. Raises
    ValueError where a dim does not divide."""
    for dim, axis in _mesh_axes(mesh, logical_axes):
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} ({logical_axes[dim]}) of size {x.shape[dim]} does not divide "
                             f"mesh axis {axis} of {n}")
        x = x.chunk(n, dim)[mesh.get_local_rank(axis)]
    return x.contiguous()


def gather_shards(x: torch.Tensor, mesh: DeviceMesh, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """The global tensor from every rank's block `x` (the inverse of
    `local_shard`): an all-gather over each sharded dim's mesh group."""
    for dim, axis in _mesh_axes(mesh, logical_axes):
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
        x = torch.cat(parts, dim)
    return x
