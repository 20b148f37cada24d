"""Logical-axis rules and the active mesh: the port of
vision_compression_project_tpu/parallel/sharding.py.

The reference annotates arrays with logical axis names and lets XLA shard
them over the mesh; `LOGICAL_RULES` maps each name onto a mesh dimension.
Here every rank holds its own shard, so the rules say which slice of a
global tensor a rank holds (`local_shard`) and over which dimensions the
slices are gathered back (`gather_shards`). `use_mesh` stands in for the
reference's `with mesh:`: model code under it reads the mesh through
`active_mesh()` and takes its mesh-dependent paths (tensor and expert
parallelism, the sequence-parallel ring: models/layers.py).

Parameters: `param_logical_axes` is the reference's annotation of every
parameter (`dense_init(...)`, `with_partitioning(...)` in its models) in the
port's layout, so `shard_params` gives each rank the block the reference's
`shard_params` lays on its device and `gather_params` puts them back
together. A dimension that does not divide its mesh dimension raises
ValueError, as the reference's `device_put` does.

The reference's `constrain`, `data_sharding` and `replicated` have no
counterpart: they name a sharding for XLA to lay out, and in the local view
a tensor's shape already is its sharding. A batch is cut into its `data`
rows once (`shard_batch`) and every activation after it is the rank's own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

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


# The reference's logical axes of each parameter, by the state_dict name's
# ending, in the port's layout (weights.py): a Linear weight is (out, in),
# so the flax kernel's (embed, heads, head_dim) of wq is (heads*head_dim,
# embed) here, cut in whole heads, and wo's (heads, head_dim, embed) is
# (embed, heads*head_dim); a Conv2d weight is OIHW. Every other parameter
# (biases, pos_embed) is replicated, as the reference leaves it unannotated.
PARAM_AXES = (
    (".wq.weight", ("heads", "embed")),
    (".wk.weight", ("kv_heads", "embed")),
    (".wv.weight", ("kv_heads", "embed")),
    (".wo.weight", ("embed", "heads")),
    (".gate.weight", ("mlp", "embed")),
    (".up.weight", ("mlp", "embed")),
    (".down.weight", ("embed", "mlp")),
    (".router.weight", ("expert", "embed")),
    (".w_gate", ("expert", "embed", "mlp")),
    (".w_up", ("expert", "embed", "mlp")),
    (".w_down", ("expert", "mlp", "embed")),
    (".embed.weight", ("vocab", "embed")),
    (".unembed.weight", ("vocab", "embed")),
    (".patch_embed.weight", ("embed", "patch")),
    (".proj.weight", ("embed", "vit_embed")),
    (".downsample.weight", ("embed", None, None, None)),
    (".scale", ("embed",)),
)


def param_logical_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of the parameter `name` (a state_dict key of
    OpticalVLM) of rank `ndim`."""
    for suffix, axes in PARAM_AXES:
        if ("." + name).endswith(suffix):
            if len(axes) != ndim:
                raise ValueError(f"{name}: {ndim} dims, its axes are {axes}")
            return axes
    return (None,) * ndim


def param_mesh_axes(name: str, ndim: int, mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh dimensions of more than one rank that shard parameter `name`."""
    return tuple(axis for _, axis in _mesh_axes(mesh, param_logical_axes(name, ndim)))


def _check_whole_heads(name: str, t: torch.Tensor, mesh: DeviceMesh, cfg) -> None:
    """An attention projection's (heads * head_dim) dimension is cut in
    whole heads: its head count, which the reference's kernel shows as a
    dimension of its own, must divide `model`."""
    from ..weights import _head_dims

    parts = name.split(".")
    if len(parts) < 2 or parts[-2] not in ("wq", "wk", "wv", "wo"):
        return
    n = axis_size(mesh, AXIS_MODEL)
    for prefix, head_dim in _head_dims(cfg):
        if name.startswith(prefix):
            heads = t.shape[1 if parts[-2] == "wo" else 0] // head_dim
            if heads % n:
                raise ValueError(f"{name}: {heads} heads, which does not divide mesh axis model of {n}")


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: DeviceMesh, cfg=None) -> Dict[str, torch.Tensor]:
    """This rank's block of every parameter of a whole state_dict, by
    `param_logical_axes`: the reference's `shard_params` in the local view.
    With the model's `cfg`, attention projections are also checked to be
    cut in whole heads (the reference's kernels carry the head count as a
    dimension of its own, which must divide `model`)."""
    out = {}
    for name, t in state_dict.items():
        if cfg is not None:
            _check_whole_heads(name, t, mesh, cfg)
        out[name] = local_shard(t, mesh, param_logical_axes(name, t.dim()))
    return out


@torch.no_grad()
def keep_shards(model: torch.nn.Module, mesh: DeviceMesh) -> None:
    """Replace each whole parameter of `model` (which has a `cfg`, as
    OpticalVLM does) by this rank's shard, one at a time, freeing the whole
    tensor."""
    for name, p in model.named_parameters():
        shard = shard_params({name: p.data}, mesh, model.cfg)[name]
        if shard.shape != p.shape:
            p.data = shard.clone()


def gather_params(shards: Mapping[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """The whole state_dict from every rank's `shard_params` blocks (on every
    rank): the inverse of `shard_params`."""
    return {name: gather_shards(t.detach(), mesh, param_logical_axes(name, t.dim())) for name, t in shards.items()}


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's `data` rows of a whole batch (every tensor batch-major):
    the local view of the reference's batch sharding `P("data", ...)`. A
    batch that does not divide `data` raises ValueError."""
    return {k: local_shard(v, mesh, ("batch",) + (None,) * (v.dim() - 1)) for k, v in batch.items()}
