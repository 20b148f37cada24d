"""The multi-device layer over torch.distributed: the mesh, the active mesh
and the logical-axis rules, the retrieval collectives, a rank launcher,
parameter sharding and the collectives of sharded training
(tensor_parallel.py), and GPipe pipeline parallelism (pipeline.py). The
port of vision_compression_project_tpu/parallel/; multihost_demo.py drives
the sharded train step over processes."""

from .collectives import distributed_topk, ring_all_gather_rows, sharded_cosine_topk
from .launch import spawn
from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQ,
    MESH_AXES,
    MeshConfig,
    build_mesh,
    initialize_multihost,
    local_mesh,
)
from .pipeline import gpipe, shard_stacked_params
from .sharding import LOGICAL_RULES, active_mesh, gather_params, shard_batch, shard_params, use_mesh

__all__ = [
    "AXIS_DATA",
    "AXIS_SEQ",
    "AXIS_MODEL",
    "AXIS_EXPERT",
    "MESH_AXES",
    "MeshConfig",
    "build_mesh",
    "local_mesh",
    "initialize_multihost",
    "spawn",
    "LOGICAL_RULES",
    "use_mesh",
    "active_mesh",
    "shard_params",
    "gather_params",
    "shard_batch",
    "distributed_topk",
    "sharded_cosine_topk",
    "ring_all_gather_rows",
    "gpipe",
    "shard_stacked_params",
]
