"""The device mesh over torch.distributed: the port of
vision_compression_project_tpu/parallel/mesh.py.

One process per device. The four named mesh dimensions are the reference's:
`data` carries page batches and index-row shards, `seq` shards long
sequences (ring attention), `expert` MoE experts and `model` tensor-parallel
matmuls. `build_mesh` lays a `DeviceMesh` over the initialised world, row
major in that order, so rank r sits at the coordinates of r in
(data, seq, expert, model). Collectives run over each dimension's process
group: NCCL on the card, gloo on the CPU.

Unlike the reference, whose arrays are global and sharded by XLA, every
rank holds its own shard (the local view): code under a mesh reads its
rank's coordinate along a dimension (`mesh.get_local_rank(name)`) and talks
to the other ranks of that dimension through its group
(`mesh.get_group(name)`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"
MESH_AXES = (AXIS_DATA, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh axis sizes. 0 for `data` means "absorb all remaining devices"."""

    data: int = 0
    seq: int = 1
    expert: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.seq * self.expert * self.model
        if fixed <= 0 or n_devices % fixed != 0:
            raise ValueError(
                f"mesh axes seq*expert*model={fixed} do not divide {n_devices} devices"
            )
        data = self.data if self.data > 0 else n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.seq}x{self.expert}x{self.model} != {n_devices} devices"
            )
        return MeshConfig(data=data, seq=self.seq, expert=self.expert, model=self.model)

    @property
    def shape(self) -> tuple:
        return (self.data, self.seq, self.expert, self.model)


def backend_for(device_type: str) -> str:
    """The process group's backend for a device type: nccl on the card, gloo on the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {device_type!r}")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Initialise the default process group with the device's backend. A no-op
    in a process whose group is already initialised.

    `coordinator_address` is an init method (`tcp://host:port`,
    `file:///path`); without one, `env://` reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK as torchrun sets them. `num_processes` and
    `process_id` default to WORLD_SIZE and RANK, else 1 and 0: a single
    process without a coordinator gets a world of its own. On the card each
    process takes the device LOCAL_RANK (default: its rank modulo the
    devices of the host)."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    backend = backend_for(device_type)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: device 'cuda' asked for, but no CUDA device is available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if coordinator_address is None and world == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return
    dist.init_process_group(
        backend, init_method=coordinator_address or "env://", world_size=world, rank=rank
    )


def build_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda") -> DeviceMesh:
    """The 4-axis framework mesh over every rank of the initialised world.
    Raises when no process group is initialised (`initialize_multihost`)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: no process group; call initialize_multihost first")
    config = (config or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, config.shape, mesh_dim_names=MESH_AXES)


def local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Default mesh from environment (VCP_MESH_*), all spare devices -> data."""
    cfg = MeshConfig(
        data=int(os.environ.get("VCP_MESH_DATA", 0) or 0),
        seq=int(os.environ.get("VCP_MESH_SEQ", 1) or 1),
        expert=int(os.environ.get("VCP_MESH_EXPERT", 1) or 1),
        model=int(os.environ.get("VCP_MESH_MODEL", 1) or 1),
    )
    return build_mesh(cfg, device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along a named mesh dimension."""
    return mesh.size(mesh.mesh_dim_names.index(axis))
