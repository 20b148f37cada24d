"""The pipeline-parallel decoder forward: the port of
vision_compression_project_tpu/train/pp_forward.py.

Wires the GPipe schedule (parallel/pipeline.py) into the Decoder: its
blocks, all of one structure, are grouped into S stages of depth / S
consecutive blocks, stage s on the rank at coordinate s of the mesh
dimension `axis_name`, and the microbatches stream through them. Each stage
applies its blocks in turn with no rematerialisation, as the reference
applies `DecoderBlock` directly inside the pipeline (not the
`nn.remat(DecoderBlock)` of `Decoder.__call__`). No block of a stage takes a
tensor-, expert- or sequence-parallel route: the stage runs under
`StageView(mesh)`, in which only `data` holds more than one rank (the
reference runs it under `plain_partitioning()`), so a Switch-MoE block
routes over its microbatch's rows on every `data` rank, as
`SwitchMoE.routing` does under `data`.

In the local view a rank holds the blocks of its own stage; the Decoder
passed in may hold the others too (they are not touched). Training and
evaluation use the pipeline; generation keeps the unpipelined decoder.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional

import torch

from ..models.configs import DecoderConfig
from ..models.decoder import Decoder
from ..parallel.mesh import axis_size
from ..parallel.pipeline import StageView, gpipe, gpipe_virtual
from ..parallel.sharding import use_mesh


def stage_blocks(depth: int, n_stages: int, stage: int) -> range:
    """The decoder blocks of one stage: [s * depth / S, (s + 1) * depth / S).
    A depth that does not divide into the stages raises, as the reference's
    assert does."""
    if depth % n_stages:
        raise AssertionError((depth, n_stages))
    per = depth // n_stages
    return range(stage * per, (stage + 1) * per)


def stack_block_params(decoder_params: Mapping[str, torch.Tensor], depth: int, n_stages: int,
                       prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """The blocks' parameters of a decoder state_dict (`blocks.<i>.<name>`
    under `prefix`) stacked into (n_stages, depth / n_stages, ...) leaves
    keyed by <name>: stage s's blocks along its row, in order. Requires a
    uniform decoder: every block has the same parameters."""
    per = len(stage_blocks(depth, n_stages, 0))
    names = [k[len(f"{prefix}0."):] for k in decoder_params if k.startswith(f"{prefix}0.")]
    return {name: torch.stack([decoder_params[f"{prefix}{i}.{name}"] for i in range(depth)]).reshape(
        (n_stages, per) + decoder_params[f"{prefix}0.{name}"].shape) for name in names}


def stage_coords(mesh, axis_name: str, virtual_stages: int = 1) -> tuple:
    """(number of stages, this rank's stage): the mesh dimension's size and
    coordinate, or (virtual_stages, 0) without a mesh dimension of more than
    one rank. Virtual stages on a mesh that already pipelines raise."""
    n = 1 if mesh is None else axis_size(mesh, axis_name)
    if n > 1 and virtual_stages > 1:
        raise ValueError(f"{virtual_stages} virtual stages on a mesh whose {axis_name} holds {n} ranks")
    return (n, mesh.get_local_rank(axis_name)) if n > 1 else (virtual_stages, 0)


def stage_mesh(mesh):
    """The context a stage runs in: the mesh's StageView, or nothing without one."""
    return contextlib.nullcontext() if mesh is None else use_mesh(StageView(mesh))


def _stage_fn(mesh, with_aux: bool):
    """stage_fn(blocks, x): the blocks applied in turn under the stage's view
    of the mesh; with_aux, also the sum of their Switch terms in f32."""

    def run(blocks: List[torch.nn.Module], h: torch.Tensor):
        aux: Optional[torch.Tensor] = None
        with stage_mesh(mesh):
            for block in blocks:
                h, a = block(h)
                if a is not None:
                    a = a.to(torch.float32)
                    aux = a if aux is None else aux + a
        if not with_aux:
            return h
        return h, aux if aux is not None else h.new_zeros((), dtype=torch.float32)

    return run


def pipelined_decoder_hidden(
    cfg: DecoderConfig,
    decoder: Decoder,
    x_microbatches: torch.Tensor,
    mesh,
    axis_name: str = "model",
    with_aux: bool = False,
    virtual_stages: int = 1,
):
    """(M, mb, S, dim) embedded microbatches -> (M, mb, S, dim) hidden states
    after all decoder blocks, computed as an S-stage GPipe over `axis_name`
    (S its size), or over `virtual_stages` stages in this process without a
    mesh dimension to pipeline over. The caller applies the final norm and
    the unembed. `x_microbatches` need only be real on stage 0.

    with_aux=True additionally returns the Switch load-balancing term: the
    sum over blocks, averaged over the microbatches (gpipe's aux)."""
    n_stages, stage = stage_coords(mesh, axis_name, virtual_stages)
    blocks = [[decoder.blocks[i] for i in stage_blocks(cfg.depth, n_stages, s)] for s in range(n_stages)]
    fn = _stage_fn(mesh, with_aux)
    if mesh is not None and n_stages > 1:
        return gpipe(mesh, fn, blocks[stage], x_microbatches, axis_name=axis_name, with_aux=with_aux)
    return gpipe_virtual(fn, blocks, x_microbatches, with_aux=with_aux)
