"""GPipe pipeline parallelism over a mesh dimension: the port of
vision_compression_project_tpu/parallel/pipeline.py.

Stage s of the network lives on the rank at coordinate s of `axis_name`
(the local view: a rank holds its own stage's parameters;
`shard_stacked_params` cuts stage-stacked ones), and M microbatches stream
through the S stages in the classic (M + S - 1)-step schedule (`schedule`):
at step t stage s holds microbatch t - s, valid iff 0 <= t - s < M. The
reference's SPMD loop runs every stage at every step and masks out what the
fill and drain steps compute on garbage; here those steps are skipped. What
the reference masks never reaches an output or the aux, so the numbers are
the same.

The exchange order, the same on every rank:
- Forward. A stage takes its microbatches m = 0..M-1 in turn. Stage 0 reads
  m from `microbatches`; every other stage receives m's activation from
  stage s - 1 (`dist.recv` in the dimension's process group, where the
  reference `ppermute`s). It runs `stage_fn`, and a stage before the last
  sends the result to s + 1. The last stage's outputs are then broadcast
  over the group, so every rank returns all M, as the reference's psum
  replicates them. With `with_aux`, each stage sums its aux over its
  microbatches, the sums are summed over the group (the reference's psum) and
  divided by M.
- Backward, driven explicitly and never left to the autograd engine's
  order. A stage takes m = M-1..0 in turn. The last stage takes the
  gradient of m's output from the gradient of the returned outputs; every
  other stage receives it from s + 1. The stage backpropagates its own
  graph of m (`torch.autograd.backward` on the stage's output, and on its
  aux with the weight g_aux / M), which accumulates into its parameters'
  `.grad`. A stage after the first sends the gradient of m's input to
  s - 1. Stage 0 returns the gradient of `microbatches`; the other ranks
  return none, since only stage 0 reads them.
Sends meet their receives because every rank takes the microbatches in
the same order.

`gpipe_virtual` runs S stages in one process through the same schedule
and stage function, the activations and their gradients handed over in
memory (as ops/ring_attention.py's `ring_attention_virtual` runs a ring's
ranks): splitting a stack into stages changes no computation.

With a dimension of one rank, or without a mesh, the pipeline is the
reference's degenerate path: the microbatches run through the one stage in
turn, the aux averaged over them, and no collective is called.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import AXIS_EXPERT, AXIS_MODEL, AXIS_SEQ, axis_size

StageFn = Callable[[Any, torch.Tensor], Any]


def schedule(n_micro: int, n_stages: int) -> List[Tuple[int, int, int]]:
    """(step, stage, microbatch) of every valid slot of the GPipe schedule,
    step-major: at step t of M + S - 1, stage s holds microbatch t - s."""
    return [(t, s, t - s) for t in range(n_micro + n_stages - 1) for s in range(n_stages) if 0 <= t - s < n_micro]


def bubble(n_micro: int, n_stages: int) -> float:
    """The share of the schedule's stage-steps that are fill or drain:
    (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors that require grad in a stage's parameters: a tensor, a
    module, or a list, tuple or dict of them."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.requires_grad else []
    if isinstance(tree, torch.nn.Module):
        return [p for p in tree.parameters() if p.requires_grad]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


class _Ring:
    """Point-to-point exchange between the stages of one process group."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.group = mesh.get_group(axis)

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, stage: int) -> None:
        dist.send(t.contiguous(), self._peer(stage), group=self.group)

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(buf, self._peer(stage), group=self.group)
        return buf

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        t = t.contiguous()
        dist.broadcast(t, self._peer(stage), group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass
class _Slot:
    """One stage's graph of one microbatch."""

    x: torch.Tensor
    y: torch.Tensor
    aux: Optional[torch.Tensor]


class _Pipeline:
    """The stages this process holds (one, or all S for the virtual form), run
    through the schedule; the stages it does not hold are reached over `ring`."""

    def __init__(self, stage_fn: StageFn, params: Dict[int, Any], n_stages: int, with_aux: bool,
                 ring: Optional[_Ring]):
        self.stage_fn, self.params, self.n_stages = stage_fn, params, n_stages
        self.with_aux, self.ring = with_aux, ring
        self.slots: Dict[Tuple[int, int], _Slot] = {}

    def _run(self, s: int, x: torch.Tensor, keep: bool, needs_dx: bool) -> _Slot:
        x = x.detach()
        if keep:
            x.requires_grad_(needs_dx)
        with torch.set_grad_enabled(keep):
            if x.numel() == 0:  # a rank with no rows of the microbatch: nothing to run
                y, aux = x.clone(), (x.new_zeros((), dtype=torch.float32) if self.with_aux else None)
            elif self.with_aux:
                y, aux = self.stage_fn(self.params[s], x)
            else:
                y, aux = self.stage_fn(self.params[s], x), None
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"gpipe: stage {s} maps {tuple(x.shape)} {x.dtype} to {tuple(y.shape)} {y.dtype}; "
                             "a stage must keep its input's shape and dtype")
        return _Slot(x, y, aux)

    def forward(self, microbatches: torch.Tensor, keep: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        m_total, last = microbatches.shape[0], self.n_stages - 1
        handoff: Dict[Tuple[int, int], torch.Tensor] = {}
        outs: Dict[int, torch.Tensor] = {}
        aux_acc = microbatches.new_zeros((), dtype=torch.float32)
        for _, s, m in schedule(m_total, self.n_stages):
            if s not in self.params:
                continue
            if s == 0:
                x = microbatches[m]
            elif s - 1 in self.params:
                x = handoff.pop((s, m))
            else:
                x = self.ring.recv(microbatches[0], s - 1)
            slot = self._run(s, x, keep, needs_dx=s > 0 or microbatches.requires_grad)
            if keep:
                self.slots[(s, m)] = slot
            if slot.aux is not None:
                aux_acc = aux_acc + slot.aux.detach().to(torch.float32)
            y = slot.y.detach()
            if s == last:
                outs[m] = y
            elif s + 1 in self.params:
                handoff[(s + 1, m)] = y
            else:
                self.ring.send(y, s + 1)
        out = torch.stack([outs[m] for m in range(m_total)]) if last in self.params else torch.empty_like(
            microbatches, memory_format=torch.contiguous_format)
        if self.ring is not None:
            out = self.ring.broadcast(out, last)
            aux_acc = self.ring.sum(aux_acc)
        return out, aux_acc / m_total

    def backward(self, microbatches: torch.Tensor, g_out: torch.Tensor, g_aux: torch.Tensor) -> Optional[torch.Tensor]:
        m_total, last = microbatches.shape[0], self.n_stages - 1
        passed: Dict[Tuple[int, int], torch.Tensor] = {}
        dxs: Dict[int, torch.Tensor] = {}
        g_aux_mb = g_aux / m_total
        for _, s, m in reversed(schedule(m_total, self.n_stages)):
            if s not in self.params:
                continue
            if s == last:
                dy = g_out[m]
            elif s + 1 in self.params:
                dy = passed.pop((s, m))
            else:
                dy = self.ring.recv(microbatches[0], s + 1)
            slot = self.slots.pop((s, m))
            outputs, grads = [slot.y], [dy.to(slot.y.dtype)]
            if slot.aux is not None:
                outputs.append(slot.aux)
                grads.append(g_aux_mb.to(slot.aux.dtype))
            live = [(o, g) for o, g in zip(outputs, grads) if o.requires_grad]
            if live:
                torch.autograd.backward([o for o, _ in live], [g for _, g in live])
            dx = slot.x.grad if slot.x.grad is not None else torch.zeros_like(slot.x)
            if s == 0:
                dxs[m] = dx
            elif s - 1 in self.params:
                passed[(s - 1, m)] = dx
            else:
                self.ring.send(dx, s - 1)
        if 0 not in self.params or not microbatches.requires_grad:
            return None
        return torch.stack([dxs[m] for m in range(m_total)])


class _GPipeFn(torch.autograd.Function):
    """The pipeline as one node of the caller's graph: its backward runs the
    reverse schedule (the module docstring). The stages' parameters are
    inputs only so that the outputs require grad; their gradients reach
    `.grad` through the stages' own graphs."""

    @staticmethod
    def forward(ctx, pipe: _Pipeline, microbatches: torch.Tensor, *param_leaves: torch.Tensor):
        ctx.pipe, ctx.n_leaves = pipe, len(param_leaves)
        ctx.save_for_backward(microbatches)
        return pipe.forward(microbatches, keep=True)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor, g_aux: torch.Tensor):
        (microbatches,) = ctx.saved_tensors
        dx = ctx.pipe.backward(microbatches, g_out, g_aux)
        return (None, dx) + (None,) * ctx.n_leaves


def _apply(pipe: _Pipeline, stage_params: Sequence[Any], microbatches: torch.Tensor, with_aux: bool):
    leaves = [t for p in stage_params for t in _tensors(p)]
    if torch.is_grad_enabled() and (microbatches.requires_grad or leaves):
        out, aux = _GPipeFn.apply(pipe, microbatches, *leaves)
    else:
        out, aux = pipe.forward(microbatches, keep=False)
    return (out, aux) if with_aux else out


def gpipe(
    mesh: Optional[DeviceMesh],
    stage_fn: StageFn,
    stage_params: Any,
    microbatches: torch.Tensor,
    axis_name: str = "model",
    with_aux: bool = False,
):
    """Run `microbatches` (M, ...) through the S stages of the mesh dimension
    `axis_name`, this rank being stage s = its coordinate there and
    `stage_params` stage s's parameters. stage_fn(stage_params, x) -> y with
    y.shape == x.shape and y.dtype == x.dtype. Returns the (M, ...) outputs,
    the same on every rank; `microbatches` need only be real on stage 0 (the
    others read its shape and dtype).

    with_aux=True: stage_fn returns (y, aux scalar) and the call returns
    (outputs, aux), aux = the sum over stages of each stage's aux summed over
    its microbatches, divided by M: the same on every rank."""
    n_stages = 1 if mesh is None else axis_size(mesh, axis_name)
    stage = 0 if mesh is None else mesh.get_local_rank(axis_name)
    ring = _Ring(mesh, axis_name) if n_stages > 1 else None
    pipe = _Pipeline(stage_fn, {stage: stage_params}, n_stages, with_aux, ring)
    return _apply(pipe, [stage_params], microbatches, with_aux)


def gpipe_virtual(stage_fn: StageFn, stages_params: Sequence[Any], microbatches: torch.Tensor,
                  with_aux: bool = False):
    """gpipe's S = len(stages_params) stages in this one process, through the
    same schedule, activations and gradients handed over in memory. Returns
    what gpipe returns."""
    pipe = _Pipeline(stage_fn, dict(enumerate(stages_params)), len(stages_params), with_aux, None)
    return _apply(pipe, list(stages_params), microbatches, with_aux)


def shard_stacked_params(mesh: Optional[DeviceMesh], stacked: Any, axis_name: str = "model"):
    """This rank's (1, ...) slice of every leaf of stage-stacked parameters
    (a tensor or a dict, list or tuple of them, each with a leading stage
    axis of size S): the local view of the reference's `device_put` with
    the leading axis over `axis_name`."""
    if isinstance(stacked, dict):
        return {k: shard_stacked_params(mesh, v, axis_name) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(shard_stacked_params(mesh, v, axis_name) for v in stacked)
    if mesh is None or axis_size(mesh, axis_name) == 1:
        return stacked
    if stacked.shape[0] != axis_size(mesh, axis_name):
        raise ValueError(f"{stacked.shape[0]} stages stacked for mesh axis {axis_name} of "
                         f"{axis_size(mesh, axis_name)}")
    stage = mesh.get_local_rank(axis_name)
    return stacked[stage : stage + 1]


def gather_stacked_params(mesh: Optional[DeviceMesh], local: Any, axis_name: str = "model"):
    """The inverse of `shard_stacked_params`: every rank's (1, ...) slices
    gathered over `axis_name` into the (S, ...) stage-stacked leaves, on
    every rank."""
    if isinstance(local, dict):
        return {k: gather_stacked_params(mesh, v, axis_name) for k, v in local.items()}
    if isinstance(local, (list, tuple)):
        return type(local)(gather_stacked_params(mesh, v, axis_name) for v in local)
    if mesh is None or axis_size(mesh, axis_name) == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(axis_size(mesh, axis_name))]
    dist.all_gather(parts, local.detach().contiguous(), group=mesh.get_group(axis_name))
    return torch.cat(parts, 0)



# The mesh dimensions that count as one rank inside a pipeline stage.
_STAGE_HIDDEN = frozenset((AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL))


class StageView:
    """A mesh as a pipeline stage sees it: the dimensions in `_STAGE_HIDDEN`
    count as one rank each (size 1, coordinate 0), the others are the mesh's. The
    reference runs its stages under `plain_partitioning()`, so no module of
    a stage takes a tensor-, expert- or sequence-parallel route; the port's
    modules read the active mesh (models/layers.py), so a stage runs under
    this view of it (`use_mesh(StageView(mesh))`), which keeps `data`."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.mesh_dim_names = mesh.mesh_dim_names
        self.device_type = mesh.device_type

    def size(self, mesh_dim: Optional[int] = None) -> int:
        if mesh_dim is None:
            return int(torch.tensor(self.shape).prod())
        return 1 if self.mesh_dim_names[mesh_dim] in _STAGE_HIDDEN else self.mesh.size(mesh_dim)

    @property
    def shape(self) -> tuple:
        return tuple(self.size(i) for i in range(len(self.mesh_dim_names)))

    def get_local_rank(self, name: str) -> int:
        return 0 if name in _STAGE_HIDDEN else self.mesh.get_local_rank(name)

    def get_group(self, name: str):
        if name in _STAGE_HIDDEN:
            raise ValueError(f"mesh dimension {name!r} counts as one rank inside a pipeline stage")
        return self.mesh.get_group(name)
