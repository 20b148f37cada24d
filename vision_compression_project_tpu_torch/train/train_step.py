"""The VLM's training step: the port of
vision_compression_project_tpu/train/train_step.py, without optax.

`AdamW` is optax's `chain(clip_by_global_norm(max_norm), adamw(...))` written
out by hand, to optax's formulas: the clip scales by `max_norm / g_norm` only
when `g_norm >= max_norm`, with no epsilon (torch's `clip_grad_norm_` divides
by `norm + 1e-6`); weight decay applies to every parameter, as optax's mask
`None` does; the learning rate of update t (counted from 0) is `lr(t)`, the
schedule evaluated at the count before it is incremented, as optax does.
Parameters are f32 except the Switch-MoE experts, which are stored in the
config's dtype (bf16 unless it says f32), as the reference stores them; the
model computes in its config's dtype.

A leaf's update is computed in the leaf's own dtype, one rounding per
operation, with every constant (b1, 1 - b1, the bias corrections, eps, the
decay, the learning rate) first rounded to that dtype, and its moments are
kept in it: what optax does to a bf16 leaf (mu and nu bf16, `(1 - b1) * g +
b1 * mu` as two bf16 products and a bf16 sum). The global norm is optax's
up to the order of the sum over leaves: each leaf's sum of squares in f32,
rounded to the leaf's dtype, added in f32 one leaf at a time in the
parameters' order, which is the kernel's (optax adds in jax.tree.leaves'
order, dict keys sorted). Leaves on the card take kernels/adamw.cu (the
sums of squares, then one pass that updates every leaf, with no value read
back to the host); leaves on the CPU take the plain `_foreach` version. The
two give the same bits from the same sums of squares.

On a mesh (`make_train_state(..., mesh=)`, `train_step(..., mesh=)`), the
reference's sharded step in the local view: each rank builds the whole
seeded model and keeps its shard of every parameter
(`parallel.sharding.shard_params`), and takes its `data` rows of each batch
(`shard_batch`). Its loss is its own tokens' share of the reference's loss
over the global batch: its sum of masked cross-entropies over the mask count
of the whole batch (summed over `data` and `seq`), plus its share of the MoE
terms, so the shares of all ranks that hold other tokens sum to the
reference's loss, which `train_step` returns. Gradients are summed over
`data` and `seq`; over `model` and `expert` the operators of
parallel/tensor_parallel.py already leave each rank the gradient of its
shard, the same on every rank for a replicated parameter. The clip's global
norm sums each sharded leaf's squares over the ranks that hold its shards
and counts a replicated leaf once. A mesh of 1 changes no number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import config, kernels
from ..models.configs import VLMConfig
from ..models.layers import flush_route_loads
from ..models.tokenizer import PAD_ID
from ..models.vlm import OpticalVLM, init_params
from ..parallel.mesh import AXIS_DATA, AXIS_SEQ, axis_size, initialize_multihost, local_mesh
from ..parallel.sharding import active_mesh, gather_params, keep_shards, param_mesh_axes, shard_params, use_mesh
from ..parallel.tensor_parallel import sum_over
from ..utils.metrics import METRICS

Schedule = Callable[[int], float]
Params = Dict[str, torch.Tensor]
# Weight of the Switch-MoE load-balancing term in the loss (the reference's).
MOE_AUX_WEIGHT = 0.01


@dataclasses.dataclass
class OptState:
    mu: Params
    nu: Params
    count: int = 0


class AdamW:
    """AdamW over a dict of parameters, each updated in place from its
    `.grad`: optax's `adamw(lr, b1, b2, eps, weight_decay)`, preceded by
    `clip_by_global_norm(max_norm)` unless max_norm is None. `lr` is a float
    or a schedule (step count -> float). The moments take each parameter's
    dtype, as optax's do. Leaves all on the CPU take `_plain_update`; any
    other leaves take the kernels (`_kernel_update`), and
    `kernels.adamw_device` raises ValueError on what they do not take."""

    def __init__(self, lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params: Params) -> OptState:
        return OptState(mu={k: torch.zeros_like(p) for k, p in params.items()},
                        nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Params, state: OptState,
               reduce_sq: Optional[Callable[[List[str], torch.Tensor], torch.Tensor]] = None) -> OptState:
        """One update of every parameter from its gradient; returns the
        moments and count after it. The whole update stays on the device:
        no value is read back to the host. `reduce_sq(names, sq)` turns the
        leaves' f32 sums of squares into those of the whole leaves when each
        holds a shard (the sharded step's). Timed as `train.optimizer`,
        whose profiler range carries the count of updates before this one:
        the train state's step in `train_step`."""
        with METRICS.timer("train.optimizer", state.count):
            return self._update(params, state, reduce_sq)

    def _update(self, params: Params, state: OptState, reduce_sq) -> OptState:
        names = list(params)
        missing = [k for k in names if params[k].grad is None]
        if missing:
            raise RuntimeError(f"no gradient for {len(missing)} parameters, e.g. {missing[:3]}")
        count = state.count + 1
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        # optax's bias corrections: 1 - decay ** count in f32, then in the leaf's dtype.
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        p = [params[k] for k in names]
        g = [t.grad for t in p]
        mu, nu = [state.mu[k] for k in names], [state.nu[k] for k in names]
        if kernels.adamw_device(p, g, mu, nu) is None:
            self._plain_update(params, state, reduce_sq, lr, bc1, bc2)
        else:
            self._kernel_update(names, p, g, mu, nu, reduce_sq, lr, bc1, bc2)
        return OptState(mu=state.mu, nu=state.nu, count=count)

    def _constants(self, dtype: torch.dtype, lr: float, bc1: float, bc2: float) -> Dict[str, float]:
        """kernels.ADAMW_CONSTANTS, each rounded to `dtype` as `_round_to` does."""
        values = (self.b1, 1 - self.b1, self.b2, 1 - self.b2, bc1, bc2, self.eps, self.weight_decay, -float(lr),
                  0.0 if self.max_norm is None else self.max_norm)
        return {k: _round_to(x, dtype) for k, x in zip(kernels.ADAMW_CONSTANTS, values)}

    def _kernel_update(self, names: List[str], p: List[torch.Tensor], g: List[torch.Tensor],
                       mu: List[torch.Tensor], nu: List[torch.Tensor], reduce_sq, lr: float, bc1: float,
                       bc2: float) -> None:
        """The update on the card: kernels/adamw.cu, the same numbers as
        `_plain_update` from the same sums of squares, with no value read back
        to the host. The leaves have passed `kernels.adamw_device`."""
        sq = None
        if self.max_norm is not None:
            sq = kernels.adamw_sumsq(g)
            if reduce_sq is not None:
                sq = reduce_sq(names, sq)
        constants = {dtype: self._constants(dtype, lr, bc1, bc2) for dtype in kernels.ADAMW_DTYPES}
        max_norm = 0.0 if self.max_norm is None else self.max_norm
        kernels.adamw_update(p, g, mu, nu, constants, max_norm, bool(self.weight_decay), sq)

    def _plain_update(self, params: Params, state: OptState, reduce_sq, lr: float, bc1: float,
                      bc2: float) -> None:
        """The plain version, for leaves on the CPU: the clip's norms, then
        one `_foreach` pass per operation over each dtype's leaves."""
        names = list(params)
        norm = None
        if self.max_norm is not None:
            sq = torch.stack([torch.linalg.vector_norm(params[k].grad, dtype=torch.float32).square() for k in names])
            if reduce_sq is not None:
                sq = reduce_sq(names, sq)
            # Added one at a time in `names` order, the kernel's order. optax
            # adds in jax.tree.leaves' order (dict keys sorted), a running sum
            # that starts in the first leaf's dtype; neither order is that.
            norm = _sqrt_rn(functools.reduce(torch.add, [sq[i].to(params[k].grad.dtype).float()
                                                         for i, k in enumerate(names)]))
        for dtype in dict.fromkeys(params[k].dtype for k in names):
            group = [k for k in names if params[k].dtype == dtype]

            def c(x: float) -> float:
                return _round_to(x, dtype)

            p = [params[k] for k in group]
            g = [params[k].grad for k in group]
            if norm is not None:
                one = torch.ones((), dtype=dtype, device=norm.device)
                clip = norm >= self.max_norm
                g = torch._foreach_div(g, torch.where(clip, norm.to(dtype), one))
                torch._foreach_mul_(g, torch.where(clip, one * c(self.max_norm), one))
            mu = [state.mu[k] for k in group]
            nu = [state.nu[k] for k in group]
            tmp = torch._foreach_mul(g, c(1 - self.b1))
            torch._foreach_mul_(mu, c(self.b1))
            torch._foreach_add_(mu, tmp)
            tmp = torch._foreach_mul(g, g)
            del g
            torch._foreach_mul_(tmp, c(1 - self.b2))
            torch._foreach_mul_(nu, c(self.b2))
            torch._foreach_add_(nu, tmp)
            denom = [_sqrt_rn(d) for d in torch._foreach_div(nu, c(bc2))]
            torch._foreach_add_(denom, c(self.eps))
            step = torch._foreach_div(mu, c(bc1))
            torch._foreach_div_(step, denom)
            del denom
            if self.weight_decay:
                tmp = torch._foreach_mul(p, c(self.weight_decay))
                torch._foreach_add_(step, tmp)
            del tmp
            torch._foreach_mul_(step, c(-float(lr)))
            torch._foreach_add_(p, step)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root correctly rounded to f32, then to x's dtype, as IEEE's
    f32 square root and optax's give it: taken in f64, whose 53 bits are
    more than the 2 x 24 + 2 that make its rounding to f32 the correct one.
    (The CPU's vectorised f32 square root is within about an ulp, not
    correctly rounded.)"""
    return x.double().sqrt().float().to(x.dtype)


@functools.lru_cache(maxsize=1024)
def _round_to(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python float."""
    return torch.tensor(x, dtype=dtype).item()


def make_optimizer(lr: Union[float, Schedule] = 3e-4, weight_decay: float = 0.01) -> AdamW:
    """AdamW with grad clipping, the reference's `make_optimizer`:
    clip_by_global_norm(1.0), then adamw(b1=0.9, b2=0.95, eps=1e-8)."""
    return AdamW(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay, max_norm=1.0)


def cosine_lr(peak: float, total_steps: int, warmup: int = 100, end_frac: float = 0.1) -> Schedule:
    """Warmup from 0.1 x peak, then cosine decay to end_frac x peak:
    optax.warmup_cosine_decay_schedule as the reference calls it."""
    warmup = min(warmup, max(1, total_steps // 10))
    init, end = peak * 0.1, peak * end_frac
    decay = max(total_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return (init - peak) * (1 - count / warmup) + peak
        t = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def _own_positions(logits: torch.Tensor, total: int, mesh) -> tuple:
    """(first, end) of the positions of the [vision ; text] sequence whose
    loss this rank takes under a `seq` dimension of n > 1 ranks: its chunk,
    or, where the sequence ran whole on every `seq` rank (a length that does
    not divide n), its share of the positions as `tensor_split` cuts them."""
    n, q = axis_size(mesh, AXIS_SEQ), mesh.get_local_rank(AXIS_SEQ)
    if logits.shape[1] == total:
        sizes = [len(part) for part in torch.arange(total).tensor_split(n)]
        first = sum(sizes[:q])
        return first, first + sizes[q]
    return q * logits.shape[1], (q + 1) * logits.shape[1]


def vlm_loss(model: OpticalVLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy in f32 over the text segment (the vision
    prefix has no targets), averaged over the targets that are not PAD and,
    where the batch has a loss_mask, that it supervises; plus MOE_AUX_WEIGHT
    times the sum of the Switch-MoE blocks' load-balancing terms, which the
    forward returns (one per MoE block, none without experts).

    Under the active mesh, this rank's share of that loss (the module
    docstring): its positions' terms over the mask count of the whole
    batch, which sums the ranks' counts over `data` and `seq`."""
    ids = batch["token_ids"]
    aux_losses: List[torch.Tensor] = []
    logits = model(batch["patch_tokens"], ids[:, :-1], aux_losses=aux_losses)
    targets = ids[:, 1:].long()
    mask = (targets != PAD_ID).float()
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"][:, 1:].float()
    mesh = active_mesh()
    if mesh is not None and axis_size(mesh, AXIS_SEQ) > 1:
        vis_len = model.cfg.vision.tokens_out
        first, end = _own_positions(logits, vis_len + targets.shape[1], mesh)
        if logits.shape[1] != end - first:
            logits = logits[:, first:end]
        # Targets and mask of every position, none on the vision prefix.
        targets = F.pad(targets, (vis_len, 0))[:, first:end]
        mask = F.pad(mask, (vis_len, 0))[:, first:end]
        text_logits = logits.float()
    else:
        vis_len = logits.shape[1] - (ids.shape[1] - 1)
        text_logits = logits[:, vis_len:].float()
    ce = F.cross_entropy(text_logits.reshape(-1, text_logits.shape[-1]), targets.reshape(-1),
                         reduction="none").view_as(mask)
    count = sum_over(mask.sum(), (AXIS_DATA, AXIS_SEQ), mesh)
    loss = (ce * mask).sum() / count.clamp(min=1.0)
    if aux_losses:
        loss = loss + MOE_AUX_WEIGHT * sum(aux_losses)
    return loss


@dataclasses.dataclass
class TrainState:
    """The model's parameters by state_dict name (the tensors the model
    holds), the optimizer's moments, the step count, and the config the
    parameters belong to (checkpoints store them under the reference's
    names, which need it)."""

    params: Params
    opt_state: Optional[OptState]
    step: int
    cfg: object


def resolve_device(device=None) -> torch.device:
    """`device`, else RUNTIME.device (VCP_DEVICE, the card unless it says
    "cpu"); asking for the card where there is none raises."""
    dev = torch.device(device or config.RUNTIME.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is available")
    return dev


def make_train_state(cfg: VLMConfig, device=None, seed: int = 0, lr: Union[float, Schedule] = 3e-4, mesh=None):
    """(model, optimizer, TrainState): OpticalVLM(cfg) with seeded weights
    (one CPU torch.Generator, models/vlm.py::init_params), made on `device`
    and filled there a tensor at a time, as VLMRunner builds its model: the
    same seed gives the same weights on any device, and the host never holds
    the whole model. With a `mesh` (of the device's type) each rank builds
    the same whole model and keeps its shard of every parameter, so the
    mesh changes no number; the moments take the shards' shapes."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a model on {dev}")
    with torch.device(dev):
        model = OpticalVLM(cfg)
    init_params(model, seed)
    model.to(dev).train()  # the buffers made from host arrays (RoPE tables)
    if mesh is not None:
        keep_shards(model, mesh)
    opt = make_optimizer(lr)
    params = dict(model.named_parameters())
    return model, opt, TrainState(params=params, opt_state=opt.init(params), step=0, cfg=cfg)


def sum_gradients(params: Params, mesh, axes=(AXIS_DATA, AXIS_SEQ)) -> None:
    """Sum every gradient over the mesh's ranks along `axes` (`data` and
    `seq`) in place, one flat all-reduce per dtype."""
    if all(axis_size(mesh, a) == 1 for a in axes):
        return
    grads = [p.grad for p in params.values()]
    for dtype in dict.fromkeys(g.dtype for g in grads):
        group = [g for g in grads if g.dtype == dtype]
        flat = sum_over(torch.cat([g.reshape(-1) for g in group]), axes, mesh)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


def sharded_sq(params: Params, mesh):
    """AdamW's `reduce_sq` on a mesh: each sharded leaf's sum of squares
    summed over the `model`/`expert` ranks that hold its shards."""
    axes = {k: param_mesh_axes(k, p.dim(), mesh) for k, p in params.items()}

    def reduce_sq(names: List[str], sq: torch.Tensor) -> torch.Tensor:
        out = sq.clone()
        for group in dict.fromkeys(axes[k] for k in names):
            if group:
                idx = torch.tensor([i for i, k in enumerate(names) if axes[k] == group], device=sq.device)
                out[idx] = sum_over(sq[idx], group, mesh)
        return out

    return reduce_sq


def train_step(model: OpticalVLM, opt: AdamW, state: TrainState, batch: Dict[str, torch.Tensor], mesh=None):
    """One optimizer step on `batch` (device_batch's dict): (state, loss).
    The parameters are updated in place; their `.grad` holds this step's
    gradients afterwards, before the clip. With a `mesh`, the counterpart of
    the reference's `make_jitted_train_step`: `batch` is this rank's `data`
    rows (`parallel.sharding.shard_batch`), and the loss returned is the
    whole batch's, the same on every rank. Timed as `train.forward` (from
    the gradients' reset through the loss), `train.backward` (with the
    gradients' sum over the mesh) and `train.optimizer`, each range
    carrying the step (utils/metrics.py)."""
    with contextlib.nullcontext() if mesh is None else use_mesh(mesh):
        with METRICS.timer("train.forward", state.step):
            for p in state.params.values():
                p.grad = None
            loss = vlm_loss(model, batch)
        with METRICS.timer("train.backward", state.step):
            loss.backward()
            if mesh is not None:
                sum_gradients(state.params, mesh)
    reduce_sq = None if mesh is None else sharded_sq(state.params, mesh)
    state.opt_state = opt.update(state.params, state.opt_state, reduce_sq=reduce_sq)
    flush_route_loads()
    if mesh is not None:
        loss = sum_over(loss.detach(), (AXIS_DATA, AXIS_SEQ), mesh)
    state.step += 1
    return state, loss.detach()


def training_mesh(device: torch.device):
    """The mesh of a training command line: `local_mesh()` (VCP_MESH_*)
    over the ranks of a process group that a launcher set up
    (`parallel.spawn`, or torchrun's WORLD_SIZE and friends), or None for
    one process on its own, which trains without one."""
    if not torch.distributed.is_initialized() and "WORLD_SIZE" not in os.environ:
        return None
    initialize_multihost(device_type=device.type)
    return local_mesh(device.type)


def load_whole_params(model: OpticalVLM, state_dict: Params, mesh=None) -> None:
    """Copy a whole state_dict into the model, each rank its shards on a mesh."""
    if mesh is None:
        model.load_state_dict(state_dict)
        return
    with torch.no_grad():
        for name, shard in shard_params(state_dict, mesh).items():
            model.get_parameter(name).copy_(shard)


def gather_state(state: TrainState, mesh) -> TrainState:
    """The whole TrainState from every rank's shards (every rank takes part),
    which a checkpoint saves as one device's would be."""
    if mesh is None:
        return state
    opt = state.opt_state
    return TrainState(
        params=gather_params(state.params, mesh), step=state.step, cfg=state.cfg,
        opt_state=None if opt is None else OptState(mu=gather_params(opt.mu, mesh), nu=gather_params(opt.nu, mesh),
                                                    count=opt.count))
