"""The VLM's training step: the port of
vision_compression_project_tpu/train/train_step.py, without optax or a mesh.

`AdamW` is optax's `chain(clip_by_global_norm(max_norm), adamw(...))` written
out by hand, to optax's formulas: the clip scales by `max_norm / g_norm` only
when `g_norm >= max_norm`, with no epsilon (torch's `clip_grad_norm_` divides
by `norm + 1e-6`); weight decay applies to every parameter, as optax's mask
`None` does; the learning rate of update t (counted from 0) is `lr(t)`, the
schedule evaluated at the count before it is incremented, as optax does.
Parameters are f32; the model computes in its config's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from .. import config
from ..models.configs import VLMConfig
from ..models.tokenizer import PAD_ID
from ..models.vlm import OpticalVLM, init_params

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
    or a schedule (step count -> float)."""

    def __init__(self, lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params: Params) -> OptState:
        return OptState(mu={k: torch.zeros_like(p) for k, p in params.items()},
                        nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Params, state: OptState) -> OptState:
        """One update of every parameter from its gradient; returns the
        moments and count after it. The whole update stays on the device:
        no value is read back to the host."""
        names = list(params)
        p = [params[k] for k in names]
        g = [params[k].grad for k in names]
        if any(t is None for t in g):
            missing = [k for k, t in zip(names, g) if t is None]
            raise RuntimeError(f"no gradient for {len(missing)} parameters, e.g. {missing[:3]}")
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in g]))
            clip = norm >= self.max_norm
            one = torch.ones((), device=norm.device)
            g = torch._foreach_div(g, torch.where(clip, norm, one))
            torch._foreach_mul_(g, torch.where(clip, one * self.max_norm, one))
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - self.b1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - self.b2 ** count))
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(step, p, alpha=self.weight_decay)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        torch._foreach_add_(p, step, alpha=-float(lr))
        return OptState(mu=state.mu, nu=state.nu, count=count)


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


def vlm_loss(model: OpticalVLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy in f32 over the text segment (the vision
    prefix has no targets), averaged over the targets that are not PAD and,
    where the batch has a loss_mask, that it supervises; plus MOE_AUX_WEIGHT
    times the sum of the Switch-MoE blocks' load-balancing terms, which the
    forward returns (one per MoE block, none without experts)."""
    ids = batch["token_ids"]
    aux_losses: List[torch.Tensor] = []
    logits = model(batch["patch_tokens"], ids[:, :-1], aux_losses=aux_losses)
    vis_len = logits.shape[1] - (ids.shape[1] - 1)
    text_logits = logits[:, vis_len:].float()
    targets = ids[:, 1:].long()
    mask = (targets != PAD_ID).float()
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"][:, 1:].float()
    ce = F.cross_entropy(text_logits.reshape(-1, text_logits.shape[-1]), targets.reshape(-1),
                         reduction="none").view_as(mask)
    loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
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


def make_train_state(cfg: VLMConfig, device=None, seed: int = 0, lr: Union[float, Schedule] = 3e-4):
    """(model, optimizer, TrainState): OpticalVLM(cfg) with seeded f32
    weights (one torch.Generator, models/vlm.py::init_params) on `device`."""
    model = OpticalVLM(cfg)
    init_params(model, seed)
    model.to(resolve_device(device)).train()
    opt = make_optimizer(lr)
    params = dict(model.named_parameters())
    return model, opt, TrainState(params=params, opt_state=opt.init(params), step=0, cfg=cfg)


def train_step(model: OpticalVLM, opt: AdamW, state: TrainState, batch: Dict[str, torch.Tensor]):
    """One optimizer step on `batch` (device_batch's dict): (state, loss).
    The parameters are updated in place; their `.grad` holds this step's
    gradients afterwards, before the clip."""
    for p in state.params.values():
        p.grad = None
    loss = vlm_loss(model, batch)
    loss.backward()
    state.opt_state = opt.update(state.params, state.opt_state)
    state.step += 1
    return state, loss.detach()
