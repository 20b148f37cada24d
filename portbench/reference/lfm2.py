"""LFM2-24B-A2B's language model as the page reader's decoder, in plain
PyTorch: the published `lfm2_moe` equations (Hugging Face transformers'
`Lfm2Moe*` modules) behind `model.Reference`'s preprocess, vision encoder
and projector, which it reuses. float32 with TF32 off (`exact_float32`);
every product takes its operands through `Precision`, so `low=True` is the
control a precision step down. It imports nothing of the port.

Every layer: h = x + op(operator_norm(x)); out = h + ffn(ffn_norm(h)), with
RMSNorm at `norm_eps`, and a final RMSNorm before the unembed.
- conv op: B, C, x' = chunk3(in_proj(x)); y = C * conv(B * x'), conv a
  causal depthwise filter of `conv_kernel` taps a channel (conv1d, padding
  kernel - 1, the first S outputs), no bias; out_proj(y).
- attention op: q, k, v projections; RMSNorm over head_dim on q and on k;
  RoPE (rotate-half) at `rope_theta`; causal GQA; out projection.
- ffn: SwiGLU of width `mlp_ratio * dim` in the first `num_dense_layers`
  layers; after them a mixture: s = sigmoid(router(x)) in f32, the top
  `experts_per_token` of s + expert_bias (ties to the lower index), weights
  the chosen s over (their sum + 1e-6), times 1 (routed_scaling_factor), the
  sum of the chosen SwiGLU experts of width `moe_dim`; no token dropped, no
  load-balancing term. Each expert runs densely over the tokens that chose it.

Departures from the published model, as the configuration states them:
- depth and vocabulary are the configuration's cut (its `reduced`), and the
  decoder reads the page's vision tokens before the text ids;
- the embedding and the unembed are separate matrices (the published config
  does not say whether they are tied), the unembed in f32;
- `expert_bias` is a fixed input: the published model moves it between
  steps by a rule and rate its config does not give;
- the loss is the page reader's: next-token cross-entropy over the text ids
  that are not PAD.

Routing against a program's: `train_steps` can hand each step's choices of
a program (`routes`) to `route`, which then takes them in place of its own,
so that a flip of a choice whose biased scores lie close is not counted as
a gap; it tallies how many of the program's pairs its own choice holds.
With `record` it keeps its own routing as a program's. `choose` and `weigh`
are the routing's formulas, which a check can also apply to a program's
own router logits.

`train_steps` runs optax's AdamW (`optim.AdamW`) over the checked steps with
the gradients streamed: one backward gives every leaf's sum of squares
(the global norm the clip needs), a second the gradients, each folded into
the moments and freed as it arrives; so the f32 gradients of 5.3B
parameters are never held whole, and the experts, stored in bf16, are held
in bf16 (their exact values) and computed with in f32. With f32 moments,
that fits one card."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .model import NEG_INF, Reference
from .optim import AdamW
from .precision import Precision
from .tokens import PAD_ID


def block_kinds(cfg: dict) -> List[str]:
    d = cfg["decoder"]
    return list(d["layer_types"])


def moe_blocks(cfg: dict) -> List[bool]:
    """Which decoder layers hold experts: from `num_dense_layers` on, every
    `expert_every`-th."""
    d = cfg["decoder"]
    every = max(d.get("expert_every", 1), 1)
    return [d["num_experts"] > 0 and i >= d["num_dense_layers"] and i % every == 0 for i in range(d["depth"])]


def rope_half(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on (B, H, S, D) from position 0, angles in f64."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.outer(torch.arange(x.shape[2], dtype=torch.float64, device=x.device), freqs)
    cos, sin = torch.cat([ang.cos()] * 2, -1).to(x.dtype), torch.cat([ang.sin()] * 2, -1).to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def choose(scores: torch.Tensor, bias: torch.Tensor, k: int) -> torch.Tensor:
    """The (T, k) experts of the largest scores + bias a row, ties to the
    lower index."""
    return torch.sort(scores.detach() + bias, dim=-1, descending=True, stable=True).indices[:, :k]


def weigh(scores: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """The chosen (unbiased) scores over (their sum + 1e-6), times 1."""
    w = scores.gather(1, choice)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-6)


class Lfm2Reference(Reference):
    """`model.Reference` with LFM2's decoder in place of the repo's."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], prec: Optional[Precision] = None,
                 checkpoint: bool = False):
        super().__init__(cfg, params, prec, checkpoint)
        self.grad_sink = None
        self.forced: Optional[Dict[str, tuple]] = None    # prefix -> a program's (choices, weights, logits)
        self.recorded: Optional[Dict[str, tuple]] = None  # prefix -> own (choices, weights, logits), first call
        self.tally: Dict[str, torch.Tensor] = {}

    def expert(self, name: str) -> torch.Tensor:
        """An expert weight in f32: a bf16-held leaf through `_Upcast`
        while `train_steps` collects gradients, else as it is."""
        w = self.p[name]
        if w.dtype == torch.float32:
            return w
        if self.grad_sink is None or not w.requires_grad:
            return w.float()
        return _Upcast.apply(w, self, name)

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        eps = self.cfg["decoder"]["norm_eps"]
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * self.p[name]

    def short_conv(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        d = self.cfg["decoder"]
        s, dim = x.shape[1], x.shape[2]
        b, c, xx = self.lin(x, f"{prefix}.in_proj.weight").chunk(3, dim=-1)
        taps = self.p[f"{prefix}.taps"]                                   # (dim, kernel)
        conv = F.conv1d((b * xx).transpose(1, 2), taps[:, None, :], padding=d["conv_kernel"] - 1, groups=dim)
        y = c * conv[..., :s].transpose(1, 2)
        return self.lin(y, f"{prefix}.out_proj.weight")

    def attention_qk(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        d = self.cfg["decoder"]
        bsz, s, _ = x.shape
        h, hkv, hd = d["heads"], d["kv_heads"], d["head_dim"]
        q = self.lin(x, f"{prefix}.wq.weight").view(bsz, s, h, hd)
        k = self.lin(x, f"{prefix}.wk.weight").view(bsz, s, hkv, hd)
        v = self.lin(x, f"{prefix}.wv.weight").view(bsz, s, hkv, hd).transpose(1, 2)
        q = self.norm(q, f"{prefix}.q_norm.scale").transpose(1, 2)
        k = self.norm(k, f"{prefix}.k_norm.scale").transpose(1, 2)
        q, k = rope_half(q, d["rope_theta"]), rope_half(k, d["rope_theta"])
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        scores = torch.matmul(self.prec.op(q), self.prec.op(k).transpose(-1, -2)) * hd ** -0.5
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~keep, NEG_INF), dim=-1)
        o = torch.matmul(self.prec.op(probs), self.prec.op(v))
        return self.lin(o.transpose(1, 2).reshape(bsz, s, h * hd), f"{prefix}.wo.weight")

    def route(self, x: torch.Tensor, prefix: str):
        """(the chosen experts (T, k), their weights (T, k)) of (T, dim) x:
        its own choice, or the program's where `forced` holds one of the
        same shape (a choice of other shape, or none, counts every pair as
        missed)."""
        d = self.cfg["decoder"]
        logits = torch.matmul(self.prec.op32(x), self.prec.op32(self.p[f"{prefix}.router.weight"]).t())
        scores = torch.sigmoid(logits)
        choice = choose(scores, self.p[f"{prefix}.expert_bias"], d["experts_per_token"])
        if self.forced is not None:
            choice = self._against(prefix, choice)
        w = weigh(scores, choice)
        if self.recorded is not None and prefix not in self.recorded:
            self.recorded[prefix] = tuple(t.detach().clone() for t in (choice, w, logits))
        return choice, w

    def _against(self, prefix: str, own: torch.Tensor) -> torch.Tensor:
        """The program's choices for this call, tallied against `own`: the
        pairs, and those of the program's that `own` lacks."""
        got = self.forced.get(prefix)
        fits = got is not None and tuple(got[0].shape) == tuple(own.shape)
        if fits:
            choice = got[0].to(own.device)
            missed = (choice[:, :, None] != own[:, None, :]).all(dim=-1).sum()
        else:
            choice, missed = own, own.numel()
        self.tally["pairs"] = self.tally.get("pairs", 0) + own.numel()
        self.tally["missed"] = self.tally.get("missed", 0) + missed
        return choice

    def topk_moe(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        b, s, dim = x.shape
        xt = x.reshape(b * s, dim)
        choice, weights = self.route(xt, prefix)
        wg, wu, wd = (self.expert(f"{prefix}.{n}").unbind(0) for n in ("w_gate", "w_up", "w_down"))
        y = xt.new_zeros(xt.shape)
        for e in range(len(wg)):
            rows, slots = torch.nonzero(choice == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xi = self.prec.op(xt[rows])
            h = F.silu(xi @ self.prec.op(wg[e])) * (xi @ self.prec.op(wu[e]))
            y = y.index_add(0, rows, (self.prec.op(h) @ self.prec.op(wd[e])) * weights[rows, slots, None])
        return y.reshape(b, s, dim)

    def _lfm2_block(self, i: int, kind: str, moe: bool):
        prefix = f"decoder.blocks.{i}"

        def run(x):
            h = self.norm(x, f"{prefix}.norm1.scale")
            if kind == "conv":
                x = x + self.short_conv(h, f"{prefix}.conv")
            else:
                x = x + self.attention_qk(h, f"{prefix}.attn")
            h = self.norm(x, f"{prefix}.norm2.scale")
            return x + (self.topk_moe(h, f"{prefix}.mlp") if moe else self.swiglu(h, f"{prefix}.mlp"))
        return run

    def decode(self, x: torch.Tensor, aux: List[torch.Tensor]) -> torch.Tensor:
        """Causal decoder over (B, S, dim) embeddings -> final hidden states
        (no load-balancing term goes to `aux`)."""
        for i, (kind, moe) in enumerate(zip(block_kinds(self.cfg), moe_blocks(self.cfg))):
            x = self._run(self._lfm2_block(i, kind, moe), x)
        return x

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.norm(h, "decoder.norm_f.scale")
        return torch.matmul(self.prec.op32(h), self.prec.op32(self.p["decoder.unembed.weight"]).t())

    def loss(self, pages_u8: torch.Tensor, ids: torch.Tensor, moe_weight: float = 0.0) -> torch.Tensor:
        """Next-token cross-entropy over the text targets that are not PAD,
        behind the page's vision tokens."""
        vis = self.encode(self.preprocess(pages_u8))
        x = torch.cat([vis, self.embed(ids[:, :-1])], dim=1)
        logits = self.logits(self.decode(x, [])[:, vis.shape[1]:])
        targets = ids[:, 1:]
        mask = (targets != PAD_ID).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
        return (ce * mask.reshape(-1)).sum() / mask.sum().clamp(min=1.0)


def train_steps(ref: "Lfm2Reference", params: Dict[str, torch.Tensor], stored: Dict[str, torch.dtype],
                batches: List[Dict[str, np.ndarray]], opt: AdamW, steps: int, device,
                routes: Optional[List[Dict[str, tuple]]] = None, record: bool = False,
                first_grad: Optional[Callable[[str, torch.Tensor], None]] = None) -> dict:
    """`steps` of optax's clip + AdamW (`opt`'s settings and formulas) on
    `ref`'s loss over `batches` in turn, updating `params` in place: the
    leaves that require grad, which `ref` reads beside the fixed expert
    biases. A leaf stored in bf16 (`stored`) may be held in bf16, its exact
    value: the reference computes with it in f32 (`Lfm2Reference.expert`)
    and its f32 gradient comes to the optimizer without a bf16 `.grad`.
    Returns the losses and each leaf's norm of its first clipped gradient.
    Each step runs the loss and its backward twice (the module docstring):
    the two give the same gradients up to the order of atomic sums.

    `routes`: a program's routing of each step (prefix -> (choices,
    weights, router logits)), whose choices are taken in place of the
    reference's own (`Lfm2Reference.route`); the result's "route" then holds
    the tallies. `record`: the result's
    "routes" holds the reference's own routing of each step, in that form.
    `first_grad(name, gradient)` sees each leaf's first clipped gradient."""
    names = list(params)
    losses, grad_norms, recorded = [], {}, []
    ref.tally = {}
    for k in names:     # the moments first, in whole blocks, before any activation
        for moments in (opt.mu, opt.nu):
            moments.setdefault(k, torch.zeros(params[k].shape, dtype=torch.float32, device=params[k].device))
    for i in range(steps):
        b = batches[i % len(batches)]
        pages = torch.from_numpy(np.ascontiguousarray(b["pages_u8"])).to(device)
        ids = torch.from_numpy(np.asarray(b["token_ids"])).to(device, torch.long)
        sq: Dict[str, torch.Tensor] = {}

        def square(k, g):
            sq[k] = g.double().square().sum()

        ref.forced = None if routes is None else routes[i]
        ref.recorded = {} if record else None
        loss = _backward(ref, params, pages, ids, square)
        if record:
            recorded.append({k: tuple(t.cpu() for t in v) for k, v in ref.recorded.items()})
        ref.recorded = None
        norm = float(torch.sqrt(sum(sq[k] for k in names)).float())
        scale = opt.max_norm / norm if norm >= opt.max_norm else 1.0
        if i == 0:
            grad_norms = {k: math.sqrt(float(sq[k])) * scale for k in names}

        def fold(k, g):
            g = g * scale if scale != 1.0 else g
            if i == 0 and first_grad is not None:
                first_grad(k, g)
            opt.mu[k].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
            opt.nu[k].mul_(opt.b2).add_(g * g, alpha=1 - opt.b2)

        _backward(ref, params, pages, ids, fold)
        opt.count += 1
        bc1, bc2 = 1 - opt.b1 ** opt.count, 1 - opt.b2 ** opt.count
        with torch.no_grad():
            for k in names:
                p = params[k].float()
                step = (opt.mu[k] / bc1) / ((opt.nu[k] / bc2).sqrt() + opt.eps) + opt.weight_decay * p
                p.add_(step, alpha=-opt.lr)
                params[k].copy_(p.to(stored[k]))
        losses.append(float(loss))
    ref.forced = None
    found = {"losses": losses, "grad_norms": grad_norms}
    if routes is not None:
        found["route"] = {k: float(v) for k, v in ref.tally.items()}
    if record:
        found["routes"] = recorded
    return found


def _backward(ref: "Lfm2Reference", params: Dict[str, torch.Tensor], pages, ids, on_grad) -> torch.Tensor:
    """ref.loss(pages, ids) and its backward, `on_grad(name, f32 gradient)`
    called on each leaf as its gradient completes and the gradient freed
    after; returns the loss."""
    def done(p, k):
        on_grad(k, p.grad)
        p.grad = None

    hooks = [p.register_post_accumulate_grad_hook(lambda p, k=k: done(p, k))
             for k, p in params.items() if p.dtype == torch.float32]
    ref.grad_sink = on_grad
    try:
        loss = ref.loss(pages, ids)
        loss.backward()
    finally:
        ref.grad_sink = None
        for h in hooks:
            h.remove()
    return loss.detach()


class _Upcast(torch.autograd.Function):
    """A bf16 leaf as f32 for the products; its f32 gradient goes to
    `ref.grad_sink(name, gradient)` and none to the leaf."""

    @staticmethod
    def forward(ctx, w, ref, name):
        ctx.ref, ctx.name = ref, name
        return w.float()

    @staticmethod
    def backward(ctx, grad):
        ctx.ref.grad_sink(ctx.name, grad)
        return None, None, None
