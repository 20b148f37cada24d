"""Transformer building blocks: RMSNorm, RoPE, attention with GQA and a KV
cache, SwiGLU, the Switch mixture of SwiGLU experts. The port of
vision_compression_project_tpu/models/layers.py. Beside them, the port's own
blocks of hybrid decoders (LFM2's `lfm2_moe`), which the JAX package lacks:
QK-norm in `Attention`, the gated short convolution `ShortConv` with its
conv-state cache, and `TopKMoE`, a dropless top-k mixture with a sigmoid
router whose selection bias does not weigh the outputs. These run on one
device (`single_device_only`).

Numeric contract, as in the reference: parameters are stored in f32 and cast
to the compute dtype at use (flax's `Dense(dtype=...)`), RMSNorm computes in
f32, attention keeps scores and softmax in f32. Whole-sequence attention goes
through `ops.attention.flash_attention` (the kernel on a CUDA tensor) where
the reference runs its Pallas kernel (`use_flash`), and through the plain
version where the reference runs XLA; single-token decode attends to the
cache with plain tensor code. With grad enabled, the encoder's and the
decoder's blocks are rematerialised (`remat`) as the reference's `nn.remat`
does: the backward recomputes each block's activations.

Sequence parallelism: under a mesh whose `seq` dimension holds more than one
rank (`parallel.sharding.use_mesh`), an `Attention` built with
`seq_parallel=True` (the decoder's; `Decoder.forward` takes its input as
this rank's chunk) takes its input as this rank's chunk of the sequence (the rank at coordinate i along `seq`
holds positions i*s to (i+1)*s - 1), rotates RoPE by that offset and attends
over the whole sequence through the ring (ops/ring_attention.py), as the
reference's `_seq_parallel_attn` does. Every other `Attention` (the vision
encoder's) is given whole inputs on every rank and attends over them alone,
as the reference's computes them under the same mesh. A sequence that does
not divide the `seq` dimension cannot be split into such chunks
(`local_shard` raises): it runs whole on every `seq` rank inside
`whole_sequence()`, the path the reference falls back to.

Tensor and expert parallelism (parallel/tensor_parallel.py): a module whose
parameters are this rank's shards (`parallel.sharding.shard_params`) sees
it in their shapes. `Attention` then holds H/m query and Hkv/m KV heads of
the `model` dimension's m ranks, its q/k/v projections column-parallel
behind `copy_to` and its output projection row-parallel before
`reduce_from`; `SwiGLU` likewise cuts its hidden width. `SwitchMoE` holds
E/e experts of the `expert` dimension's e ranks, each with its `model`
shard of the hidden width, and routes every token as the reference's global
view does (`SwitchMoE.forward`). Without an active mesh a sharded module
returns its rank's partial result, which is how one process checks the
ranks' steps one by one.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import kernels
from ..ops.attention import NEG_INF, flash_attention, mha_reference
from ..ops import ring_attention as ring
from ..parallel.mesh import AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_SEQ, axis_size
from ..parallel.sharding import active_mesh, use_mesh
from ..parallel.tensor_parallel import copy_to, gather_cat, gather_from, group_size, reduce_from
from ..utils.metrics import Range, profiling, span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def use_flash(s: int, head_dim: int) -> bool:
    """Whether a whole-sequence attention call takes the kernel: the rule of
    vision_compression_project_tpu/models/layers.py::_use_flash. Shorter
    sequences (ocr_bpe's 64-token windows) take the plain version there as
    here."""
    return s >= 128 and head_dim % 8 == 0


def _attend(q, k, v, kv_len, causal: bool) -> torch.Tensor:
    attend = flash_attention if use_flash(q.shape[2], q.shape[3]) else mha_reference
    return attend(q, k, v, kv_len=kv_len, causal=causal)


_whole = threading.local()


@contextlib.contextmanager
def whole_sequence() -> Iterator[None]:
    """Within the block every `seq` rank holds the whole sequence, not a
    chunk: the fallback for a length that does not divide `seq`. Modules
    attend over their input alone, and `SwitchMoE` counts each token once
    over the `seq` ranks that all hold it."""
    prev = getattr(_whole, "on", False)
    _whole.on = True
    try:
        yield
    finally:
        _whole.on = prev


def seq_mesh():
    """The active mesh when its `seq` dimension holds more than one rank and
    each holds a chunk of the sequence (not inside `whole_sequence()`), else None."""
    mesh = active_mesh()
    if mesh is None or axis_size(mesh, AXIS_SEQ) == 1 or getattr(_whole, "on", False):
        return None
    return mesh


def seq_replicas() -> int:
    """How many `seq` ranks hold each token: the `seq` size inside
    `whole_sequence()` under a mesh, else 1."""
    mesh = active_mesh()
    return axis_size(mesh, AXIS_SEQ) if mesh is not None and getattr(_whole, "on", False) else 1


def mesh_coord(axis: str) -> int:
    """This rank's coordinate along a dimension of the active mesh; a
    sharded module outside a mesh cannot know its shard and raises."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"a module sharded over `{axis}` needs the active mesh (use_mesh) to know its shard")
    return mesh.get_local_rank(axis)


def single_device_only(what: str) -> None:
    """Raise NotImplementedError under a mesh that shards `model`, `expert`
    or `seq`: `what` has no sharded form (a mesh of `data` alone is fine)."""
    mesh = active_mesh()
    if mesh is None:
        return
    sharded = [a for a in (AXIS_MODEL, AXIS_EXPERT, AXIS_SEQ) if axis_size(mesh, a) > 1]
    if sharded:
        raise NotImplementedError(f"{what} runs on one device: the active mesh shards {', '.join(sharded)}")


def whole_sequence_only(what: str) -> None:
    """Raise NotImplementedError under a mesh whose `seq` dimension holds
    more than one rank: `what` takes whole sequences only."""
    if seq_mesh() is not None:
        raise NotImplementedError(f"{what} under a seq-sharded mesh: only Decoder.forward takes a chunk "
                                  "of the sequence (ring attention)")


@contextlib.contextmanager
def _as_at_call(mesh, whole: bool) -> Iterator[None]:
    """The active mesh and `whole_sequence` state of a call, re-entered."""
    prev = getattr(_whole, "on", False)
    _whole.on = whole
    try:
        if mesh is None:
            yield
        else:
            with use_mesh(mesh):
                yield
    finally:
        _whole.on = prev


def remat(block: nn.Module, *args, **kwargs):
    """block(*args, **kwargs), with its activations recomputed in the
    backward instead of stored (the reference's `nn.remat`) when grad is
    enabled; a plain call otherwise, so inference is untouched. The
    recompute runs under the call's mesh and `whole_sequence` state, which
    the autograd engine's own threads do not share."""
    if not torch.is_grad_enabled():
        return block(*args, **kwargs)
    mesh, whole = active_mesh(), getattr(_whole, "on", False)

    def run(*a, **k):
        with _as_at_call(mesh, whole):
            return block(*a, **k)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


@torch.no_grad()
def fill_(w: torch.Tensor, g: torch.Generator, draw) -> None:
    """draw(t, g) fills t with f32 values: in place on an f32 tensor on the
    generator's device, else into an f32 tensor there, copied (and cast) in
    after. So the same generator gives the same values on any device and in
    any storage dtype, and the host holds one tensor at a time."""
    if w.device == g.device and w.dtype == torch.float32:
        draw(w, g)
        return
    buf = torch.empty(w.shape, dtype=torch.float32, device=g.device)
    draw(buf, g)
    w.copy_(buf)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax's lecun_normal: truncated normal at two std, std corrected for the truncation.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    fill_(w, g, lambda t, gen: torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen))


def normal_(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    fill_(w, g, lambda t, gen: t.normal_(0.0, std, generator=gen))


@torch.no_grad()
def init_weights_(model: nn.Module, g: torch.Generator) -> None:
    """Seeded random weights for every submodule, in module order, with the
    JAX package's initializers: lecun-normal Linear and Conv2d kernels and
    expert weights, zero biases, unit RMSNorm scales, N(0, 0.02) embeddings.
    Parameters held outside these modules (position embeddings) are the
    caller's. The model may lie on any device: draws are made on the
    generator's (`fill_`)."""
    for module in model.modules():
        if isinstance(module, RMSNorm):
            module.scale.fill_(1.0)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], g)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            normal_(module.weight, 0.02, g)
        elif isinstance(module, (SwitchMoE, TopKMoE)):
            module.init_experts_(g)
        elif isinstance(module, ShortConv):
            _lecun_normal_(module.taps, module.taps.shape[1], g)


class Dense(nn.Linear):
    """nn.Linear with f32 parameters that computes in `dtype`: input, weight
    and bias are cast first, as flax's Dense(dtype=...) does."""

    def __init__(self, in_features: int, out_features: int, bias: bool, dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.scale.to(torch.float32)).to(x.dtype)


def rope_table(head_dim: int, max_seq: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_seq, head_dim//2) f32 cos/sin tables, computed on the CPU
    whatever the default device, so every device reads the same tables."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device="cpu") / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device="cpu")
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (S, D//2) already sliced to the positions."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, None].to(x.dtype)
    sin = sin[None, None].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    """Multi-head attention with optional GQA, RoPE, causality and KV cache.

    `forward` and `prefill` process whole sequences; `decode` consumes one
    token per batch element against a cache that it updates in place. With
    `seq_parallel`, `forward` under a `seq` mesh of n > 1 ranks takes this
    rank's chunk and attends through the ring (the module docstring)."""

    def __init__(
        self,
        dim: int,
        heads: int,
        kv_heads: int,
        head_dim: int,
        causal: bool = False,
        rope: bool = False,
        rope_theta: float = 10000.0,
        max_seq: int = 4096,
        dtype: str = "bfloat16",
        seq_parallel: bool = False,
        qk_norm: bool = False,
        norm_eps: float = 1e-6,
    ):
        super().__init__()
        dt = torch_dtype(dtype)
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.causal, self.rope, self.max_seq = causal, rope, max_seq
        self.seq_parallel = seq_parallel
        self.wq = Dense(dim, heads * head_dim, False, dt)
        self.wk = Dense(dim, kv_heads * head_dim, False, dt)
        self.wv = Dense(dim, kv_heads * head_dim, False, dt)
        self.wo = Dense(heads * head_dim, dim, False, dt)
        # QK-norm (LFM2's q_layernorm / k_layernorm): RMSNorm over head_dim
        # of every query and key head, before RoPE.
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, norm_eps)
            self.k_norm = RMSNorm(head_dim, norm_eps)
        if rope:
            cos, sin = rope_table(head_dim, max_seq, rope_theta)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def local_heads(self) -> Tuple[int, int]:
        """(query heads, KV heads) this rank holds: all of them, or its
        `model` shard's, as the weights' shapes show."""
        return self.wq.weight.shape[0] // self.head_dim, self.wk.weight.shape[0] // self.head_dim

    def _tp_axes(self) -> Tuple[str, ...]:
        """(`model`,) when this module holds a `model` shard of the heads, else ()."""
        return (AXIS_MODEL,) if self.wq.weight.shape[0] != self.heads * self.head_dim else ()

    def _qkv(self, x: torch.Tensor):
        b, s, _ = x.shape
        h, hkv = self.local_heads()
        x = copy_to(x, self._tp_axes())
        q = self.wq(x).view(b, s, h, self.head_dim).transpose(1, 2)
        k = self.wk(x).view(b, s, hkv, self.head_dim).transpose(1, 2)
        v = self.wv(x).view(b, s, hkv, self.head_dim).transpose(1, 2)
        if self.qk_norm:
            single_device_only("Attention with QK-norm")
            q, k = self.q_norm(q), self.k_norm(k)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        b, h, s, _ = o.shape
        return reduce_from(self.wo(o.transpose(1, 2).reshape(b, s, h * self.head_dim)), self._tp_axes())

    def forward(self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, S, dim), or, with `seq_parallel`, this rank's (B, S/n,
        dim) chunk under a mesh whose `seq` dimension holds n > 1 ranks
        (kv_len stays global)."""
        s = x.shape[1]
        q, k, v = self._qkv(x)
        mesh = seq_mesh() if self.seq_parallel else None
        if self.rope:
            start = 0 if mesh is None else mesh.get_local_rank(AXIS_SEQ) * s
            cos, sin = self.rope_cos[start : start + s], self.rope_sin[start : start + s]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if mesh is None:
            return self._out(_attend(q, k, v, kv_len, self.causal))
        return self._out(ring.ring_attention(mesh, q, k, v, axis_name=AXIS_SEQ, causal=self.causal, kv_len=kv_len))

    def prefill(
        self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None, cache_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache]:
        """Like forward, and also returns the KV cache padded to `cache_len`
        (default max_seq)."""
        whole_sequence_only("Attention.prefill")
        s = x.shape[1]
        cache_len = cache_len or self.max_seq
        q, k, v = self._qkv(x)
        if self.rope:
            cos, sin = self.rope_cos[:s], self.rope_sin[:s]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = _attend(q, k, v, kv_len, self.causal)
        pad = cache_len - s
        cache = {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}
        return self._out(o), cache

    def decode(
        self, x: torch.Tensor, cache: Cache, pos: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, Cache]:
        """x: (B, 1, dim); pos: an int (lockstep batch, every row at one
        position) or a (B,) tensor (ragged batch).

        The new k/v row is written into `cache` in place: at one position for
        the lockstep batch, at each row's own position for the ragged one.
        GQA folds the query heads as (kv_head, group) against the shared
        cache instead of repeating it."""
        whole_sequence_only("Attention.decode")
        b = x.shape[0]
        cache_len = cache["k"].shape[2]
        lockstep = not torch.is_tensor(pos)
        q, k_new, v_new = self._qkv(x)  # (B, H, 1, D), (B, Hkv, 1, D) x2
        if self.rope:
            cos = self.rope_cos[pos]  # (D/2,) or (B, D/2)
            sin = self.rope_sin[pos]
            if not lockstep:
                cos, sin = cos[:, None, None, :], sin[:, None, None, :]
            d2 = self.head_dim // 2

            def rot(t):
                t1, t2 = t[..., :d2], t[..., d2:]
                c, s = cos.to(t.dtype), sin.to(t.dtype)
                return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

            q, k_new = rot(q), rot(k_new)
        k, v = cache["k"], cache["v"]
        if lockstep:
            k[:, :, pos] = k_new[:, :, 0]
            v[:, :, pos] = v_new[:, :, 0]
            pos_b = torch.full((b,), pos, dtype=torch.long, device=x.device)
        else:
            rows = torch.arange(b, device=x.device)
            k[rows, :, pos] = k_new[:, :, 0]
            v[rows, :, pos] = v_new[:, :, 0]
            pos_b = pos
        h, hkv = self.local_heads()
        group = h // hkv
        qg = q.reshape(b, hkv, group, self.head_dim).to(torch.float32)
        scores = torch.einsum("bhgd,bhsd->bhgs", qg, k.to(torch.float32)) * (self.head_dim ** -0.5)
        idx = torch.arange(cache_len, device=x.device)[None, None, None, :]
        mask = idx <= pos_b[:, None, None, None]
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=x.device))
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhgs,bhsd->bhgd", p, v.to(torch.float32)).to(x.dtype)
        return self._out(o.reshape(b, h, 1, self.head_dim)), cache


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)); with its `model` shard of the hidden
    width, gate/up column-parallel and down row-parallel."""

    def __init__(self, dim: int, hidden: int, dtype: str = "bfloat16"):
        super().__init__()
        dt = torch_dtype(dtype)
        self.hidden = hidden
        self.gate = Dense(dim, hidden, False, dt)
        self.up = Dense(dim, hidden, False, dt)
        self.down = Dense(hidden, dim, False, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = () if self.gate.weight.shape[0] == self.hidden else (AXIS_MODEL,)
        x = copy_to(x, axes)
        return reduce_from(self.down(F.silu(self.gate(x)) * self.up(x)), axes)


def token_axes() -> Tuple[str, ...]:
    """The mesh dimensions over which the ranks hold different tokens of a
    batch: `data`, and `seq` while each `seq` rank holds a chunk."""
    return (AXIS_DATA, AXIS_SEQ) if seq_mesh() is not None else (AXIS_DATA,)


def route_offsets(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global routing order from this rank's per-row expert counts (b, E):
    (the number of same-expert tokens before each of its rows' chunk in the
    reference's global token order, batch row major, then sequence
    position, (b, E); every expert's count over the whole batch, (E,)).
    The counts of every rank that holds other tokens are gathered, a few
    hundred integers; without a mesh the rank's rows are the batch."""
    mesh = active_mesh()
    sharded_seq = seq_mesh() is not None
    ns = axis_size(mesh, AXIS_SEQ) if sharded_seq else 1
    q = mesh.get_local_rank(AXIS_SEQ) if sharded_seq else 0
    nd = axis_size(mesh, AXIS_DATA) if mesh is not None else 1
    d = mesh.get_local_rank(AXIS_DATA) if nd > 1 else 0
    b, e = counts.shape
    every = counts[None, None]
    if ns > 1:
        every = gather_cat(every, AXIS_SEQ, 1)
    if nd > 1:
        every = gather_cat(every, AXIS_DATA, 0)
    order = every.permute(0, 2, 1, 3).reshape(-1, e)             # (nd * b * ns, E), global order
    before = (torch.cumsum(order, dim=0) - order).view(nd, b, ns, e)[d, :, q]
    return before, order.sum(dim=0)


class _BackwardStart(torch.autograd.Function):
    """Identity on a module's output; its backward opens the profiler range
    `rng`. It keeps its input only to unpack it there first: under remat
    that runs the block's recompute, so the recompute stays out of the
    range."""

    @staticmethod
    def forward(ctx, y, rng):
        ctx.rng = rng
        ctx.save_for_backward(y)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        _ = ctx.saved_tensors
        ctx.rng.__enter__()
        return grad, None


class _BackwardEnd(torch.autograd.Function):
    """Identity on a module's input; its backward, the module's last, closes
    the profiler range `rng`."""

    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.__exit__(None, None, None)
        return grad, None


class SwitchMoE(nn.Module):
    """Top-1 (Switch) mixture of SwiGLU experts with capacity dispatch: the
    port of vision_compression_project_tpu/models/layers.py::SwitchMoE.

    The router is an f32 Dense on x in f32, then softmax; each token goes to
    its argmax expert (ties to the first) with the top probability as gate.
    capacity = max(1, int(capacity_factor * T / E)) over the T = b * s tokens
    in (b, s) order, PAD positions included; a token's slot is the running
    count of its expert before it, and a token whose slot is at or past the
    capacity is dropped: the MoE gives it 0, so only its residual passes.

    The reference dispatches and combines with dense (T, E, C) one-hot
    einsums; here kept tokens are scattered into an (E * C, d) buffer and
    gathered back, which gives the same values (a one-hot sum adds one term
    to zeros) with static shapes and no host sync. Expert weights are stored
    in the config dtype, as the reference stores them, and the three
    products run in it as batched matmuls over the (E, C, d) buffer; the
    combine gathers in f32, scales by the gate in f32 and casts to x's
    dtype. Every expert's weights are read on every call, however few
    tokens it holds.

    `forward` returns (y, aux): aux = E * sum_e density_e * mean_prob_e, the
    Switch load-balancing term the reference sows for its train step.

    Under a mesh the routing is the reference's global view: its capacity
    counts the T tokens of the whole batch, a token's slot is its position
    among all earlier same-expert tokens of the whole batch, and the aux
    term's means run over all of them (`route_offsets` gathers the counts
    over `data` and `seq`); each rank returns its tokens' share of aux,
    sum_e density_e * (sum of its tokens' probs) / T, so the shares of the
    ranks holding other tokens sum to the whole. With its `expert` shard a
    rank runs only its E/e experts (the router's logits gathered over
    `expert` first) and, with its `model` shard, only its part of their
    hidden width; tokens are replicated over both dimensions, so the
    combine is the sum of the ranks' partial outputs (`reduce_from`), and
    no token moves between ranks."""

    def __init__(self, dim: int, num_experts: int, hidden: int, capacity_factor: float = 1.25,
                 dtype: str = "bfloat16"):
        super().__init__()
        dt = torch_dtype(dtype)
        self.num_experts, self.capacity_factor, self.compute_dtype = num_experts, capacity_factor, dt
        self.hidden = hidden
        self.router = Dense(dim, num_experts, False, torch.float32)
        self.w_gate = nn.Parameter(torch.empty(num_experts, dim, hidden, dtype=dt))
        self.w_up = nn.Parameter(torch.empty(num_experts, dim, hidden, dtype=dt))
        self.w_down = nn.Parameter(torch.empty(num_experts, hidden, dim, dtype=dt))

    @torch.no_grad()
    def init_experts_(self, g: torch.Generator) -> None:
        """Lecun-normal expert weights at the reference's scale (flax's
        lecun_normal of an (E, in, out) kernel takes fan_in = E * in), drawn
        one expert at a time in f32 (`fill_`) and cast into place."""
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                _lecun_normal_(w[e], w.shape[0] * w.shape[1], g)

    def routing(self, logits: torch.Tensor, b: int, s: int) -> Dict[str, torch.Tensor]:
        """The routing of this rank's b x s tokens from their router logits
        over all E experts, (T, E), as the reference's global view routes
        them (the class docstring): probs, expert, gate, slot position `pos`
        and `capacity`, and the aux term's share `aux`."""
        t, e = b * s, self.num_experts
        t_all = t * group_size(active_mesh(), token_axes())
        capacity = max(1, int(self.capacity_factor * t_all / e))
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(probs, dim=-1)                                # (T,)
        gate = probs.gather(1, expert[:, None])[:, 0]                       # (T,)
        onehot = F.one_hot(expert, e)                                       # (T, E) int64
        rows = onehot.view(b, s, e)
        before, counts = route_offsets(rows.sum(dim=1))
        # Slot of each token: same-expert tokens of its row so far, after
        # those of every earlier row and chunk of the whole batch.
        pos = ((torch.cumsum(rows, dim=1) + before[:, None, :]) * rows).sum(dim=-1).reshape(t) - 1
        if t_all == t and seq_replicas() == 1:
            density = onehot.to(torch.float32).mean(dim=0)
            aux = e * torch.sum(density * probs.mean(dim=0))
        else:
            density = counts.to(torch.float32) / t_all
            aux = e * torch.sum(density * probs.sum(dim=0) / t_all) / seq_replicas()
        return {"probs": probs, "expert": expert, "gate": gate, "pos": pos, "capacity": capacity, "aux": aux}

    def expert_partial(self, x: torch.Tensor, route: Dict[str, torch.Tensor], first: int) -> torch.Tensor:
        """(T, d) f32: the outputs of the experts this module holds (E_local
        of them, the first numbered `first`, with the hidden width its
        weights have) for the tokens routed to them within capacity, before
        the gate; 0 for every other token. The sum of these over the ranks
        of `expert` and `model` is the whole MoE's."""
        t, d = x.shape[0] * x.shape[1], x.shape[2]
        e_local, capacity = self.w_gate.shape[0], route["capacity"]
        expert, pos = route["expert"], route["pos"]
        mine = (pos < capacity) & (expert >= first) & (expert < first + e_local)
        # Slot of each of its tokens in the (E_local * C) buffer; every other
        # token goes to one spare row past the end, which reads back as 0.
        slot = torch.where(mine, (expert - first) * capacity + pos, torch.full_like(pos, e_local * capacity))
        dt = self.compute_dtype
        buf = x.new_zeros((e_local * capacity + 1, d), dtype=dt)
        buf.index_copy_(0, slot, x.reshape(t, d).to(dt))
        expert_in = buf[: e_local * capacity].view(e_local, capacity, d)
        h = F.silu(torch.bmm(expert_in, self.w_gate)) * torch.bmm(expert_in, self.w_up)
        expert_out = torch.bmm(h, self.w_down).view(e_local * capacity, d)
        out = torch.cat([expert_out.to(torch.float32), expert_out.new_zeros((1, d), dtype=torch.float32)])
        return out.index_select(0, slot)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, aux). While a profiler records, the call is the range
        `moe.forward` (the remat recompute's too) and its backward the range
        `moe.backward`, between two identity nodes on x and y; with none,
        the autograd graph is as it was."""
        if not profiling():
            return self._forward(x)
        rng = Range("moe.backward")
        with Range("moe.forward"):
            y, aux = self._forward(_BackwardEnd.apply(x, rng))
        return _BackwardStart.apply(y, rng), aux

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        e_local, hidden_local = self.w_gate.shape[0], self.w_gate.shape[2]
        ep_axes = tuple(a for a, sharded in ((AXIS_EXPERT, e_local != self.num_experts),
                                             (AXIS_MODEL, hidden_local != self.hidden)) if sharded)
        x32 = x.to(torch.float32)
        if e_local != self.num_experts:
            x32 = copy_to(x32, (AXIS_EXPERT,))
        logits = self.router(x32).reshape(b * s, e_local)
        if e_local != self.num_experts:
            logits = gather_from(logits, AXIS_EXPERT, 1)
        route = self.routing(logits, b, s)
        first = mesh_coord(AXIS_EXPERT) * e_local if e_local != self.num_experts else 0
        picked = reduce_from(self.expert_partial(copy_to(x, ep_axes), route, first), ep_axes)
        combined = picked * route["gate"][:, None]
        return combined.reshape(b, s, d).to(x.dtype), route["aux"]


def _ranged(forward, x: torch.Tensor, fwd_name: str, bwd_name: str):
    """forward(x) inside the profiler range `fwd_name`, its backward inside
    `bwd_name` (between `_BackwardStart` on the output and `_BackwardEnd` on
    x), while a profiler records; a plain call otherwise."""
    if not profiling():
        return forward(x)
    rng = Range(bwd_name)
    with Range(fwd_name):
        y = forward(_BackwardEnd.apply(x, rng))
    return _BackwardStart.apply(y, rng)


class _ShortConvFn(torch.autograd.Function):
    """ShortConv between its projections on the card: h = in_proj(x) =
    [B | C | x'] (B, S, 3 * dim) and the (dim, kernel) f32 taps -> C *
    conv(B * x') (B, S, dim) in h's dtype, one kernel each way
    (kernels.short_conv_fwd / short_conv_bwd). Saves h and the taps; the
    backward recomputes the filter from h and returns h's gradient whole."""

    @staticmethod
    def forward(ctx, h, taps):
        ctx.save_for_backward(h, taps)
        return kernels.short_conv_fwd(h, taps)

    @staticmethod
    def backward(ctx, dout):
        h, taps = ctx.saved_tensors
        return kernels.short_conv_bwd(h, taps, dout.contiguous())


class ShortConv(nn.Module):
    """LFM2's gated short convolution (`Lfm2MoeShortConv`): B, C, x' =
    chunk3(in_proj(x)); y = C * conv(B * x'); out_proj(y), where conv is a
    causal depthwise filter of `kernel` taps a channel, no bias, left-padded
    with zeros: position t reads B * x' at t - kernel + 1 .. t, tap j
    weighing t - kernel + 1 + j. The projections and B * x' run in the
    compute dtype, the taps sum in f32 and C multiplies in f32 before the
    cast back.

    On a CUDA tensor `forward` computes everything between the projections
    with one hand-written kernel each way (`_ShortConvFn`,
    kernels/short_conv.cu), bit-equal to `_gated`, `_filter` and `_out`,
    which the CPU runs (`_plain`); `prefill` and `decode` run them on any
    device.

    The cache of a sequence is the last kernel - 1 values of B * x', a
    (B, kernel - 1, dim) tensor "conv" in place of attention's k and v: the
    state `prefill` takes at each row's own length and `decode` shifts by one
    position a step. Training runs `forward` in the ranges `conv.forward` and
    `conv.backward` while a profiler records."""

    def __init__(self, dim: int, kernel: int, dtype: str = "bfloat16"):
        super().__init__()
        dt = torch_dtype(dtype)
        self.width = kernel
        self.in_proj = Dense(dim, 3 * dim, False, dt)
        self.taps = nn.Parameter(torch.empty(dim, kernel))
        self.out_proj = Dense(dim, dim, False, dt)

    def _gated(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B * x', C), each (B, S, dim) in the compute dtype."""
        b, c, xx = self.in_proj(x).chunk(3, dim=-1)
        return b * xx, c

    def _filter(self, padded: torch.Tensor, s: int) -> torch.Tensor:
        """(B, s, dim) f32: the taps over (B, s + kernel - 1, dim) B * x'
        whose first kernel - 1 positions come before the s outputs'."""
        w = self.taps.to(torch.float32)
        y = padded[:, :s].to(torch.float32) * w[:, 0]
        for j in range(1, self.width):
            y = y + padded[:, j:j + s].to(torch.float32) * w[:, j]
        return y

    def _out(self, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.out_proj((y * c.to(torch.float32)).to(c.dtype))

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        bx, c = self._gated(x)
        return self._out(self._filter(F.pad(bx, (0, 0, self.width - 1, 0)), x.shape[1]), c)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return self.out_proj(_ShortConvFn.apply(self.in_proj(x), self.taps))
        return self._plain(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, dim) -> (B, S, dim) over whole sequences."""
        single_device_only("ShortConv")
        return _ranged(self._forward, x, "conv.forward", "conv.backward")

    def prefill(self, x: torch.Tensor, kv_len: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """Like forward, and the cache of each row at its true length kv_len
        (B,) (S where None): B * x' at kv_len - kernel + 1 .. kv_len - 1, zeros
        before position 0. Positions past kv_len change no output before them."""
        single_device_only("ShortConv.prefill")
        b, s, _ = x.shape
        bx, c = self._gated(x)
        padded = F.pad(bx, (0, 0, self.width - 1, 0))
        ends = torch.full((b,), s, dtype=torch.long, device=x.device) if kv_len is None else kv_len.long()
        # Row r's state: padded positions ends[r] .. ends[r] + kernel - 2.
        idx = ends[:, None] + torch.arange(self.width - 1, device=x.device)[None, :]
        state = padded.gather(1, idx[..., None].expand(-1, -1, padded.shape[2]))
        return self._out(self._filter(padded, s), c), {"conv": state}

    def decode(self, x: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """x: (B, 1, dim), one position a row, each row after its own cache;
        the cache's state moves on by one position in place."""
        single_device_only("ShortConv.decode")
        bx, c = self._gated(x)
        state = cache["conv"]
        window = torch.cat([state, bx.to(state.dtype)], dim=1)
        state.copy_(window[:, 1:])
        return self._out(self._filter(window, 1), c), cache


# The loads of the top-k routings of a profiled training step, on the device
# until `flush_route_loads`.
_ROUTE_LOADS = []


def flush_route_loads() -> None:
    """Record each top-k routing's load gathered since the last call as a
    range `moe.route.load` whose args are the largest expert's token count
    and the number of experts without a token: one read-back, which
    `train_step` makes after the step's optimizer is enqueued, so no sync
    falls inside the forward or the backward. A no-op when nothing ran."""
    if not _ROUTE_LOADS:
        return
    loads = torch.stack(_ROUTE_LOADS).tolist()
    _ROUTE_LOADS.clear()
    for load in loads:
        with Range("moe.route.load", tuple(float(v) for v in load)):
            pass


class _GroupedMM(torch.autograd.Function):
    """(T, k) rows in expert segments @ (E, k, n) expert weights -> (T, n):
    rows offs[e - 1] .. offs[e] - 1 take expert e's weights (offs: (E,)
    int32 running ends), one grouped product over segments of any size,
    empty ones included. Its backward is two grouped products: dx over the
    same segments against the weights transposed, dw as the segments' x^T dy."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = torch._grouped_mm(dy, w.transpose(1, 2), offs=offs) if ctx.needs_input_grad[0] else None
        dw = torch._grouped_mm(x.t(), dy, offs=offs) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    return _GroupedMM.apply(x, w, offs)


class TopKMoE(nn.Module):
    """A dropless top-k mixture of SwiGLU experts with a sigmoid router and a
    selection bias: LFM2's `Lfm2MoeSparseMoeBlock` (`use_expert_bias`,
    `norm_topk_prob`, `routed_scaling_factor` 1).

    Routing, in f32: s = sigmoid(router(x)); each token takes the k experts
    of the largest s + expert_bias (ties to the lower index), weighted by
    their s, not by the biased score, over (the k weights' sum + 1e-6).
    `expert_bias` is a buffer (no gradient, not a leaf of the optimizer):
    the published model moves it between steps to balance the load, so it
    has no loss term, and `forward` returns None for one.

    Dispatch: the T * k (token, expert) pairs are sorted by expert, stably,
    so each expert's tokens form one segment in token order; every pair is
    computed (no capacity, no padding), the three products as grouped
    products over the uneven segments (`grouped_mm`). Combine: the pairs'
    outputs back in token order, weighed and summed over k in f32, cast to
    x's dtype. Expert weights are stored in the compute dtype.

    While a profiler records, the call is the range `moe.forward` (the remat
    recompute's too) with `moe.route`, `moe.experts` and `moe.combine` inside
    it, and its backward is `moe.backward` with the expert products' backward
    in `moe.experts.backward`. In training, the route's load (the largest
    expert's token count and the number of experts without a token) stays on
    the device until `flush_route_loads` records it after the step."""

    def __init__(self, dim: int, num_experts: int, hidden: int, k: int, dtype: str = "bfloat16"):
        super().__init__()
        dt = torch_dtype(dtype)
        self.num_experts, self.k, self.compute_dtype = num_experts, k, dt
        self.router = Dense(dim, num_experts, False, torch.float32)
        self.register_buffer("expert_bias", torch.zeros(num_experts))
        self.w_gate = nn.Parameter(torch.empty(num_experts, dim, hidden, dtype=dt))
        self.w_up = nn.Parameter(torch.empty(num_experts, dim, hidden, dtype=dt))
        self.w_down = nn.Parameter(torch.empty(num_experts, hidden, dim, dtype=dt))

    @torch.no_grad()
    def init_experts_(self, g: torch.Generator) -> None:
        """Lecun-normal expert weights, each expert's product with its own
        fan-in, one expert at a time (`fill_`); the bias starts at 0, as the
        published model's does."""
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                _lecun_normal_(w[e], w.shape[1], g)
        self.expert_bias.zero_()

    def routing(self, x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, dim) f32 -> (the chosen experts (T, k), their weights (T, k) f32)."""
        scores = torch.sigmoid(self.router(x32))
        biased = scores.detach() + self.expert_bias
        choice = torch.sort(biased, dim=-1, descending=True, stable=True).indices[:, : self.k]
        w = scores.gather(1, choice)
        return choice, w / (w.sum(dim=-1, keepdim=True) + 1e-6)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, None]:
        """(y, None): no load-balancing term."""
        single_device_only("TopKMoE")
        return _ranged(self._forward, x, "moe.forward", "moe.backward"), None

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        t, k = b * s, self.k
        with span("moe.route"):
            choice, weights = self.routing(x.reshape(t, d).to(torch.float32))
            flat = choice.reshape(t * k)
            order = torch.argsort(flat, stable=True)          # pair ids (token * k + slot) by expert
            counts = torch.bincount(flat, minlength=self.num_experts)
            offs = torch.cumsum(counts, 0).to(torch.int32)
            if profiling() and torch.is_grad_enabled():
                _ROUTE_LOADS.append(torch.stack([counts.max(), (counts == 0).sum()]))
            # Each pair's token row; the backward sums a token's k rows in f32.
            xs = x.reshape(t, d).to(self.compute_dtype)[order // k]
        ys = _ranged(lambda xi: self._experts(xi, offs), xs, "moe.experts", "moe.experts.backward")
        with span("moe.combine"):
            back = torch.empty_like(order)
            back[order] = torch.arange(t * k, device=order.device)
            out = ys.index_select(0, back).view(t, k, d).to(torch.float32)
            y = (out * weights[..., None]).sum(dim=1)
        return y.reshape(b, s, d).to(x.dtype)

    def _experts(self, xs: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        h = F.silu(grouped_mm(xs, self.w_gate, offs)) * grouped_mm(xs, self.w_up, offs)
        return grouped_mm(h, self.w_down, offs)
