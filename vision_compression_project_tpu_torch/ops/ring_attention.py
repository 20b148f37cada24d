"""Ring attention: sequence-parallel attention over the mesh `seq`
dimension, the port of vision_compression_project_tpu/ops/ring_attention.py.

Each rank holds a (B, H, S/n, D) query chunk and the matching k/v chunk.
The k/v chunks travel round the ring, rank i sending to i + 1 and
receiving from i - 1 (`dist.batch_isend_irecv`, all four operations of a hop
posted together on every rank), double-buffered: the next hop's chunk is
in flight while this hop's attention runs. Each hop is one call of
`ring_step`: on the card one launch of the flash-attention kernel (K1,
kernels/flash_attention.cu) that also writes each row's log-sum-exp; on the
CPU the kernel's plain versions (`mha_reference`, `attention_lse`). The
hops' normalised outputs are merged by their log-sum-exps in f32, the
update the reference's online softmax makes. So memory stays O(S/n) a rank
and no rank ever holds the whole sequence.

Masks per hop, for the chunk that started on rank `src`: under `causal` the
rank's own chunk is causal, chunks from earlier ranks are attended whole
and chunks from later ranks are skipped (the reference masks them to -1e30,
and in f32 exp(-1e30 - m) is exactly 0 once a row has a finite maximum, so
skipping gives the same output). The global key lengths `kv_len` become
clamp(kv_len - src * chunk, 0, chunk) in each hop. A hop in which a row has
no valid key has log-sum-exp +inf from the kernel and weighs 0 in the merge.
A row with no valid key anywhere (kv_len == 0) gives 0, as the kernel does;
the reference's ring gives the mean of v there (ROADMAP queue 3 item 3).

GQA: the reference repeats k and v to H heads before the ring; K1 takes the
Hkv heads itself, so here the ring carries Hkv heads, fewer bytes a hop, for
the same output.

The gradient (`RingAttentionFn`, the reference's `jax.grad` through its
ring): the forward keeps q, the rank's k/v chunk, the merged output and the
merged log-sum-exp. The backward is a second ring in which each k/v chunk
travels with its dK/dV, accumulated in f32, until they come back to the
rank that owns the chunk. Each hop is one call of `ring_step_bwd`: on the
card one launch of K1's backward kernel (kernels/flash_attention_bwd.cu)
with the merged output and log-sum-exp, the hop's mask and clamped
`kv_len`, which gives that hop's part of dQ, dK and dV; on the CPU its
plain version (`flash_attention_bwd_lse`). The hops the causal forward
skipped are skipped again. A row with no valid key anywhere has merged
log-sum-exp -inf, which becomes +inf (K1's convention) for the backward, so
its gradients are 0.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import kernels
from ..parallel.mesh import AXIS_SEQ, axis_size
from ..parallel.sharding import gather_shards, local_shard
from .attention import _kernel_operands, _readable, attention_lse, flash_attention_bwd_lse, mha_reference

KV = Tuple[torch.Tensor, torch.Tensor]


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Optional[torch.Tensor],
              causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the ring: (out (B, H, Sq, D) in q's dtype, lse (B, H, Sq)
    f32, +inf for a row without a valid key). On a CUDA tensor one K1
    launch and nothing else; on a CPU tensor the plain versions."""
    if q.device.type == "cpu":
        return (mha_reference(q, k, v, kv_len=kv_len, causal=causal, scale=scale),
                attention_lse(q, k, v, kv_len=kv_len, causal=causal, scale=scale))
    q, k, v, kv_len = _kernel_operands(q, k, v, kv_len)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = kernels.flash_attention_fwd(q, k, v, kv_len, causal, scale, lse=lse)
    return out, lse


def ring_step_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, g: torch.Tensor,
                  lse: torch.Tensor, kv_len: Optional[torch.Tensor], causal: bool, scale: float):
    """One hop of the backward ring: this hop's part of (dq, dk, dv), in
    the inputs' dtype, from the merged output o, its gradient g and the
    merged lse (+inf on a row without a valid key). On a CUDA tensor one
    launch of K1's backward and nothing else; on a CPU tensor the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_lse(q, k, v, o, g, lse, kv_len, causal, scale)
    q, k, v, kv_len = _kernel_operands(q, k, v, kv_len)
    return kernels.flash_attention_bwd(q, k, v, _readable(o), _readable(g), lse, kv_len, causal, scale)


def _hop(idx: int, src: int, chunk: int, causal: bool, kv_len: Optional[torch.Tensor]):
    """(runs, causal, kv_len) of the hop in which rank idx meets the chunk
    that started on rank src."""
    if causal and src > idx:
        return False, False, None
    hop_len = None if kv_len is None else (kv_len - src * chunk).clamp(0, chunk).to(torch.int32)
    return True, causal and src == idx, hop_len


def _merge(out: torch.Tensor, lse: torch.Tensor, o_hop: torch.Tensor, lse_hop: torch.Tensor):
    """Fold one hop's normalised output into the running (out, lse), in f32."""
    lse_hop = lse_hop.masked_fill(lse_hop == float("inf"), float("-inf"))
    m = torch.maximum(lse, lse_hop)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w_run, w_hop = torch.exp(lse - m), torch.exp(lse_hop - m)
    total = w_run + w_hop
    out = (out * w_run[..., None] + o_hop.float() * w_hop[..., None]) / torch.where(
        total > 0, total, torch.ones_like(total))[..., None]
    return out, m + torch.log(total)


def ring_rank(q: torch.Tensor, hops: Iterable[KV], idx: int, n: int, causal: bool, scale: float,
              kv_len: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank `idx`'s attention over a ring of n chunks: q is its (B, H, chunk,
    D) query chunk, `hops` yields the (k, v) chunk of each hop in ring order
    (hop i holds the chunk that started on rank (idx - i) % n), kv_len the
    (B,) global key lengths or None. Returns (out (B, H, chunk, D) in q's
    dtype, the merged lse (B, H, chunk) f32, +inf on a row without a valid
    key)."""
    b, h, chunk, d = q.shape
    out = torch.zeros((b, h, chunk, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, chunk), float("-inf"), dtype=torch.float32, device=q.device)
    for i, (k, v) in enumerate(hops):
        runs, hop_causal, hop_len = _hop(idx, (idx - i) % n, chunk, causal, kv_len)
        if runs:
            o_hop, lse_hop = ring_step(q, k, v, hop_len, hop_causal, scale)
            out, lse = _merge(out, lse, o_hop, lse_hop)
    return out.to(q.dtype), lse.masked_fill(lse == float("-inf"), float("inf"))


def _hop_grads(q, k, v, o, g, lse, idx: int, src: int, causal: bool, scale: float, kv_len):
    """This hop's (dq, dk, dv), or None for a hop the causal forward skipped."""
    runs, hop_causal, hop_len = _hop(idx, src, q.shape[2], causal, kv_len)
    return ring_step_bwd(q, k, v, o, g, lse, hop_len, hop_causal, scale) if runs else None


def _rotate(k: torch.Tensor, v: torch.Tensor, group: dist.ProcessGroup, idx: int, n: int) -> Iterator[KV]:
    """The ring's (k, v) chunks, hop by hop: each hop's send to rank idx + 1
    and receive from idx - 1 are posted before the hop is yielded, so the
    transfer overlaps the caller's work on it."""
    to, frm = dist.get_global_rank(group, (idx + 1) % n), dist.get_global_rank(group, (idx - 1) % n)
    cur = (k.contiguous(), v.contiguous())
    for i in range(n):
        reqs = []
        if i < n - 1:
            nxt = (torch.empty_like(cur[0]), torch.empty_like(cur[1]))
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur[0], to, group), dist.P2POp(dist.isend, cur[1], to, group),
                dist.P2POp(dist.irecv, nxt[0], frm, group), dist.P2POp(dist.irecv, nxt[1], frm, group),
            ])
        yield cur
        for req in reqs:
            req.wait()
        if reqs:
            cur = nxt


def _exchange(tensors: Tuple[torch.Tensor, ...], group: dist.ProcessGroup, idx: int, n: int):
    """Send `tensors` to rank idx + 1 of the ring and return the same number
    received from rank idx - 1 (all operations posted together)."""
    to, frm = dist.get_global_rank(group, (idx + 1) % n), dist.get_global_rank(group, (idx - 1) % n)
    got = tuple(torch.empty_like(t) for t in tensors)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t.contiguous(), to, group) for t in tensors]
                                  + [dist.P2POp(dist.irecv, t, frm, group) for t in got])
    for req in reqs:
        req.wait()
    return got


def _ring_bwd(group, q, k, v, o, g, lse, idx: int, n: int, causal: bool, scale: float, kv_len):
    """The backward ring of rank idx: its dq, and the dk/dv of its own k/v
    chunk, which reach it after visiting every rank."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    cur = (k.contiguous(), v.contiguous(), torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
    for i in range(n):
        grads = _hop_grads(q, cur[0], cur[1], o, g, lse, idx, (idx - i) % n, causal, scale, kv_len)
        if grads is not None:
            dq += grads[0]
            cur[2].add_(grads[1])
            cur[3].add_(grads[2])
        if n == 1:
            break
        if i < n - 1:
            cur = _exchange(cur, group, idx, n)
        else:  # the accumulators go home: chunk idx + 1's to rank idx + 1
            cur = (k, v) + _exchange(cur[2:], group, idx, n)
    return dq.to(q.dtype), cur[2].to(k.dtype), cur[3].to(v.dtype)


class RingAttentionFn(torch.autograd.Function):
    """ring_attention with its gradient (the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, mesh, axis_name, causal, scale):
        n, idx = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
        group = mesh.get_group(axis_name)
        hops = _rotate(k, v, group, idx, n) if n > 1 else [(k, v)]
        out, lse = ring_rank(q, hops, idx, n, causal, scale, kv_len)
        ctx.group, ctx.idx, ctx.n, ctx.causal, ctx.scale = group, idx, n, causal, scale
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(ctx.group, q, k, v, o, g.contiguous(), lse, ctx.idx, ctx.n, ctx.causal, ctx.scale,
                               kv_len)
        return dq, dk, dv, None, None, None, None, None


class VirtualRingAttentionFn(torch.autograd.Function):
    """ring_attention_virtual with its gradient: the n ranks' backward rings
    in one process, each chunk's dK/dV summed where its rank would receive it."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, n, causal, scale):
        kc, vc = k.chunk(n, 2), v.chunk(n, 2)
        outs, lses = zip(*(
            ring_rank(qi, [(kc[(idx - i) % n], vc[(idx - i) % n]) for i in range(n)], idx, n, causal, scale, kv_len)
            for idx, qi in enumerate(q.chunk(n, 2))))
        out = torch.cat(outs, dim=2)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=2), kv_len)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        n = ctx.n
        qc, kc, vc, oc, gc, lc = (t.chunk(n, 2) for t in (q, k, v, o, g.contiguous(), lse))
        dq = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in qc]
        dk = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in kc]
        dv = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in vc]
        for idx in range(n):
            o_i, g_i, l_i = oc[idx].contiguous(), gc[idx].contiguous(), lc[idx].contiguous()
            for src in range(n):
                grads = _hop_grads(qc[idx], kc[src], vc[src], o_i, g_i, l_i, idx, src, ctx.causal, ctx.scale,
                                   kv_len)
                if grads is not None:
                    dq[idx] += grads[0]
                    dk[src] += grads[1]
                    dv[src] += grads[2]
        return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype),
                None, None, None, None)


def ring_attention(
    mesh: DeviceMesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str = AXIS_SEQ,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over a sequence sharded over the mesh dimension `axis_name`,
    in the local view: q (B, H, S/n, D) and k/v (B, Hkv, S/n, D) are this
    rank's chunks (the rank at coordinate i holds positions i*S/n to
    (i+1)*S/n - 1), kv_len the (B,) global key lengths of its batch rows or
    None. Returns this rank's (B, H, S/n, D) chunk of the output. The
    reference's `batch_axis` and `head_axis` (co-sharding B and H) have no
    counterpart: each rank already holds its rows and heads, which go
    through the ring untouched. With grad enabled the call has a gradient
    (RingAttentionFn)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttentionFn.apply(q, k, v, kv_len, mesh, axis_name, causal, scale)


def ring_attention_sharded_inputs(mesh: DeviceMesh, q, k, v, **kwargs) -> torch.Tensor:
    """Ring attention on whole (B, H, S, D) inputs that every rank holds:
    each rank cuts out its seq chunk, runs the ring and gathers the output
    chunks back, so every rank returns the whole (B, H, S, D) output."""
    axes = (None, None, "seq", None)
    out = ring_attention(mesh, *(local_shard(t, mesh, axes) for t in (q, k, v)), **kwargs)
    return gather_shards(out, mesh, axes)


def ring_attention_virtual(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int, causal: bool = False,
                           scale: Optional[float] = None, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring's per-rank steps for n virtual ranks in one process, on whole
    (B, H, S, D) inputs: the same hops, masks and merges as ring_attention
    (so the same kernel launches: n(n+1)/2 under `causal`, n*n without),
    each hop's chunk taken by index instead of received. For holding the
    ring's arithmetic against one whole-sequence call on one device. Its
    gradient runs the n backward rings' hops: n(n+1)/2 launches of K1's
    backward under `causal`, n*n without."""
    if q.shape[2] % n:
        raise ValueError(f"sequence of {q.shape[2]} does not divide {n} ranks")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return VirtualRingAttentionFn.apply(q, k, v, kv_len, n, causal, scale)
