"""Attention over (B, H, S, D) tensors with GQA, a ragged key length and an
optional causal mask.

`flash_attention` routes on the device of `q` alone: a CUDA tensor goes to the
hand-written kernel (kernels/flash_attention.cu), a CPU tensor to
`mha_reference`, the plain version. It keeps the semantics of the JAX
wrapper (vision_compression_project_tpu/ops/attention.py::flash_attention),
which pads S to a multiple of 128, masks the padded keys through the true
`kv_len` and slices padded query rows off the output: the kernel masks ragged
Sq and Sk itself, so nothing is padded or sliced here. It reads q, k and v in
place where their strides allow (head-split views of a projection do) and
returns a (B, H, S, D) view of a (B, S, H, D) tensor, the layout the output
projection reads.

The gradient: `FlashAttentionFn` is the port of the reference's custom_vjp
(`_flash_core`). On a CUDA tensor its forward asks the kernel for each row's
log-sum-exp as well, and its backward is the hand-written backward kernel
(kernels/flash_attention_bwd.cu), which recomputes the weights from it. On a
CPU tensor the forward is `mha_reference` and the backward
`flash_attention_bwd`, plain tensor code that recomputes the weights a chunk
of query rows at a time, as the reference's `core_bwd` does in XLA (the JAX
package has no backward kernel); it is the backward kernel's plain version,
and `attention_lse` the log-sum-exp's. `flash_attention` takes the autograd
function only when grad is enabled and an input requires it, so inference
calls the forward directly and writes no log-sum-exp.

Single-token decode attention is plain tensor code in models/layers.py, as it
is XLA einsums, not a kernel, in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

NEG_INF = -1e30


def _key_mask(b: int, sq: int, sk: int, kv_len: Optional[torch.Tensor], causal: bool,
              device: torch.device) -> torch.Tensor:
    """Which keys each query row attends to, broadcastable to (B, H, Sq, Sk):
    key < kv_len[b], and key <= query when causal."""
    k_idx = torch.arange(sk, device=device)[None, None, None, :]
    mask = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=device)
    if kv_len is not None:
        mask = k_idx < kv_len.to(device)[:, None, None, None]
    if causal:
        mask = mask & (k_idx <= torch.arange(sq, device=device)[None, None, :, None])
    return mask


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Materialized-score attention in f32; the kernel's plain version.

    A row with no valid key (kv_len == 0) gives 0, as the kernel's empty key
    loop does; the JAX package's mha_reference gives the mean of v there."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _key_mask(b, sq, sk, kv_len, causal, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    if kv_len is not None:
        p = p * (kv_len.to(q.device) > 0).to(p.dtype)[:, None, None, None]
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, H, Sq) f32: each query row's log-sum-exp of its scaled, masked
    scores, log sum_valid exp(scale * q.k), +inf for a row with no valid key;
    the plain version of the log-sum-exp the kernel's forward writes for the
    backward. `v` is unused: it is there so that the call reads as
    `mha_reference`'s."""
    del v
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kr = k.float().repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    mask = _key_mask(b, sq, sk, kv_len, causal, q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(dim=-1), lse, torch.tensor(float("inf"), device=q.device))


def _kernel_operands(q, k, v, kv_len):
    """q, k, v and kv_len as the kernels take them: kv_len int32 on q's
    device, and a contiguous copy of any tensor whose layout they cannot read
    in place."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    if kv_len is not None and (kv_len.dtype != torch.int32 or kv_len.device != q.device):
        kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    q, k, v = (_readable(t) for t in (q, k, v))
    return q, k, v, kv_len


def _readable(t: torch.Tensor) -> torch.Tensor:
    return t if kernels.flash_layout_ok(t) else t.clone(memory_format=torch.contiguous_format)


def _forward(q, k, v, kv_len, causal: bool, scale: float) -> torch.Tensor:
    """The kernel on a CUDA tensor and nothing else; the plain version on a
    CPU tensor."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, kv_len=kv_len, causal=causal, scale=scale)
    return kernels.flash_attention_fwd(*_kernel_operands(q, k, v, kv_len), causal, scale)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor],
    g: torch.Tensor,
    causal: bool,
    scale: float,
    chunk: int = 256,
):
    """(dq, dk, dv) of O = attention(q, k, v, kv_len, causal, scale) for the
    output gradient g: the port of the reference's `core_bwd`
    (vision_compression_project_tpu/ops/attention.py:153-211). The weights
    are recomputed in f32, `chunk` query rows at a time, so the largest
    temporary is (B, H, chunk, Sk), never the whole score matrix; dk and dv
    accumulate over the chunks, and GQA folds them back onto the kv heads by
    summing over the group. The gradients come back in the inputs' dtypes.

    The reference pads S to its 128-row block and slices the padding off;
    here the shapes stay unpadded, which gives the same real rows (its padded
    query rows have zero q and g, its padded keys are masked). A row with no
    valid key (kv_len == 0) has output 0 on both routes of the port, so its
    gradient is 0; the reference's softmax over such a row is uniform."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    chunk = min(chunk, sq)
    dev = q.device
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    k_idx = torch.arange(sk, device=dev)
    mask = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=dev)
    keep = None
    if kv_len is not None:
        kv_len = kv_len.to(dev)
        mask = k_idx[None, None, None, :] < kv_len[:, None, None, None]
        keep = (kv_len > 0).to(torch.float32)[:, None, None, None]
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, sk, d), dtype=torch.float32, device=dev)
    for c0 in range(0, sq, chunk):
        c1 = min(c0 + chunk, sq)
        q_i, g_i = q[:, :, c0:c1].float(), g[:, :, c0:c1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q_i, kr) * scale
        m = mask
        if causal:
            m = m & (k_idx[None, None, None, :] <= torch.arange(c0, c1, device=dev)[None, None, :, None])
        p = torch.softmax(torch.where(m, s, neg_inf), dim=-1)
        if keep is not None:
            p = p * keep
        dv += torch.einsum("bhqk,bhqd->bhkd", p, g_i)
        dp = torch.einsum("bhqd,bhkd->bhqk", g_i, vr)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, :, c0:c1] = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_i) * scale
    dk = dk.view(b, hkv, group, sk, d).sum(dim=2)
    dv = dv.view(b, hkv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    kv_len: Optional[torch.Tensor],
    causal: bool,
    scale: float,
    chunk: int = 256,
):
    """The backward kernel's plain version, from the forward's output and
    row log-sum-exp as the kernel takes them: (dq, dk, dv) in the inputs'
    dtypes, with the weights P = exp(scale * q.k - lse) on the valid keys of
    k/v and Delta = rowsum(g * o). `lse` may cover more keys than k/v hold
    (the merged log-sum-exp of a ring, each hop one call): the result is
    then this call's part of the gradient. A row with lse = +inf (no valid
    key) has P = 0 and zero gradients."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    chunk = min(chunk, sq)
    dev = q.device
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    delta = (g.float() * o.float()).sum(dim=-1)
    k_idx = torch.arange(sk, device=dev)
    mask = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=dev)
    if kv_len is not None:
        mask = k_idx[None, None, None, :] < kv_len.to(dev)[:, None, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, sk, d), dtype=torch.float32, device=dev)
    for c0 in range(0, sq, chunk):
        c1 = min(c0 + chunk, sq)
        q_i, g_i = q[:, :, c0:c1].float(), g[:, :, c0:c1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q_i, kr) * scale
        m = mask
        if causal:
            m = m & (k_idx[None, None, None, :] <= torch.arange(c0, c1, device=dev)[None, None, :, None])
        p = torch.where(m, torch.exp(s - lse[:, :, c0:c1, None]), zero)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, g_i)
        dp = torch.einsum("bhqd,bhkd->bhqk", g_i, vr)
        ds = p * (dp - delta[:, :, c0:c1, None])
        dq[:, :, c0:c1] = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_i) * scale
    dk = dk.view(b, hkv, group, sk, d).sum(dim=2)
    dv = dv.view(b, hkv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient, the port of the reference's custom_vjp
    (`_flash_core`). On the card: the forward kernel, which also writes each
    row's log-sum-exp, and the backward kernel, which starts from it; nothing
    else. On the CPU: `mha_reference` and `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal: bool, scale: float):
        ctx.causal, ctx.scale = causal, scale
        if q.device.type != "cuda":
            ctx.save_for_backward(q, k, v, None, None, kv_len)
            return _forward(q, k, v, kv_len, causal, scale)
        q, k, v, kv_len = _kernel_operands(q, k, v, kv_len)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = kernels.flash_attention_fwd(q, k, v, kv_len, causal, scale, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        if o is None:
            dq, dk, dv = flash_attention_bwd(q, k, v, kv_len, g, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = kernels.flash_attention_bwd(q, k, v, o, _readable(g), lse, kv_len, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """O = softmax(scale * Q K^T + mask) V; q (B, H, S, D), k/v (B, Hkv, S, D),
    kv_len optional (B,) valid key lengths. CUDA tensors run the kernel and
    nothing else; CPU tensors run the plain version. With grad enabled and an
    input that requires it, the call goes through FlashAttentionFn."""
    if scale is None:
        scale = q.shape[3] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, kv_len, causal, scale)
    return _forward(q, k, v, kv_len, causal, scale)
