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

Single-token decode attention is plain tensor code in models/layers.py, as it
is XLA einsums, not a kernel, in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

NEG_INF = -1e30


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
    k_idx = torch.arange(sk, device=q.device)[None, None, None, :]
    mask = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = k_idx < kv_len.to(q.device)[:, None, None, None]
    if causal:
        q_idx = torch.arange(sq, device=q.device)[None, None, :, None]
        mask = mask & (k_idx <= q_idx)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    if kv_len is not None:
        p = p * (kv_len.to(q.device) > 0).to(p.dtype)[:, None, None, None]
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


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
    nothing else; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, kv_len=kv_len, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if kv_len is not None and (kv_len.dtype != torch.int32 or kv_len.device != q.device):
        kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    q, k, v = (t if kernels.flash_layout_ok(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    return kernels.flash_attention_fwd(q, k, v, kv_len, causal, scale)
