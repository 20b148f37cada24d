"""The port's attention gradient (`ops.attention.FlashAttentionFn`, backward
`flash_attention_bwd`) against `jax.grad` of the JAX package's
`flash_attention` (its Pallas forward in interpret mode, its XLA `core_bwd`)
on the same seeded numpy inputs, and the routing that sends a call through
FlashAttentionFn only when a gradient is wanted.

Tolerance: f32, atol 2e-3 on every gradient, the JAX package's own for its
kernel against its reference (tests/test_attention_grad.py); the port's
backward against autograd through its plain version, atol 1e-4 plus rtol
1e-5 (the same f32 operations, chunked and summed in another order: dv
reaches 68 where one key takes 300 rows, and that key's dk, 0 in exact
arithmetic, is a difference of equal sums that leaves noise near 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.ops import attention as jattn
from vision_compression_project_tpu_torch.ops import attention as tattn

ATOL = 2e-3


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)))


def _port_grads(q, k, v, w, kv_len, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out = tattn.flash_attention(qt, kt, vt, kv_len=kv, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (1, 2, 2, 128, 32, None, False),
        (1, 2, 2, 128, 32, None, True),
        (2, 4, 2, 128, 16, [128, 77], True),
        (2, 4, 2, 128, 16, [128, 77], False),
        (2, 4, 2, 130, 16, [130, 77], True),
        (2, 4, 2, 130, 16, None, False),
        # prod's head dims: its global vision stage (16 heads of 96,
        # non-causal) and its decoder (head_dim 128, causal GQA 4:1), ragged.
        (2, 16, 16, 256, 96, None, False),
        (2, 8, 2, 130, 128, [130, 77], True),
    ],
)
def test_gradients_equal_jax_flash_attention(b, h, hkv, s, d, kv_len, causal):
    q, k, v, w = _inputs(s + h, b, h, hkv, s, d)
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, kv_len=jkv, causal=causal) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, got = _port_grads(q, k, v, w, kv_len, causal)
    np.testing.assert_allclose(out, np.asarray(jattn.flash_attention(q, k, v, kv_len=jkv, causal=causal)),
                               atol=ATOL)
    for g, wg in zip(got, want):
        assert g.shape == wg.shape
        np.testing.assert_allclose(g, np.asarray(wg), atol=ATOL)


@pytest.mark.parametrize("chunk", [256, 64, 48])
def test_backward_equals_autograd_of_the_plain_version(chunk):
    """Chunks of any size, ragged S (300) and a row with no valid key: the
    same f32 operations as autograd through mha_reference, chunked."""
    b, h, hkv, s, d = 3, 6, 2, 300, 16
    q, k, v, w = (torch.tensor(x) for x in _inputs(7, b, h, hkv, s, d))
    kv_len = torch.tensor([300, 1, 129], dtype=torch.int32)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad((tattn.mha_reference(qr, kr, vr, kv_len=kv_len, causal=True) * w).sum(),
                               (qr, kr, vr))
    got = tattn.flash_attention_bwd(q, k, v, kv_len, w, True, d ** -0.5, chunk=chunk)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, atol=1e-4, rtol=1e-5)


def test_rows_without_keys_have_zero_gradient():
    """kv_len == 0: the port's forward gives 0 on both routes (the kernel's
    empty key loop, and mha_reference to match it), so the row's output does
    not depend on q, k or v and its gradient is 0. The reference's `core_bwd`
    takes a softmax over an all-masked row, which is uniform: a gradient
    inconsistent with its own Pallas forward, which also gives 0. No training
    path has kv_len == 0 (every target starts with BOS; queries and
    documents are non-empty)."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(3, 2, 4, 2, 40, 16))
    kv_len = torch.tensor([0, 40], dtype=torch.int32)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, kv_len=kv_len)
    assert float(out[0].detach().abs().max()) == 0.0
    dq, dk, dv = torch.autograd.grad((out * w).sum(), (qt, kt, vt))
    assert float(dq[0].abs().max()) == 0.0
    assert float(dk[0].abs().max()) == 0.0 and float(dv[0].abs().max()) == 0.0
    assert float(dq[1].abs().max()) > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_come_back_in_the_input_dtype(dtype):
    q, k, v, w = (torch.tensor(x).to(dtype) for x in _inputs(4, 1, 4, 2, 130, 32))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad((tattn.flash_attention(qt, kt, vt, causal=True) * w).sum(), (qt, kt, vt))
    assert [g.dtype for g in grads] == [dtype] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]


def test_grad_routing(monkeypatch):
    """FlashAttentionFn only with grad enabled and an input requiring it:
    inference calls the forward directly, so serving is untouched."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(5, 1, 2, 2, 128, 32))
    applied = []
    real_apply = tattn.FlashAttentionFn.apply
    monkeypatch.setattr(tattn.FlashAttentionFn, "apply", lambda *a: applied.append(1) or real_apply(*a))
    assert tattn.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        tattn.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        tattn.flash_attention(q, k, v)
    assert applied == []
    out = tattn.flash_attention(q, k, v)
    assert applied == [1] and out.grad_fn is not None
