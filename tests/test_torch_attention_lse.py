"""The log-sum-exp that K1's forward writes for its gradient, and the
gradient the backward kernel (kernels/flash_attention_bwd.cu) computes from
it, at small sizes on the CPU, against the JAX package.

- `ops.attention.attention_lse`, the log-sum-exp's plain version, against
  `jax.nn.logsumexp` of the JAX package's masked, scaled scores (built as its
  `mha_reference` builds them): f32, atol 1e-5 (the same f32 products and
  one log-sum-exp, reduced in another order).
- `kernel_passes_bwd` below, the backward kernel's algorithm written as torch
  tensor code pass by pass (Delta = rowsum(dO * O); a dK/dV pass over
  128-key work items of two 64-key warpgroups that loop over the query
  heads of their kv head and 64-row query tiles from the tile that holds
  the diagonal, skipping tiles without a pair of theirs; a dQ pass over
  128-row work items of two 64-row warpgroups and 64-key tiles up to each
  one's key end; P = exp(scale * s - lse) with no running max), against `jax.grad`
  of the JAX package's `flash_attention` (its Pallas forward in interpret
  mode, its XLA `core_bwd`) at every head_dim the kernel takes: f32, atol
  2e-3, the JAX package's own for its kernel against its reference
  (tests/test_attention_grad.py).
- The wrapper's refusals that hold before anything is built, and the
  routing: on a CPU tensor FlashAttentionFn's backward is the plain
  `flash_attention_bwd` and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.ops import attention as jattn
from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.ops import attention as tattn

ATOL = 2e-3
LSE_ATOL = 1e-5
# The backward kernel's bf16 tiling: pass 1 takes work items of KB keys,
# two warpgroups of WG keys, over query tiles of BQ rows (at every
# head_dim); pass 2 work items of QB query rows, two warpgroups of WG rows,
# over tiles of KT keys.
KB, BQ, QB, KT, WG = 128, 64, 128, 64, 64


def _inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)))


def _jax_scores(q, k, kv_len, causal, scale):
    """The JAX package's masked, scaled scores, as its mha_reference forms them."""
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kr = jnp.repeat(jnp.asarray(k), h // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kr) * scale
    k_idx = jnp.arange(sk)[None, None, None, :]
    mask = jnp.ones((b, 1, 1, sk), bool)
    if kv_len is not None:
        mask = k_idx < jnp.asarray(kv_len, jnp.int32)[:, None, None, None]
    if causal:
        mask = jnp.logical_and(mask, k_idx <= jnp.arange(sq)[None, None, :, None])
    return jnp.where(mask, s, jattn.NEG_INF)


@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (1, 2, 2, 128, 32, None, False),
        (1, 2, 2, 128, 32, None, True),
        (3, 4, 2, 77, 16, [77, 0, 30], False),
        (3, 6, 2, 130, 16, [130, 1, 0], True),
        (2, 8, 4, 200, 32, [150, 200], True),
    ],
)
def test_lse_equals_jax_logsumexp(b, h, hkv, s, d, kv_len, causal):
    q, k, v, _ = _inputs(11 + s, b, h, hkv, s, d)
    scale = d ** -0.5
    want = np.asarray(jax.nn.logsumexp(_jax_scores(q, k, kv_len, causal, scale), axis=-1))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = tattn.attention_lse(*(torch.tensor(x) for x in (q, k, v)), kv_len=kv, causal=causal).numpy()
    assert got.shape == (b, h, s) and got.dtype == np.float32
    empty = np.zeros(b, bool) if kv_len is None else np.asarray(kv_len) == 0
    # A row with no key: +inf, so that exp(scale * s - lse) is 0 there (the
    # reference's scores are all -1e30 and give a finite number).
    assert np.all(np.isposinf(got[empty]))
    np.testing.assert_allclose(got[~empty], want[~empty], atol=LSE_ATOL, rtol=0)


def kernel_passes_bwd(q, k, v, o, g, lse, kv_len, causal, scale):
    """The backward kernel's algorithm in torch tensor code, f32: its three
    passes, blocks, warpgroups, tiles, loop bounds, skipped tiles and masks as
    flash_attention_bwd.cu has them."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    lens = [sk] * b if kv_len is None else [min(int(n), sk) for n in kv_len]
    delta = (g * o).sum(dim=-1)  # pass 0
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for bi, n in enumerate(lens):
        for hk in range(hkv):  # pass 1: one work item per 128 keys of (batch, kv head)
            for k0 in range(0, sk, KB):
                if k0 >= n:
                    continue  # at or past kv_len: zeros
                qb0 = k0 // BQ if causal else 0  # the tile that holds the block's diagonal
                for kw in range(k0, min(k0 + KB, sk), WG):  # its two consumer warpgroups
                    keys = torch.arange(kw, min(kw + WG, sk))
                    kt, vt = k[bi, hk, keys], v[bi, hk, keys]
                    dk_acc, dv_acc = torch.zeros_like(kt), torch.zeros_like(vt)
                    for hq in range(hk * group, (hk + 1) * group):
                        for r0 in range(qb0 * BQ, sq, BQ):
                            if kw >= n or (causal and kw > r0 + BQ - 1):
                                continue  # no pair of this warpgroup in the tile
                            rows = torch.arange(r0, min(r0 + BQ, sq))
                            qt, gt = q[bi, hq, rows], g[bi, hq, rows]
                            mask = (keys < n)[:, None] & ((keys[:, None] <= rows[None, :]) if causal else True)
                            pt = torch.exp(kt @ qt.T * scale - lse[bi, hq, rows][None, :])
                            pt = torch.where(mask, pt, torch.zeros(()))
                            dst = pt * (vt @ gt.T - delta[bi, hq, rows][None, :])
                            dv_acc += pt @ gt
                            dk_acc += dst @ qt
                    dk[bi, hk, keys] = dk_acc * scale
                    dv[bi, hk, keys] = dv_acc
        for hq in range(h):  # pass 2: one work item per 128 query rows of (batch, head)
            hk = hq // group
            for q0 in range(0, sq, QB):
                kend = min(n, q0 + QB) if causal else n  # the block's key end
                for qw in range(q0, min(q0 + QB, sq), WG):  # its two consumer warpgroups
                    rows = torch.arange(qw, min(qw + WG, sq))
                    wkend = min(n, qw + WG) if causal else n
                    acc = torch.zeros((len(rows), d))
                    for t0 in range(0, kend, KT):
                        if t0 >= wkend:
                            continue  # past this warpgroup's key end
                        keys = torch.arange(t0, min(t0 + KT, sk))
                        kt, vt = k[bi, hk, keys], v[bi, hk, keys]
                        mask = (keys < n)[None, :] & ((keys[None, :] <= rows[:, None]) if causal else True)
                        p = torch.exp(q[bi, hq, rows] @ kt.T * scale - lse[bi, hq, rows][:, None])
                        p = torch.where(mask, p, torch.zeros(()))
                        ds = p * (g[bi, hq, rows] @ vt.T - delta[bi, hq, rows][:, None])
                        acc += ds @ kt
                    dq[bi, hq, rows] = acc * scale
    return dq, dk, dv


def _passes(q, k, v, g, kv_len, causal):
    qt, kt, vt, gt = (torch.tensor(x) for x in (q, k, v, g))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    scale = q.shape[3] ** -0.5
    o = tattn.mha_reference(qt, kt, vt, kv_len=kv, causal=causal, scale=scale)
    lse = tattn.attention_lse(qt, kt, vt, kv_len=kv, causal=causal, scale=scale)
    return kernel_passes_bwd(qt, kt, vt, o, gt, lse, kv_len, causal, scale)


@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (1, 2, 2, 128, 32, None, False),
        (1, 2, 2, 128, 32, None, True),
        (2, 4, 2, 128, 16, [128, 77], True),
        (2, 4, 2, 130, 16, [130, 77], False),
        (2, 6, 2, 130, 16, [130, 1], True),
        (2, 4, 4, 200, 32, [200, 64], True),
        # Each head_dim of the kernel; lengths that are not multiples of
        # 64 or 128, ragged rows that end inside a warpgroup or after one
        # key, GQA 3:1 and 4:1 (a row with no key: the test below).
        (1, 6, 2, 200, 64, None, True),
        (2, 3, 1, 193, 64, [193, 100], False),
        (2, 4, 1, 150, 96, [150, 1], True),
        (1, 4, 4, 130, 96, None, False),
        (2, 4, 1, 140, 128, [140, 65], True),
        (1, 2, 2, 257, 128, [200], False),
    ],
)
def test_kernel_passes_equal_jax_gradient(b, h, hkv, s, d, kv_len, causal):
    q, k, v, w = _inputs(s + h + 1, b, h, hkv, s, d)
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, kv_len=jkv, causal=causal) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _passes(q, k, v, w, kv_len, causal)
    for name, gt, wg in zip(("dq", "dk", "dv"), got, want):
        assert gt.shape == wg.shape, name
        np.testing.assert_allclose(gt.numpy(), np.asarray(wg), atol=ATOL, err_msg=name)


def test_kernel_passes_zero_gradient_without_keys():
    """kv_len == 0: lse = +inf, so P and every gradient of that batch row are
    0, as the port's plain backward gives; the other rows equal it."""
    q, k, v, w = _inputs(5, 3, 4, 2, 90, 16)
    kv_len = [0, 90, 33]
    got = _passes(q, k, v, w, kv_len, True)
    want = tattn.flash_attention_bwd(*(torch.tensor(x) for x in (q, k, v)), torch.tensor(kv_len, dtype=torch.int32),
                                     torch.tensor(w), True, 16 ** -0.5)
    for gt, wg in zip(got, want):
        assert float(gt[0].abs().max()) == 0.0
        torch.testing.assert_close(gt, wg, atol=1e-4, rtol=1e-5)


def test_cpu_backward_is_the_plain_version(monkeypatch):
    """On CPU tensors FlashAttentionFn's backward runs the plain
    flash_attention_bwd, once, and launches no kernel."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(6, 1, 4, 2, 70, 16))
    calls = []
    plain = tattn.flash_attention_bwd
    monkeypatch.setattr(tattn, "flash_attention_bwd", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    kernels.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad((tattn.flash_attention(*leaves, causal=True) * w).sum(), leaves)
    assert calls == [1]
    assert all(n == 0 for n in kernels.launches.values())


def _operands(d=32, dtype=torch.float32):
    q = torch.zeros((1, 2, 64, d), dtype=dtype)
    return q, q.clone(), q.clone(), q.clone(), q.clone(), torch.zeros((1, 2, 64))


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda ops: tuple(x[..., :24] if i < 5 else x for i, x in enumerate(ops)), "head_dim"),
        (lambda ops: (ops[0], ops[1].bfloat16(), *ops[2:]), "dtypes"),
        (lambda ops: ops, "CUDA tensors"),
    ],
)
def test_backward_wrapper_refuses_before_building(change, match):
    """What flash_attention_bwd refuses is refused before the library is
    built or anything is counted: an unsupported head_dim, mixed dtypes and,
    here, tensors that are not on the card."""
    q, k, v, o, g, lse = change(_operands())
    with pytest.raises(ValueError, match=match):
        kernels.flash_attention_bwd(q, k, v, o, g, lse, None, False, 0.125)
    assert kernels._flash_bwd_lib.cache_info().currsize == 0
