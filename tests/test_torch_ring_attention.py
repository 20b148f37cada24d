"""Ring attention in the PyTorch port (ops/ring_attention.py) against the
JAX package's `ring_attention` and against whole-sequence attention.

The ring runs on n = 2 and 4 gloo ranks (parallel.spawn, one spawn per n,
every case inside it) with the sequence sharded over `seq`; the JAX ring
runs on a `seq` = n mesh of the virtual CPU devices of tests/conftest.py, with k
and v repeated to H heads for GQA as the reference's attention layer does
before its ring. The per-rank step is also driven for n virtual ranks in
one process (`ring_attention_virtual`), with its hop count.

Inputs are seeded numpy arrays in f32. Tolerance: atol 2e-5, the same f32
softmax summed hop by hop in another order. A batch row with kv_len == 0
gives 0 in the port (the kernel's empty key loop) and the mean of v in the
JAX ring (ROADMAP queue 3 item 3); the tests check both, not one against the
other. This module imports JAX only inside its tests: the spawned ranks
import it for `_rank_ring` and must not load JAX.
"""

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.ops import ring_attention as ring
from vision_compression_project_tpu_torch.ops.attention import mha_reference
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn

ATOL = 2e-5
SPAWN_TIMEOUT_S = 180

# (name, B, H, Hkv, S, D, causal, kv_len)
CASES = [
    ("causal", 2, 4, 4, 32, 16, True, None),
    ("full", 2, 4, 4, 32, 16, False, None),
    ("causal_gqa_ragged", 3, 4, 2, 32, 16, True, [32, 9, 0]),
    ("full_gqa_ragged", 3, 4, 2, 32, 16, False, [5, 32, 17]),
]


def _inputs(case, seed):
    _, b, h, hkv, s, d, _, kv_len = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v, None if kv_len is None else np.asarray(kv_len, np.int32)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _rank_ring(n):
    """On each of n ranks: every case through ring_attention_sharded_inputs
    on a seq = n mesh; the grad refusal. Returns the whole outputs."""
    mesh = build_mesh(MeshConfig(data=1, seq=n), "cpu")
    outs = {}
    for i, case in enumerate(CASES):
        q, k, v, kv_len = (_torch(a) for a in _inputs(case, i))
        outs[case[0]] = ring.ring_attention_sharded_inputs(mesh, q, k, v, causal=case[6], kv_len=kv_len).numpy()
    q, k, v, _ = (_torch(a) for a in _inputs(CASES[0], 0))
    try:
        ring.ring_attention_sharded_inputs(mesh, q.requires_grad_(), k, v, causal=True)
    except NotImplementedError as exc:
        outs["grad_refused"] = str(exc)
    return outs


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def ranks(request):
    n = request.param
    return n, spawn(_rank_ring, n, n, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _jax_ring(n, case, seed):
    import jax
    import jax.numpy as jnp

    from vision_compression_project_tpu.ops.ring_attention import ring_attention_sharded_inputs
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh

    q, k, v, kv_len = _inputs(case, seed)
    group = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    mesh = jbuild_mesh(JMeshConfig(data=1, seq=n), devices=jax.devices()[:n])
    out = ring_attention_sharded_inputs(
        mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=case[6],
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    return np.asarray(out), v


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_matches_jax_ring(ranks, case):
    n, outs = ranks
    seed = CASES.index(case)
    want, v_rep = _jax_ring(n, case, seed)
    for r, got in enumerate(outs):
        kv_len = case[7] or [case[4]] * case[1]
        live = [i for i, n_keys in enumerate(kv_len) if n_keys > 0]
        np.testing.assert_allclose(got[case[0]][live], want[live], atol=ATOL, err_msg=f"rank {r}")
        for i in (i for i, n_keys in enumerate(kv_len) if n_keys == 0):
            # The port: 0; the JAX ring: the mean of v over all keys.
            assert np.all(got[case[0]][i] == 0)
            np.testing.assert_allclose(want[i], np.broadcast_to(v_rep[i].mean(axis=1, keepdims=True), want[i].shape),
                                       atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_matches_whole_sequence_attention(ranks, case):
    _, outs = ranks
    q, k, v, kv_len = (_torch(a) for a in _inputs(case, CASES.index(case)))
    want = mha_reference(q, k, v, kv_len=kv_len, causal=case[6]).numpy()
    for got in outs:
        np.testing.assert_allclose(got[case[0]], want, atol=ATOL)


def test_ring_refuses_grad(ranks):
    _, outs = ranks
    for got in outs:
        assert "no gradient" in got["grad_refused"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_virtual_ranks_match_whole_sequence_with_exact_hops(monkeypatch, n, case):
    """The per-rank steps of n virtual ranks in one process: the whole
    sequence's attention, in n(n+1)/2 hops under causal and n*n without."""
    hops = []
    step = ring.ring_step

    def counting_step(*args):
        hops.append(args[4])
        return step(*args)

    monkeypatch.setattr(ring, "ring_step", counting_step)
    q, k, v, kv_len = (_torch(a) for a in _inputs(case, 10 + n))
    got = ring.ring_attention_virtual(q, k, v, n, causal=case[6], kv_len=kv_len)
    want = mha_reference(q, k, v, kv_len=kv_len, causal=case[6])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert len(hops) == (n * (n + 1) // 2 if case[6] else n * n)
    assert sum(hops) == (n if case[6] else 0)  # the diagonal hops alone are causal


def test_virtual_ring_bf16_within_bf16_rounding():
    """bf16 inputs: each hop's output is rounded to bf16 before the f32
    merge; within 1e-2 of the f32 whole-sequence attention on the same
    (bf16-rounded) inputs, chip_smoke's bf16 limit."""
    q, k, v, kv_len = (_torch(a) for a in _inputs(CASES[2], 3))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = ring.ring_attention_virtual(q, k, v, 4, causal=True, kv_len=kv_len)
    want = mha_reference(q.float(), k.float(), v.float(), kv_len=kv_len, causal=True)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 1e-2


def test_virtual_ring_refuses_grad_and_ragged_split():
    q, k, v, _ = (_torch(a) for a in _inputs(CASES[0], 0))
    with pytest.raises(NotImplementedError, match="no gradient"):
        ring.ring_attention_virtual(q.requires_grad_(), k, v, 2)
    with pytest.raises(ValueError, match="does not divide"):
        ring.ring_attention_virtual(q.detach(), k, v, 3)
