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
other.

The ring's gradient: on every rank, autograd through `ring_attention` on the
rank's chunks (the backward ring carries each chunk's dK/dV home) for a
seeded output gradient, gathered and held against `jax.grad` of the JAX ring
(k and v repeated to H heads, their gradients summed back over each group)
and against autograd of the whole-sequence `mha_reference`, within
GRAD_ATOL (f32 sums over hops in another order). A batch row with kv_len ==
0 has zero gradients in the port; the JAX ring's are not zero there, so
that row is checked for zeros, not against JAX. This module imports JAX
only inside its tests: the spawned ranks import it for `_rank_ring` and
must not load JAX.
"""

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.ops import ring_attention as ring
from vision_compression_project_tpu_torch.ops.attention import mha_reference
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn
from vision_compression_project_tpu_torch.parallel.sharding import gather_shards, local_shard

ATOL = 2e-5
GRAD_ATOL = 5e-5
SEQ_AXES = (None, None, "seq", None)
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


def _grad_out(case, seed):
    _, b, h, _, s, d, _, _ = case
    return np.random.default_rng(100 + seed).standard_normal((b, h, s, d)).astype(np.float32)


def _rank_ring(n):
    """On each of n ranks: every case through ring_attention_sharded_inputs
    on a seq = n mesh, and its gradient through ring_attention on the
    rank's chunks. Returns the whole outputs and (dq, dk, dv)."""
    mesh = build_mesh(MeshConfig(data=1, seq=n), "cpu")
    outs = {}
    for i, case in enumerate(CASES):
        q, k, v, kv_len = (_torch(a) for a in _inputs(case, i))
        outs[case[0]] = ring.ring_attention_sharded_inputs(mesh, q, k, v, causal=case[6], kv_len=kv_len).numpy()
        leaves = [local_shard(t, mesh, SEQ_AXES).requires_grad_() for t in (q, k, v)]
        out = ring.ring_attention(mesh, *leaves, causal=case[6], kv_len=kv_len)
        out.backward(local_shard(torch.from_numpy(_grad_out(case, i)), mesh, SEQ_AXES))
        outs["grad_" + case[0]] = [gather_shards(t.grad, mesh, SEQ_AXES).numpy() for t in leaves]
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


_JAX_GRADS = {}


def _jax_ring_grads(n):
    """For every case, jax.grad of sum(out * g) through the JAX ring on a
    seq = n mesh (all cases in one jitted function, compiled once per n),
    with k/v's gradients summed back from H to Hkv heads."""
    if n in _JAX_GRADS:
        return _JAX_GRADS[n]
    import jax
    import jax.numpy as jnp

    from vision_compression_project_tpu.ops.ring_attention import ring_attention_sharded_inputs
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh

    mesh = jbuild_mesh(JMeshConfig(data=1, seq=n), devices=jax.devices()[:n])
    args, fixed = [], []
    for seed, case in enumerate(CASES):
        q, k, v, kv_len = _inputs(case, seed)
        args.append(tuple(jnp.asarray(a) for a in (q, k, v)))
        fixed.append((case[6], q.shape[1] // k.shape[1], None if kv_len is None else jnp.asarray(kv_len),
                      jnp.asarray(_grad_out(case, seed))))

    def loss(all_args):
        total = 0.0
        for (qq, kk, vv), (causal, group, jlen, g) in zip(all_args, fixed):
            kk, vv = jnp.repeat(kk, group, axis=1), jnp.repeat(vv, group, axis=1)
            total = total + jnp.sum(ring_attention_sharded_inputs(mesh, qq, kk, vv, causal=causal, kv_len=jlen) * g)
        return total

    _JAX_GRADS[n] = [[np.asarray(t) for t in grads] for grads in jax.jit(jax.grad(loss))(args)]
    return _JAX_GRADS[n]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ring_gradient_matches_jax_grad_and_whole_sequence(ranks, case):
    """dq, dk, dv of the ring on every rank: against jax.grad of the JAX
    ring on the batch rows with keys, against autograd of mha_reference on
    all rows, and zero on a kv_len == 0 row."""
    n, outs = ranks
    seed = CASES.index(case)
    want_jax = _jax_ring_grads(n)[seed]
    q, k, v, kv_len = (_torch(a).requires_grad_() if a is not None and a.dtype == np.float32 else _torch(a)
                       for a in _inputs(case, seed))
    mha_reference(q, k, v, kv_len=kv_len, causal=case[6]).backward(torch.from_numpy(_grad_out(case, seed)))
    kv = case[7] or [case[4]] * case[1]
    live = [i for i, n_keys in enumerate(kv) if n_keys > 0]
    for r, got in enumerate(outs):
        for name, g, wj, wt in zip("qkv", got["grad_" + case[0]], want_jax, (q.grad, k.grad, v.grad)):
            np.testing.assert_allclose(g[live], wj[live], atol=GRAD_ATOL, err_msg=f"rank {r} d{name} vs jax")
            np.testing.assert_allclose(g, wt.numpy(), atol=GRAD_ATOL, err_msg=f"rank {r} d{name} vs whole")
            for i in (i for i, n_keys in enumerate(kv) if n_keys == 0):
                assert np.all(g[i] == 0)


def test_ring_refuses_grad(ranks):
    """The ring no longer refuses autograd: every rank's gradient is finite
    and each case's dq is non-zero on the rows with keys."""
    _, outs = ranks
    for got in outs:
        for case in CASES:
            grads = got["grad_" + case[0]]
            assert all(np.isfinite(g).all() for g in grads)
            assert np.abs(grads[0]).max() > 0


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


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_virtual_ring_gradient_with_exact_backward_hops(monkeypatch, n, case):
    """The virtual ranks' backward rings: autograd of the whole-sequence
    mha_reference within GRAD_ATOL, in n(n+1)/2 backward hops under causal
    and n*n without, zero on a kv_len == 0 row."""
    hops = []
    step = ring.ring_step_bwd

    def counting_step(*args):
        hops.append(args[7])
        return step(*args)

    monkeypatch.setattr(ring, "ring_step_bwd", counting_step)
    q, k, v, kv_len = _inputs(case, 20 + n)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    wants = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    g = torch.from_numpy(_grad_out(case, n))
    ring.ring_attention_virtual(*leaves, n, causal=case[6], kv_len=_torch(kv_len)).backward(g)
    mha_reference(*wants, kv_len=_torch(kv_len), causal=case[6]).backward(g)
    for got, want in zip(leaves, wants):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), atol=GRAD_ATOL)
    for i in (i for i, n_keys in enumerate(case[7] or []) if n_keys == 0):
        assert all(bool((t.grad[i] == 0).all()) for t in leaves)
    assert len(hops) == (n * (n + 1) // 2 if case[6] else n * n)
    assert sum(hops) == (n if case[6] else 0)


def test_virtual_ring_refuses_grad_and_ragged_split():
    """The virtual ring takes autograd (no refusal any more) and still
    refuses a sequence that does not divide its ranks."""
    q, k, v, _ = (_torch(a) for a in _inputs(CASES[0], 0))
    out = ring.ring_attention_virtual(q.clone().requires_grad_(), k, v, 2)
    assert out.requires_grad
    with pytest.raises(ValueError, match="does not divide"):
        ring.ring_attention_virtual(q.detach(), k, v, 3)
