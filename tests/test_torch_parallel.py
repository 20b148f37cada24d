"""The PyTorch port's multi-device layer (parallel/) against the JAX
package's: `MeshConfig.resolve` and `LOGICAL_RULES`, the active mesh, the
rank launcher, and the retrieval collectives (`distributed_topk`,
`sharded_cosine_topk`, `ring_all_gather_rows`) on a `data` = 2 and 4 mesh.

The collectives run on gloo ranks started by `parallel.spawn` (one spawn per
world size, every check inside it); the JAX side runs on the virtual CPU
devices of tests/conftest.py. Inputs are seeded numpy arrays; rows and queries with
entries of +-0.25 give exact dot products, so duplicate rows tie exactly on
both sides and the tie order (lower shard, then lower row) is tested.
Tolerances: indices equal; values within 1e-6 (the same f32 sums in another
order); gathered rows equal. This module imports JAX only inside its tests:
the spawned ranks import it for their rank functions and must not load JAX.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vision_compression_project_tpu_torch import parallel
from vision_compression_project_tpu_torch.parallel import (
    LOGICAL_RULES, MeshConfig, active_mesh, build_mesh, distributed_topk, initialize_multihost, local_mesh,
    ring_all_gather_rows, sharded_cosine_topk, spawn, use_mesh,
)
from vision_compression_project_tpu_torch.parallel.mesh import AXIS_DATA, axis_size
from vision_compression_project_tpu_torch.parallel.sharding import gather_shards, local_shard

SPAWN_TIMEOUT_S = 180
VAL_ATOL = 1e-6
R, D, Q, K = 48, 16, 4, 5

RESOLVE_CASES = [
    (MeshConfig(), 8), (MeshConfig(data=0, seq=2), 8), (MeshConfig(data=2, seq=2, model=2), 8),
    (MeshConfig(data=1, seq=8), 8), (MeshConfig(expert=2, model=2), 8), (MeshConfig(data=0), 1),
    (MeshConfig(data=4), 4), (MeshConfig(seq=3), 8), (MeshConfig(data=3), 8), (MeshConfig(model=0), 4),
    (MeshConfig(data=2, seq=2), 6), (MeshConfig(data=1, expert=4), 4),
]


@pytest.mark.parametrize("cfg,n", RESOLVE_CASES, ids=[f"{c.shape}-{n}" for c, n in RESOLVE_CASES])
def test_mesh_config_resolve_matches_jax(cfg, n):
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig

    jcfg = JMeshConfig(data=cfg.data, seq=cfg.seq, expert=cfg.expert, model=cfg.model)
    try:
        want = jcfg.resolve(n).shape
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            cfg.resolve(n)
        assert str(got.value) == str(exc)
    else:
        assert cfg.resolve(n).shape == want


def test_axes_and_logical_rules_equal_jax():
    from vision_compression_project_tpu.parallel import LOGICAL_RULES as JRULES
    from vision_compression_project_tpu.parallel import MESH_AXES as JAXES

    assert parallel.MESH_AXES == JAXES
    assert LOGICAL_RULES == JRULES


def test_use_mesh_nests():
    a, b = object(), object()
    assert active_mesh() is None
    with use_mesh(a):
        assert active_mesh() is a
        with use_mesh(b):
            assert active_mesh() is b
        assert active_mesh() is a
    assert active_mesh() is None


def test_build_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        build_mesh(MeshConfig(data=1), "cpu")
    with pytest.raises(ValueError, match="no process-group backend"):
        initialize_multihost(device_type="tpu")


def _rank_raise():
    if dist.get_rank() == 1:
        raise ValueError("boom from rank 1")
    return dist.get_rank()


def _rank_sleep():
    time.sleep(120)


def test_spawn_reraises_a_rank_exception():
    with pytest.raises(ValueError, match="boom from rank 1") as got:
        spawn(_rank_raise, 2, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert any("raised in rank 1 of 2" in note for note in got.value.__notes__)


def test_spawn_times_out_and_kills_the_ranks():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        spawn(_rank_sleep, 2, device_type="cpu", timeout_s=4)
    assert time.monotonic() - t0 < 60


def _data():
    rng = np.random.default_rng(0)
    quarter = (rng.integers(0, 2, (R, D)) * 0.5 - 0.25).astype(np.float32)
    rows = quarter.copy()
    rows[R // 2 + 3] = rows[1]        # duplicates across shards
    rows[R - 1] = rows[1]
    rows[5] = rows[4]                 # and within a shard
    rows[-8:-4] = rng.standard_normal((4, D)).astype(np.float32) / 4
    mask = (rng.random(R) > 0.2).astype(np.float32)
    mask[[1, 4, 5, R // 2 + 3, R - 1]] = 1.0
    queries = (rng.integers(0, 2, (Q, D)) * 0.5 - 0.25).astype(np.float32)
    queries[0] = rows[1]
    queries[1] = rows[4]
    scores = rng.integers(0, 5, R).astype(np.float32)  # many ties
    return rows, mask, queries, scores


def _rank_collectives(n):
    """On each of n ranks: the three collectives over a data = n mesh on
    this rank's shard, the mesh helpers, and initialize_multihost's no-op."""
    initialize_multihost("file:///nonexistent", 99, 98, "cpu")  # already initialised: a no-op
    mesh = build_mesh(MeshConfig(data=n), "cpu")
    shard = mesh.get_local_rank(AXIS_DATA)
    rows, mask, queries, scores = (torch.from_numpy(a) for a in _data())
    per = R // n
    lo = shard * per
    out = {"shape": tuple(mesh.shape), "shard": shard, "data": axis_size(mesh, AXIS_DATA)}
    out["topk"] = [t.numpy() for t in distributed_topk(mesh, scores[lo:lo + per], K)]
    out["cosine"] = [t.numpy() for t in sharded_cosine_topk(mesh, rows[lo:lo + per], mask[lo:lo + per], queries, K)]
    out["gathered"] = ring_all_gather_rows(mesh, rows[lo:lo + per]).numpy()
    os.environ.update(VCP_MESH_DATA="0", VCP_MESH_SEQ=str(n), VCP_MESH_EXPERT="1", VCP_MESH_MODEL="1")
    out["env_mesh"] = tuple(local_mesh("cpu").shape)
    # local_shard / gather_shards over data x seq on a (2, n/2) mesh.
    m2 = build_mesh(MeshConfig(data=2, seq=n // 2), "cpu")
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    part = local_shard(x, m2, ("batch", "seq", "embed"))
    out["part"] = part.numpy()
    out["regathered"] = gather_shards(part, m2, ("batch", "seq", "embed")).numpy()
    try:
        local_shard(torch.zeros(3, 8, 3), m2, ("batch", "seq", "embed"))
    except ValueError as exc:
        out["ragged_refused"] = str(exc)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"data{n}")
def ranks(request):
    n = request.param
    return n, spawn(_rank_collectives, n, n, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _jax_mesh(n):
    import jax

    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh

    return jbuild_mesh(JMeshConfig(data=n), devices=jax.devices()[:n])


def test_mesh_layout(ranks):
    n, outs = ranks
    assert [o["shard"] for o in outs] == list(range(n))
    for o in outs:
        assert o["shape"] == (n, 1, 1, 1) and o["data"] == n
        assert o["env_mesh"] == (1, n, 1, 1)


def test_distributed_topk_matches_jax(ranks):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vision_compression_project_tpu.parallel.collectives import distributed_topk as jdistributed_topk

    n, outs = ranks
    mesh = _jax_mesh(n)
    scores = _data()[3]
    vals, idx = jdistributed_topk(mesh, jax.device_put(scores, NamedSharding(mesh, P("data"))), K)
    for o in outs:
        np.testing.assert_array_equal(o["topk"][1], np.asarray(idx))
        np.testing.assert_allclose(o["topk"][0], np.asarray(vals), atol=VAL_ATOL)


def test_sharded_cosine_topk_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vision_compression_project_tpu.parallel.collectives import sharded_cosine_topk as jsharded

    n, outs = ranks
    mesh = _jax_mesh(n)
    rows, mask, queries, _ = _data()
    vals, idx = jsharded(mesh, jax.device_put(rows, NamedSharding(mesh, P("data", None))),
                         jax.device_put(mask, NamedSharding(mesh, P("data"))), jnp.asarray(queries), K)
    assert np.asarray(vals)[0, 0] == np.asarray(vals)[0, 1]  # the duplicate rows tie
    for o in outs:
        np.testing.assert_array_equal(o["cosine"][1], np.asarray(idx))
        np.testing.assert_allclose(o["cosine"][0], np.asarray(vals), atol=VAL_ATOL)


def test_ring_all_gather_rows_matches_jax(ranks):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vision_compression_project_tpu.parallel.collectives import ring_all_gather_rows as jgather

    n, outs = ranks
    mesh = _jax_mesh(n)
    rows = _data()[0]
    want = np.asarray(jgather(mesh, jax.device_put(rows, NamedSharding(mesh, P("data", None)))))
    for o in outs:
        np.testing.assert_array_equal(o["gathered"], want)


def test_local_shard_and_gather_shards(ranks):
    n, outs = ranks
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    for r, o in enumerate(outs):
        d, s = divmod(r, n // 2)
        np.testing.assert_array_equal(o["part"], x[2 * d:2 * d + 2, s * (16 // n):(s + 1) * (16 // n)])
        np.testing.assert_array_equal(o["regathered"], x)
        assert "does not divide" in o["ragged_refused"]
