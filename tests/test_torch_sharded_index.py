"""The PyTorch port's sharded search (`VectorIndex.search_sharded`,
`IndexStore`'s sharded route, `_serving_mesh`) against the JAX package's
`search_sharded` on a `data` = 2 and 4 mesh.

Every rank (gloo, started by `parallel.spawn`, one spawn per world size)
builds the same index and makes the same calls; the JAX side runs on the
virtual CPU devices of tests/conftest.py. The index's capacity (27) and row count
(23, then 26, then 40 after a growth) are multiples of neither world size,
so the shards are padded; one document has fewer rows than k; rows with
entries of +-0.25 give exact dot products, so duplicate rows tie exactly and
the tie order is tested. Tolerances: the same memory ids in the same order,
and the same `shard_rebuilds`; scores within 1e-6 (the same f32 sums in
another order). This module imports JAX only inside its tests: the spawned
ranks import it for their rank functions and must not load JAX.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch.distributed as dist

from vision_compression_project_tpu_torch import config
from vision_compression_project_tpu_torch.index import IndexStore, VectorIndex, store as tstore
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn

SPAWN_TIMEOUT_S = 180
SCORE_ATOL = 1e-6
DIM, CAPACITY = 16, 27
QUERIES = [(None, 5), ("a", 4), ("small", 5), ("missing", 3)]


def _batches():
    """Three adds: 23 rows (docs a, b, small), 3 more (a), then 14 (c) that
    outgrow the capacity. Returns [(rows, records, ids)]."""
    rng = np.random.default_rng(7)
    rows = (rng.integers(0, 2, (40, DIM)) * 0.5 - 0.25).astype(np.float32)
    rows[[9, 17, 22]] = rows[2]          # ties across shards
    rows[3] = rows[2]                    # and within one
    rows[10:13] = rng.standard_normal((3, DIM)).astype(np.float32) / 4
    docs = ["a"] * 10 + ["b"] * 11 + ["small"] * 2 + ["a"] * 3 + ["c"] * 14
    out = []
    for lo, hi in ((0, 23), (23, 26), (26, 40)):
        records = [{"doc_id": docs[i], "page": i + 1, "content": f"row {i}"} for i in range(lo, hi)]
        out.append((rows[lo:hi], records, [f"id{i:03d}" for i in range(lo, hi)]))
    queries = (rng.integers(0, 2, (3, DIM)) * 0.5 - 0.25).astype(np.float32)
    queries[0] = rows[2]
    return out, queries


def _searches(index, search):
    """Each query set of QUERIES after each add, with the rebuild count:
    [(ids per query, scores per query)], rebuilds after each add."""
    batches, queries = _batches()
    results, rebuilds = [], []
    for rows, records, ids in batches:
        index.add(rows, records, memory_ids=ids)
        for doc, k in QUERIES:
            hits = search(queries, k, doc)
            results.append(([[h["id"] for h in q] for q in hits], [[h["score"] for h in q] for q in hits]))
        rebuilds.append(index.shard_rebuilds)
    return results, rebuilds


def _rank_index(n):
    """On each of n ranks: the searches through search_sharded and through
    search, IndexStore's route, and _serving_mesh under each setting."""
    mesh = build_mesh(MeshConfig(data=n), "cpu")
    index = VectorIndex(DIM, capacity=CAPACITY, device="cpu")
    out = {"sharded": _searches(index, lambda q, k, doc: index.search_sharded(mesh, q, top_k=k, doc_id=doc))}
    plain = VectorIndex(DIM, capacity=CAPACITY, device="cpu")
    out["plain"] = _searches(plain, lambda q, k, doc: plain.search(q, top_k=k, doc_id=doc))[0]
    # The shard copies follow the shard's layout, not the mesh object: a new
    # mesh of the same layout reuses them, another data size rebuilds them.
    queries = _batches()[1]
    remesh = [index.shard_rebuilds]
    for cfg in (MeshConfig(data=n), MeshConfig(data=1, seq=n)):
        hits = index.search_sharded(build_mesh(cfg, "cpu"), queries, top_k=3)
        remesh.append(index.shard_rebuilds)
    out["remesh"] = (remesh, [[h["id"] for h in q] for q in hits],
                     [[h["id"] for h in q] for q in index.search(queries, top_k=3)])
    with tempfile.TemporaryDirectory() as tmp:
        store = IndexStore(tmp, DIM, mode="single", device="cpu", mesh=mesh)
        calls = []
        sharded = store.index.search_sharded
        store.index.search_sharded = lambda *a, **kw: calls.append(1) or sharded(*a, **kw)
        rows, records, ids = _batches()[0][0]
        store.add(rows, records, memory_ids=ids)
        hits = store.search(rows[:2], top_k=3, doc_id="a")
        out["store"] = ([[h["id"] for h in q] for q in hits], len(calls))
        serving = {}
        for knob in ("0", "1", "auto"):
            config.RUNTIME = dataclasses.replace(config.RUNTIME, index_sharded=knob, device="cpu")
            m = tstore._serving_mesh()
            serving[knob] = None if m is None else tuple(m.shape)
        out["serving"] = serving
        config.RUNTIME = dataclasses.replace(config.RUNTIME, index_sharded="auto", device="cpu")
        default = tstore.get_default_store(DIM, root=tmp)
        out["default_store_mesh"] = None if default.mesh is None else tuple(default.mesh.shape)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"data{n}")
def ranks(request):
    n = request.param
    return n, spawn(_rank_index, n, n, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _jax_searches(n):
    import jax

    from vision_compression_project_tpu.index.vector_index import VectorIndex as JVectorIndex
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh

    mesh = jbuild_mesh(JMeshConfig(data=n), devices=jax.devices()[:n])
    index = JVectorIndex(DIM, capacity=CAPACITY)
    return _searches(index, lambda q, k, doc: index.search_sharded(mesh, q, top_k=k, doc_id=doc))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (g_ids, g_scores), (w_ids, w_scores) in zip(got, want):
        assert g_ids == w_ids
        for g, w in zip(g_scores, w_scores):
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL)


def test_search_sharded_matches_jax(ranks):
    n, outs = ranks
    want, want_rebuilds = _jax_searches(n)
    assert want_rebuilds == [1, 1, 2]
    assert want[0][0][0][:2] == ["id002", "id003"]  # the tie within a shard, lower row first
    for o in outs:
        got, rebuilds = o["sharded"]
        _assert_same(got, want)
        assert rebuilds == want_rebuilds


def test_search_sharded_equals_search(ranks):
    _, outs = ranks
    for o in outs:
        _assert_same(o["sharded"][0], o["plain"])


def test_padding_and_filler_never_come_back(ranks):
    _, outs = ranks
    for o in outs:
        for ids, scores in o["sharded"][0]:
            for q_ids, q_scores in zip(ids, scores):
                assert all(s > -1e29 for s in q_scores)
                assert len(set(q_ids)) == len(q_ids)
        small = [r for r, (doc, _) in zip(o["sharded"][0], QUERIES * 3) if doc == "small"]
        assert all(len(q) == 2 for ids, _ in small for q in ids)  # 2 rows < k = 5
        missing = [r for r, (doc, _) in zip(o["sharded"][0], QUERIES * 3) if doc == "missing"]
        assert all(q == [] for ids, _ in missing for q in ids)


def test_shard_copies_follow_the_layout_not_the_mesh_object(ranks):
    _, outs = ranks
    for o in outs:
        rebuilds, got, want = o["remesh"]
        assert rebuilds == [2, 2, 3]
        assert got == want


def test_index_store_takes_the_sharded_route(ranks):
    n, outs = ranks
    for o in outs:
        ids, calls = o["store"]
        assert calls == 1
        assert [q[0] for q in ids] == ["id000", "id001"]


def test_serving_mesh_settings(ranks):
    n, outs = ranks
    for o in outs:
        assert o["serving"] == {"0": None, "1": (n, 1, 1, 1), "auto": (n, 1, 1, 1)}
        assert o["default_store_mesh"] == (n, 1, 1, 1)


def test_serving_mesh_without_a_process_group(monkeypatch):
    assert not dist.is_initialized()
    for knob, want in (("0", None), ("auto", None)):
        monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, index_sharded=knob))
        assert tstore._serving_mesh() is want
    monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, index_sharded="1"))
    with pytest.raises(RuntimeError, match="needs a process group"):
        tstore._serving_mesh()
    monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, index_sharded="yes"))
    with pytest.raises(ValueError, match="expected 0, 1 or auto"):
        tstore._serving_mesh()
