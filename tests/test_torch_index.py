"""The port's VectorIndex and IndexStore against the JAX package's, on the
same rows, records and memory ids made with numpy from a seed: search with
and without a doc filter, short documents, capacity growth, the cached
masks, and indexes saved by one package and loaded by the other."""

import numpy as np
import pytest

from vision_compression_project_tpu.index import vector_index as jvi
from vision_compression_project_tpu_torch.index import IndexStore, MultiVectorIndex
from vision_compression_project_tpu_torch.index import vector_index as tvi

# Scores: f32 dot products of unit vectors summed in another order.
SCORE_ATOL = 1e-5
DIM = 64


def _unit(rng, n):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch(rng, n, docs, start):
    rows = _unit(rng, n)
    records = [
        {"doc_id": docs[i % len(docs)], "page": start + i, "content": f"page text {start + i}",
         "summary": "", "entities": ["e"]}
        for i in range(n)
    ]
    ids = [f"mem{start + i:06d}" for i in range(n)]
    return rows, records, ids


def _both(capacity=1024):
    return jvi.VectorIndex(DIM, capacity=capacity), tvi.VectorIndex(DIM, capacity=capacity, device="cpu")


def _add(indexes, rows, records, ids):
    for index in indexes:
        assert index.add(rows, records, memory_ids=ids) == ids


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(r["id"], r["content"], r["metadata"]) for r in g] == [
            (r["id"], r["content"], r["metadata"]) for r in w
        ]
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], atol=SCORE_ATOL)


def _search_both(jx, tx, queries, top_k=8, doc_id=None):
    want = jx.search(queries, top_k=top_k, doc_id=doc_id)
    got = tx.search(queries, top_k=top_k, doc_id=doc_id)
    assert_same_results(got, want)
    return got


@pytest.mark.parametrize("doc_id", [None, "a", "c"])
def test_add_and_search_match_jax(doc_id):
    rng = np.random.default_rng(0)
    jx, tx = _both()
    _add((jx, tx), *_batch(rng, 300, ["a", "b", "c"], 0))
    got = _search_both(jx, tx, _unit(rng, 3), top_k=8, doc_id=doc_id)
    assert all(len(r) == 8 for r in got)
    if doc_id:
        assert all(r["metadata"]["doc_id"] == doc_id for res in got for r in res)


def test_short_document_and_empty_index():
    rng = np.random.default_rng(1)
    jx, tx = _both()
    assert tx.search(_unit(rng, 1)) == [[]]
    _add((jx, tx), *_batch(rng, 50, ["big"], 0))
    _add((jx, tx), *_batch(rng, 3, ["small"], 50))
    got = _search_both(jx, tx, _unit(rng, 2), top_k=8, doc_id="small")
    assert [len(r) for r in got] == [3, 3]
    assert _search_both(jx, tx, _unit(rng, 1), doc_id="missing") == [[]]


def test_growth_and_cached_masks():
    """Adds that grow the capacity 1024 -> 4096, with masks cached before the
    growth; every cached mask sees the rows added after it was built."""
    rng = np.random.default_rng(2)
    jx, tx = _both()
    start = 0
    for n in (700, 200, 900, 1500):
        queries = _unit(rng, 2)
        for doc in (None, "x", "y"):
            _search_both(jx, tx, queries, top_k=10, doc_id=doc)
        _add((jx, tx), *_batch(rng, n, ["x", "y", "z"], start))
        start += n
        # The newest rows are the best match of a query equal to one of them.
        got = _search_both(jx, tx, tx._rows[start - 1].numpy(), top_k=5, doc_id=None)
        assert got[0][0]["id"] == f"mem{start - 1:06d}"
    assert tx.capacity == jx._rows.shape[0] == 4096 and tx.count == start
    x_rows = [r for r in range(start) if r % 3 == 0]
    got = _search_both(jx, tx, tx._rows[x_rows[-1]].numpy(), top_k=5, doc_id="x")
    assert got[0][0]["id"] == f"mem{x_rows[-1]:06d}"


def test_mask_cache_is_not_a_view_of_the_rows():
    rng = np.random.default_rng(3)
    tx = tvi.VectorIndex(DIM, capacity=1024, device="cpu")
    tx.add(*_batch(rng, 1000, ["a"], 0))
    before = tx._mask_for("a")
    tx.add(*_batch(rng, 100, ["a"], 1000))  # grows to 2048
    after = tx._mask_for("a")
    assert after.shape == (2048,) and after.data_ptr() != before.data_ptr()
    assert after[:1100].eq(1).all() and after[1100:].eq(0).all()


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_saved_index_loads_in_the_other_package(tmp_path, saved_by):
    rng = np.random.default_rng(4)
    jx, tx = _both()
    _add((jx, tx), *_batch(rng, 1200, ["a", "b"], 0))
    (jx if saved_by == "jax" else tx).save(tmp_path)
    loaded_j, loaded_t = jvi.VectorIndex.load(tmp_path), tvi.VectorIndex.load(tmp_path, device="cpu")
    assert loaded_t.count == loaded_j.count == 1200 and loaded_t.metadata == jx.metadata
    queries = _unit(rng, 2)
    for doc in (None, "b"):
        assert_same_results(loaded_t.search(queries, doc_id=doc), jx.search(queries, doc_id=doc))
        assert_same_results(loaded_j.search(queries, doc_id=doc), tx.search(queries, doc_id=doc))


def test_index_store_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    store = IndexStore(tmp_path, DIM, mode="single", device="cpu")
    rows, records, ids = _batch(rng, 40, ["d"], 0)
    assert store.add(rows, records, ids) == ids
    assert (tmp_path / "rows.npz").exists() and (tmp_path / "metadata.json").exists()
    queries = _unit(rng, 1)
    again = IndexStore(tmp_path, DIM, mode="single", device="cpu")
    assert again.index.count == 40
    assert_same_results(again.search(queries, doc_id="d"), store.search(queries, doc_id="d"))
    assert IndexStore(tmp_path, DIM * 2, mode="single", device="cpu").index.count == 0
    # Multi mode beside it: its own files, so the single-mode index is not read.
    multi = IndexStore(tmp_path, DIM, mode="multi", device="cpu")
    assert isinstance(multi.index, MultiVectorIndex) and multi.index.count == 0
    with pytest.raises(ValueError, match="retrieval mode"):
        IndexStore(tmp_path, DIM, mode="sharded", device="cpu")


def _tied_pages(n_pages, unit_pages, rng):
    """A doc of n_pages whose pages are zero vectors (blank pages embed to
    zero) except `unit_pages` (1-based), which hold one shared unit vector."""
    rows = np.zeros((n_pages, DIM), np.float32)
    rows[[p - 1 for p in unit_pages]] = _unit(rng, 1)
    records = [{"doc_id": "tied", "page": p, "content": f"page {p}"} for p in range(1, n_pages + 1)]
    return rows, records, [f"mem{p:06d}" for p in range(1, n_pages + 1)]


@pytest.mark.parametrize("unit_pages,top_k", [([4], 8), ([4], 19), ([3, 9, 12, 15, 18], 3), ([], 8)])
def test_search_ties_ordered_as_the_jax_index(unit_pages, top_k):
    """Pages of equal score come in the JAX index's order, lowest row first,
    and where more pages tie than fit in k the same pages are kept: page 4's
    vector against 19 zero pages gives pages [4, 1, 2, 3, 5, 6, 7, 8] there
    (torch.topk gave [4, 2, 8, 5, 6, 1, 3, 7]). Other docs' rows come first
    in the index, so the tied rows are not rows 0.."""
    rng = np.random.default_rng(6)
    jx, tx = _both()
    _add((jx, tx), *_batch(rng, 37, ["other"], 1000))
    rows, records, ids = _tied_pages(20, unit_pages, rng)
    _add((jx, tx), rows, records, ids)
    query = rows[unit_pages[0] - 1] if unit_pages else _unit(rng, 1)[0]
    got = _search_both(jx, tx, query, top_k=top_k, doc_id="tied")[0]
    # The unit pages tie among themselves, and the zero pages below them.
    want = (unit_pages + [p for p in range(1, 21) if p not in unit_pages])[:top_k]
    assert [r["metadata"]["page"] for r in got] == want
