"""The port's index store and batcher under threads: the counterparts of
both tests in tests/test_concurrency.py, and cases where writers grow the
index past its capacity while readers search doc ids, fresh ones included,
as the threaded HTTP server does with /ingest beside /chat, in single and
in multi mode. On the CPU."""

import sys
import threading

import numpy as np
import pytest

from vision_compression_project_tpu_torch.index import IndexStore
from vision_compression_project_tpu_torch.serve import BatchingQueue

JOIN_S = 120


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _run(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_index_store_concurrent_add_and_search(tmp_path):
    store = IndexStore(tmp_path / "idx", dim=32, device="cpu")
    rng = np.random.default_rng(0)
    errors = []

    def writer(doc):
        try:
            for i in range(5):
                emb = _unit(rng.standard_normal((4, 32)))
                store.add(
                    emb,
                    [{"doc_id": doc, "page": i * 4 + j + 1, "content": f"{doc}-{i}-{j}"} for j in range(4)],
                )
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def reader():
        try:
            for _ in range(20):
                store.search(_unit(rng.standard_normal((1, 32))), top_k=3)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    _run([threading.Thread(target=writer, args=(f"doc{i}",)) for i in range(4)]
         + [threading.Thread(target=reader) for _ in range(4)])
    assert not errors
    assert store.index.count == 4 * 5 * 4
    for i in range(4):
        results = store.search(_unit(rng.standard_normal((1, 32))), top_k=50, doc_id=f"doc{i}")[0]
        assert len(results) == 20
    assert IndexStore(tmp_path / "idx", dim=32, device="cpu").index.count == 80


def test_batching_queue_many_concurrent_waves():
    bq = BatchingQueue(lambda batch: [x + 1 for x in batch], max_batch=8, max_wait_ms=2)
    results = {}
    lock = threading.Lock()

    def worker(v):
        r = bq.submit(v, timeout=10)
        with lock:
            results[v] = r

    _run([threading.Thread(target=worker, args=(v,)) for v in range(64)])
    assert results == {v: v + 1 for v in range(64)}
    bq.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_grows_while_readers_search_fresh_doc_ids(tmp_path, seed):
    """4 writers add 2,560 rows in batches of 32, growing the index from
    1,024 rows to 4,096, while 8 readers search: fresh doc ids (each caches
    a new mask), the writers' own docs while they are written, and all docs.
    No search may raise; a result holds only rows of its doc; afterwards
    every doc finds all of its rows (no cached mask went stale)."""
    store = IndexStore(tmp_path / "idx", dim=32, device="cpu")
    docs, batches, per_batch = [f"doc{i}" for i in range(4)], 20, 32
    errors = []
    done = threading.Event()

    def writer(w, doc):
        rng = np.random.default_rng((seed, w))
        try:
            for i in range(batches):
                store.add(_unit(rng.standard_normal((per_batch, 32))),
                          [{"doc_id": doc, "page": i * per_batch + j + 1, "content": f"{doc} {i} {j}"}
                           for j in range(per_batch)])
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def reader(r):
        rng = np.random.default_rng((seed, 100 + r))
        i = 0
        try:
            while not done.is_set() or i < 50:
                q = _unit(rng.standard_normal((1, 32)))
                assert store.search(q, top_k=4, doc_id=f"fresh-{r}-{i}")[0] == []
                doc = docs[i % len(docs)]
                for hit in store.search(q, top_k=8, doc_id=doc)[0]:
                    assert hit["metadata"]["doc_id"] == doc
                store.search(q, top_k=8)
                i += 1
        except Exception as exc:
            errors.append(exc)

    writers = [threading.Thread(target=writer, args=(w, doc)) for w, doc in enumerate(docs)]
    readers = [threading.Thread(target=reader, args=(r,)) for r in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(JOIN_S)
        done.set()
        for t in readers:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in writers + readers)
    assert errors == []
    assert store.index.count == len(docs) * batches * per_batch
    assert store.index.capacity == 4096
    q = _unit(np.random.default_rng(seed).standard_normal((1, 32)))
    for doc in docs:
        results = store.search(q, top_k=batches * per_batch, doc_id=doc)[0]
        assert sorted(r["metadata"]["page"] for r in results) == list(range(1, batches * per_batch + 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_multivector_index_grows_while_readers_search(tmp_path, seed):
    """Multi mode: 4 writers add 640 pages of 1 to 8 vectors in batches of
    16, growing the index from 256 pages to 1,024, while 8 readers search
    fresh doc ids, the writers' docs and all docs. No search may raise; a
    result holds only pages of its doc, each with the vectors it was given;
    afterwards every doc finds all of its pages."""
    store = IndexStore(tmp_path / "idx", dim=16, mode="multi", device="cpu")
    docs, batches, per_batch = [f"doc{i}" for i in range(4)], 10, 16
    errors = []
    done = threading.Event()

    def writer(w, doc):
        rng = np.random.default_rng((seed, w))
        try:
            for i in range(batches):
                sets = [_unit(rng.standard_normal((int(rng.integers(1, 9)), 16))) for _ in range(per_batch)]
                store.add(sets, [{"doc_id": doc, "page": i * per_batch + j + 1, "content": f"{doc} {i} {j}",
                                  "n": len(sets[j])} for j in range(per_batch)])
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def reader(r):
        rng = np.random.default_rng((seed, 100 + r))
        i = 0
        try:
            while not done.is_set() or i < 30:
                q = _unit(rng.standard_normal((2, 16)))
                assert store.search(q, top_k=4, doc_id=f"fresh-{r}-{i}")[0] == []
                doc = docs[i % len(docs)]
                for hit in store.search(q, top_k=8, doc_id=doc)[0]:
                    assert hit["metadata"]["doc_id"] == doc and len(hit["vectors"]) == hit["metadata"]["n"]
                store.search(q, top_k=8)
                i += 1
        except Exception as exc:
            errors.append(exc)

    writers = [threading.Thread(target=writer, args=(w, doc)) for w, doc in enumerate(docs)]
    readers = [threading.Thread(target=reader, args=(r,)) for r in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(JOIN_S)
        done.set()
        for t in readers:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in writers + readers)
    assert errors == []
    assert store.index.count == len(docs) * batches * per_batch and store.index.capacity == 1024
    q = _unit(np.random.default_rng(seed).standard_normal((1, 16)))
    for doc in docs:
        results = store.search(q, top_k=batches * per_batch, doc_id=doc)[0]
        assert sorted(r["metadata"]["page"] for r in results) == list(range(1, batches * per_batch + 1))
