"""The port's MultiVectorIndex and multi-mode retrieval against the JAX
package's, on the same vector sets, records and memory ids made with numpy
from a seed: MaxSim scores, padding and truncation to vecs_per_page, the doc
filter, the stored `vectors` in the results, ties, indexes saved by one
package and loaded by the other, and multi mode end to end (ingest, then
answer_question with the extractive engine) with the hash embedder. The four
cases of tests/test_multivector.py are ported as the first four tests. The
JAX side runs its own code on the CPU; the port runs on the CPU too."""

import itertools
import json

import numpy as np
import pytest

from vision_compression_project_tpu.index import multivector as jmv
from vision_compression_project_tpu.index import store as jstore
from vision_compression_project_tpu.index import vector_index as jvi
from vision_compression_project_tpu.models import embedder as jemb
from vision_compression_project_tpu.models.configs import EmbedderConfig as JEmbedderConfig
from vision_compression_project_tpu.pipeline import extract as jextract
from vision_compression_project_tpu.pipeline import ingest as jingest
from vision_compression_project_tpu.pipeline import qa as jqa
from vision_compression_project_tpu.raster import make_pdf
from vision_compression_project_tpu_torch.index import IndexStore
from vision_compression_project_tpu_torch.index import multivector as tmv
from vision_compression_project_tpu_torch.index import store as tstore
from vision_compression_project_tpu_torch.index import vector_index as tvi
from vision_compression_project_tpu_torch.models import embedder as temb
from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
from vision_compression_project_tpu_torch.pipeline import ingest as tingest
from vision_compression_project_tpu_torch.pipeline import qa as tqa

from torch_parity import prose_pages

# MaxSim scores: sums of Q maxima of f32 dot products of unit vectors, the
# products summed in another order.
SCORE_ATOL = 1e-5


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(dim, vecs_per_page=8, capacity=256):
    return (jmv.MultiVectorIndex(dim, vecs_per_page=vecs_per_page, capacity=capacity),
            tmv.MultiVectorIndex(dim, vecs_per_page=vecs_per_page, capacity=capacity, device="cpu"))


def _add(indexes, sets, records, ids):
    for index in indexes:
        assert index.add(sets, records, memory_ids=ids) == ids


def assert_same_results(got, want):
    """Same pages in the same order with the same records and stored vectors;
    scores within SCORE_ATOL."""
    assert [(r["id"], r["content"], r["metadata"]) for r in got] == [
        (r["id"], r["content"], r["metadata"]) for r in want
    ]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want], atol=SCORE_ATOL)
    for g, w in zip(got, want):
        assert g["vectors"].dtype == np.float32
        np.testing.assert_array_equal(g["vectors"], np.asarray(w["vectors"]))


def _search_both(jx, tx, queries, top_k=8, doc_id=None):
    want = jx.search(queries, top_k=top_k, doc_id=doc_id)
    got = tx.search(queries, top_k=top_k, doc_id=doc_id)
    assert_same_results(got, want)
    return got


@pytest.fixture
def same_memory_ids(monkeypatch):
    """Both packages draw memory ids from their own counter, in step. The
    multi-vector modules hold their own reference to `_new_memory_id`."""
    for modules in ((jvi, jmv), (tvi, tmv)):
        counter = itertools.count()
        for module in modules:
            monkeypatch.setattr(module, "_new_memory_id", lambda c=counter: f"mem{next(c):06d}")


# -- the cases of tests/test_multivector.py, against the JAX index --------------


def test_maxsim_prefers_fine_grained_match():
    rng = np.random.default_rng(0)
    dim = 64
    q1, q2, noise = _unit(rng.standard_normal((3, dim)))
    page_a = np.stack([q1, q2])  # one vector per query
    page_b = _unit((q1 + q2) / 2)[None]  # one pooled-ish vector
    jx, tx = _both(dim, vecs_per_page=4, capacity=4)
    records = [{"doc_id": "d", "page": p, "content": c} for p, c in ((1, "a"), (2, "b"), (3, "c"))]
    _add((jx, tx), [page_a, page_b, noise[None]], records, ["ma", "mb", "mc"])
    got = _search_both(jx, tx, np.stack([q1, q2]), top_k=3, doc_id="d")
    assert got[0]["id"] == "ma" and got[0]["score"] > got[1]["score"]
    np.testing.assert_array_equal(got[0]["vectors"], page_a)


def test_multivector_padding_and_filter():
    """Sets of 1, 5, 3 and 2 vectors at vecs_per_page 3 (the 5 cut to 3),
    capacity 2 grown to 4; the doc filter, and an unknown doc."""
    rng = np.random.default_rng(1)
    dim = 32
    jx, tx = _both(dim, vecs_per_page=3, capacity=2)
    sets = [_unit(rng.standard_normal((k, dim))) for k in (1, 5, 3, 2)]
    records = [{"doc_id": "x" if i < 2 else "y", "page": i + 1, "content": str(i)} for i in range(4)]
    _add((jx, tx), sets, records, [f"m{i}" for i in range(4)])
    assert tx.count == jx.count == 4 and tx.capacity == jx._rows.shape[0] == 4
    q = _unit(rng.standard_normal((2, dim)))
    got = _search_both(jx, tx, q, top_k=10, doc_id="x")
    assert {r["metadata"]["page"] for r in got} == {1, 2}
    assert [len(r["vectors"]) for r in sorted(got, key=lambda r: r["metadata"]["page"])] == [1, 3]
    _search_both(jx, tx, q, top_k=10, doc_id="y")
    _search_both(jx, tx, q, top_k=10)
    assert tx.search(q, top_k=10, doc_id="zzz") == jx.search(q, top_k=10, doc_id="zzz") == []


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_multivector_save_load(tmp_path, saved_by):
    """An index saved by one package loads in both, searches equal."""
    rng = np.random.default_rng(2)
    jx, tx = _both(16, vecs_per_page=2)
    sets = [_unit(rng.standard_normal((2 - i % 2, 16))) for i in range(3)]
    _add((jx, tx), sets, [{"doc_id": "d", "page": i + 1, "content": f"p{i}"} for i in range(3)],
         ["m0", "m1", "m2"])
    (jx if saved_by == "jax" else tx).save(tmp_path / "mv")
    loaded_j = jmv.MultiVectorIndex.load(tmp_path / "mv")
    loaded_t = tmv.MultiVectorIndex.load(tmp_path / "mv", device="cpu")
    assert loaded_t.count == loaded_j.count == 3 and loaded_t.metadata == jx.metadata
    assert loaded_t.vecs_per_page == 2
    got = _search_both(loaded_j, loaded_t, sets[1], top_k=1, doc_id="d")
    assert got[0]["id"] == "m1"
    assert_same_results(loaded_t.search(sets[0], top_k=3), jx.search(sets[0], top_k=3))


def _text_pages(tmp_path, texts):
    pdf = make_pdf(texts, tmp_path / "doc.pdf")
    jextract.extract_pdf_to_page_jsons(pdf, tmp_path / "pages", dpi=72, engine="text")
    return pdf


def _stores(tmp_path, dim, mode="multi"):
    return (jstore.IndexStore(tmp_path / "jidx", dim=dim, mode=mode),
            IndexStore(tmp_path / "tidx", dim=dim, mode=mode, device="cpu"))


def test_multi_mode_end_to_end(tmp_path, same_memory_ids):
    """Extract -> multi-vector ingest -> MaxSim QA in both packages: equal
    manifests, retrieval and answers; then both stores reloaded from disk."""
    pages = [
        "Engines\nDiesel engines compress air before fuel injection.\n"
        "Turbochargers increase intake pressure substantially.",
        "Brakes\nDisc brakes convert motion into heat through friction.\n"
        "Antilock systems prevent wheel lockup during stops.",
    ]
    pdf = _text_pages(tmp_path, pages)
    jx = jemb.HashNGramEmbedder(JEmbedderConfig(dim=256, ngram_buckets=4096))
    tx = temb.HashNGramEmbedder(EmbedderConfig(dim=256, ngram_buckets=4096), device="cpu")
    jst, tst = _stores(tmp_path, 256)
    jman = jingest.ingest_pages_dir(tmp_path / "pages", pdf, "cars", tmp_path / "j.json", embedder=jx, store=jst)
    tman = tingest.ingest_pages_dir(tmp_path / "pages", pdf, "cars", tmp_path / "t.json", embedder=tx, store=tst)
    assert tman == jman and len(tman["pages"]) == 2
    assert tst.index.metadata == jst.index.metadata
    assert all("sentences" in rec for rec in tst.index.metadata)
    result = tqa.answer_question("cars", "How do disc brakes work?", top_k=2, store=tst, embedder=tx)
    assert result == jqa.answer_question("cars", "How do disc brakes work?", top_k=2, store=jst, embedder=jx)
    assert result["retrieved"][0]["page"] == 2
    assert "friction" in result["answer_md"].lower() and "(cars p.2" in result["answer_md"]
    # Reload from disk (each package's store from the other's files too) and ask again.
    question = "What increases intake pressure?"
    want = jqa.answer_question("cars", question, top_k=2, store=jstore.IndexStore(tmp_path / "jidx", 256, "multi"),
                               embedder=jx)
    for root in ("tidx", "jidx"):
        again = IndexStore(tmp_path / root, dim=256, mode="multi", device="cpu")
        assert again.index.count == 2
        assert tqa.answer_question("cars", question, top_k=2, store=again, embedder=tx) == want
    assert want["retrieved"][0]["page"] == 1


# -- beyond tests/test_multivector.py -------------------------------------------


@pytest.mark.parametrize("doc_id", [None, "a", "c"])
@pytest.mark.parametrize("n_queries", [1, 2, 5])
def test_maxsim_scores_match_jax(doc_id, n_queries):
    """300 pages of 0 to 10 vectors (0: a page that can never match; over 8:
    cut), 3 docs, capacity 256 grown to 512; searches at several k."""
    rng = np.random.default_rng(3 + n_queries)
    dim = 48
    jx, tx = _both(dim)
    sizes = rng.integers(0, 11, 300)
    sets = [_unit(rng.standard_normal((k, dim))) if k else np.zeros((0, dim), np.float32) for k in sizes]
    records = [{"doc_id": "abc"[i % 3], "page": i + 1, "content": f"text {i}", "entities": ["e"]}
               for i in range(300)]
    _add((jx, tx), sets, records, [f"m{i:04d}" for i in range(300)])
    q = _unit(rng.standard_normal((n_queries, dim)))
    for k in (1, 8, 150):
        got = _search_both(jx, tx, q, top_k=k, doc_id=doc_id)
        assert all(len(r["vectors"]) == min(sizes[int(r["id"][1:])], 8) for r in got)
        if doc_id:
            assert all(r["metadata"]["doc_id"] == doc_id for r in got)


@pytest.mark.parametrize("top_k", [8, 19])
def test_maxsim_ties_ordered_as_the_jax_index(top_k):
    """Page 4 holds the query's vector, the 19 other pages of the doc one
    zero vector each (a blank page's embedding): equal scores come lowest
    row first, and the lowest rows are kept where more tie than fit."""
    rng = np.random.default_rng(5)
    dim = 32
    jx, tx = _both(dim)
    others = [_unit(rng.standard_normal((3, dim))) for _ in range(23)]
    _add((jx, tx), others, [{"doc_id": "other", "page": i + 1, "content": "o"} for i in range(23)],
         [f"o{i}" for i in range(23)])
    q = _unit(rng.standard_normal((2, dim)))
    sets = [q if p == 4 else np.zeros((1, dim), np.float32) for p in range(1, 21)]
    _add((jx, tx), sets, [{"doc_id": "tied", "page": p, "content": f"page {p}"} for p in range(1, 21)],
         [f"t{p}" for p in range(1, 21)])
    got = _search_both(jx, tx, q, top_k=top_k, doc_id="tied")
    assert [r["metadata"]["page"] for r in got] == ([4] + [p for p in range(1, 21) if p != 4])[:top_k]


def test_multi_mode_answers_match_jax(tmp_path, same_memory_ids):
    """A 12-page document of seeded prose ingested in multi mode by both
    packages (the hash embedder at full width): each question's retrieved
    pages and extractive answer are equal, stored sentence vectors reused."""
    texts = prose_pages(7, 12)
    pages_dir = tmp_path / "pages"
    pages_dir.mkdir()
    for i, text in enumerate(texts, 1):
        page = {"page_number": i, "markdown": text, "entities": [], "summary": text[:40]}
        (pages_dir / f"page_{i:03d}.json").write_text(json.dumps(page))
    jx, tx = jemb.HashNGramEmbedder(), temb.HashNGramEmbedder(device="cpu")
    jst, tst = _stores(tmp_path, 512)
    for pkg, store, emb in ((jingest, jst, jx), (tingest, tst, tx)):
        pkg.ingest_pages_dir(pages_dir, "doc.pdf", "prose", tmp_path / f"{id(store)}.json", embedder=emb,
                             store=store, batch_size=5)
    for question in ("How many invoices did the billing service process?",
                     "What did the audit team review in section 12?",
                     "Which plant shipped the most units?", "What did the night shift reject?"):
        for top_k in (3, 8):
            want = jqa.answer_question("prose", question, top_k=top_k, store=jst, embedder=jx, engine="extractive")
            got = tqa.answer_question("prose", question, top_k=top_k, store=tst, embedder=tx, engine="extractive")
            assert got == want, question
            assert len(got["retrieved"]) == top_k
