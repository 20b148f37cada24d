"""The port's /chat path against the JAX package's: page JSON ingested into
the index, then answer_question with each engine (analytic, extractive, lm)
on the same pages, the same embedder space and, for 'lm', the same weights
of a mini ocr_bpe carried across by `params_from_jax`. Memory ids are made
by the same counter on both sides, so the evidence packs are the same text.

The JAX side runs its XLA attention (VCP_FORCE_XLA_ATTENTION=1) and its
Pallas scoring kernel in interpret mode; the port runs on the CPU, where both
kernels take their plain versions.
"""

import dataclasses
import inspect
import itertools
import json
import re

import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from vision_compression_project_tpu import config as jconfig
from vision_compression_project_tpu.index import store as jstore
from vision_compression_project_tpu.index import vector_index as jvi
from vision_compression_project_tpu.models import embedder as jemb
from vision_compression_project_tpu.models import tokenizer as jtok
from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu.pipeline import ingest as jingest
from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.pipeline import qa as jqa
from vision_compression_project_tpu.train import checkpoint as jckpt
from vision_compression_project_tpu.train.data import _synthetic_agg_qa_example
from vision_compression_project_tpu_torch import config as tconfig
from vision_compression_project_tpu_torch.index import store as tstore
from vision_compression_project_tpu_torch.index import vector_index as tvi
from vision_compression_project_tpu_torch.models import embedder as temb
from vision_compression_project_tpu_torch.models import tokenizer as ttok
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.pipeline import ingest as tingest
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.pipeline import qa as tqa
from vision_compression_project_tpu_torch.train import checkpoint as tckpt
from vision_compression_project_tpu_torch.weights import params_from_jax

from test_torch_slice import BF16_LOGITS_ATOL
from torch_parity import mini_bpe_configs, numpy_params, prose_pages

DOC = "doc-7f3a"


@pytest.fixture(scope="module")
def embedders():
    return jemb.HashNGramEmbedder(), temb.HashNGramEmbedder(device="cpu")


@pytest.fixture
def same_memory_ids(monkeypatch):
    """Both packages draw memory ids from their own counter, in step."""
    for module in (jvi, tvi):
        counter = itertools.count()
        monkeypatch.setattr(module, "_new_memory_id", lambda c=counter: f"mem{next(c):06d}")


def _write_pages(pages_dir, texts):
    pages_dir.mkdir(parents=True, exist_ok=True)
    for i, text in enumerate(texts, 1):
        page = {"page_number": i, "markdown": text, "entities": [], "summary": text[:40]}
        (pages_dir / f"page_{i:03d}.json").write_text(json.dumps(page))


def _ingest_both(tmp_path, texts, embedders, doc=DOC):
    jx, tx = embedders
    _write_pages(tmp_path / "pages", texts)
    jst = jstore.IndexStore(tmp_path / "jidx", jx.dim, mode="single")
    tst = tstore.IndexStore(tmp_path / "tidx", tx.dim, mode="single", device="cpu")
    jman = jingest.ingest_pages_dir(tmp_path / "pages", "doc.pdf", doc, tmp_path / "j.json",
                                    embedder=jx, store=jst)
    tman = tingest.ingest_pages_dir(tmp_path / "pages", "doc.pdf", doc, tmp_path / "t.json",
                                    embedder=tx, store=tst)
    return (jst, jman), (tst, tman)


def _answers(both, embedders, question, jax_runner=None, port_runner=None, **kw):
    (jst, _), (tst, _) = both
    jx, tx = embedders
    want = jqa.answer_question(DOC, question, store=jst, embedder=jx, runner=jax_runner, **kw)
    got = tqa.answer_question(DOC, question, store=tst, embedder=tx, runner=port_runner, **kw)
    return got, want


def _without_ids(manifest):
    return {**manifest, "pages": [{k: v for k, v in p.items() if k != "memory_id"} for p in manifest["pages"]]}


def test_ingest_manifests_equal(tmp_path, embedders):
    texts = prose_pages(1, 5)
    pages = tmp_path / "pages"
    _write_pages(pages, texts)
    fenced = {"page_number": 6, "markdown": "", "entities": [], "summary": "",
              "raw_response": '```json\n{"page_number": 6, "markdown": "Fenced page text here.", '
                              '"entities": ["x"], "summary": "s"}\n```'}
    (pages / "page_006.json").write_text(json.dumps(fenced))
    (pages / "page_007.json").write_text("{not json")
    jx, tx = embedders
    jst = jstore.IndexStore(tmp_path / "jidx", jx.dim, mode="single")
    tst = tstore.IndexStore(tmp_path / "tidx", tx.dim, mode="single", device="cpu")
    jman = jingest.ingest_pages_dir(pages, "doc.pdf", DOC, tmp_path / "j.json", embedder=jx, store=jst,
                                    batch_size=4)
    tman = tingest.ingest_pages_dir(pages, "doc.pdf", DOC, tmp_path / "t.json", embedder=tx, store=tst,
                                    batch_size=4)
    assert _without_ids(tman) == _without_ids(jman)
    assert [p["page"] for p in tman["pages"]] == [1, 2, 3, 4, 5, 6]
    assert [f["page"] for f in tman["failed_pages"]] == [7]
    assert json.loads((tmp_path / "t.json").read_text()) == tman
    # Resume: a second run reuses the manifest's rows and adds none.
    again = tingest.ingest_pages_dir(pages, "doc.pdf", DOC, tmp_path / "t.json", embedder=tx, store=tst)
    assert again["pages"] == tman["pages"] and tst.index.count == 6
    # The indexed records agree, apart from memory ids.
    strip = [{k: v for k, v in r.items() if k != "memory_id"} for r in tst.index.metadata]
    assert strip == [{k: v for k, v in r.items() if k != "memory_id"} for r in jst.index.metadata]


def test_ingest_deeply_nested_page_fails_alone(tmp_path, embedders):
    """A page JSON nested past the recursion limit is recorded in
    failed_pages with the reference's fields; the other pages are ingested."""
    pages = tmp_path / "pages"
    _write_pages(pages, prose_pages(6, 3))
    (pages / "page_002.json").write_text("[" * 200_000 + "]" * 200_000)
    jx, tx = embedders
    jst = jstore.IndexStore(tmp_path / "jidx", jx.dim, mode="single")
    tst = tstore.IndexStore(tmp_path / "tidx", tx.dim, mode="single", device="cpu")
    jman = jingest.ingest_pages_dir(pages, "doc.pdf", DOC, tmp_path / "j.json", embedder=jx, store=jst)
    tman = tingest.ingest_pages_dir(pages, "doc.pdf", DOC, tmp_path / "t.json", embedder=tx, store=tst)
    assert _without_ids(tman) == _without_ids(jman)
    assert [p["page"] for p in tman["pages"]] == [1, 3] and tst.index.count == 2
    assert [sorted(f) for f in tman["failed_pages"]] == [["error", "page"]]
    assert tman["failed_pages"][0]["page"] == 2
    assert tman["failed_pages"][0]["error"].startswith("Failed to parse JSON: ")


def test_answer_question_signature_equal():
    """The same parameters in the same order with the same defaults, so a
    caller of either package (the HTTP layer passes model=None) calls both."""
    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(tqa.answer_question) == params(jqa.answer_question)
    assert [name for name, *_ in params(tqa.answer_question)][4] == "model"


def test_answer_accepts_model_keyword(tmp_path, embedders, same_memory_ids):
    both = _ingest_both(tmp_path, prose_pages(7, 6), embedders)
    question = "What did the night shift reject?"
    got, want = _answers(both, embedders, question, engine="extractive", model=None)
    assert got == want and got["retrieved"]
    (jst, _), (tst, _) = both
    positional = tqa.answer_question(DOC, question, 8, 1500, None, None, tst, embedders[1], None,
                                     "extractive")
    assert positional == got


def test_answer_extractive_identical(tmp_path, embedders, same_memory_ids):
    both = _ingest_both(tmp_path, prose_pages(2, 12), embedders)
    for question in ("How many invoices did the billing service process?",
                     "What did the audit team review in section 4?"):
        got, want = _answers(both, embedders, question, engine="extractive", top_k=8)
        assert got == want
        assert len(got["retrieved"]) == 8 and got["answer_md"].startswith("Based on the retrieved pages")


def _agg_pages(seed):
    """Pages of one synthetic aggregation example (tests/test_aggregate.py's source)."""
    q, evidence, _teacher, facts = _synthetic_agg_qa_example(np.random.default_rng(seed))
    texts = []
    for section in evidence.split("\n\n---\n\n"):
        header, _, content = section.partition("\n")
        assert re.match(r"\[Page (\d+) \| memory_id=\S+\]", header)
        texts.append(content)
    return q, texts, facts


@pytest.mark.parametrize("seed", [99, 5])
def test_answer_analytic_identical(tmp_path, embedders, same_memory_ids, seed):
    question, texts, facts = _agg_pages(seed)
    both = _ingest_both(tmp_path, texts, embedders)
    got, want = _answers(both, embedders, question, engine="analytic")
    assert got == want
    assert str(facts["value"]) in got["answer_md"]


def test_not_found_on_empty_index_and_missing_doc(tmp_path, embedders, same_memory_ids):
    jx, tx = embedders
    empty_j = jstore.IndexStore(tmp_path / "je", jx.dim, mode="single")
    empty_t = tstore.IndexStore(tmp_path / "te", tx.dim, mode="single", device="cpu")
    got = tqa.answer_question(DOC, "Anything?", store=empty_t, embedder=tx, engine="extractive")
    want = jqa.answer_question(DOC, "Anything?", store=empty_j, embedder=jx, engine="extractive")
    assert got == want == {"answer_md": tqa.NOT_FOUND, "retrieved": []}
    (jst, _), (tst, _) = _ingest_both(tmp_path, prose_pages(3, 4), embedders)
    got = tqa.answer_question("other-doc", "Anything?", store=tst, embedder=tx, engine="extractive")
    want = jqa.answer_question("other-doc", "Anything?", store=jst, embedder=jx, engine="extractive")
    assert got == want == {"answer_md": tqa.NOT_FOUND, "retrieved": []}


def test_lm_without_a_runner_raises(tmp_path, embedders, same_memory_ids, monkeypatch):
    """Engine 'lm' with no runner loads the shipped answer model on the
    card, the entry points' default device; without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    monkeypatch.setattr(tqa, "_ANSWER_RUNNER_CACHE", {})
    both = _ingest_both(tmp_path, prose_pages(4, 3), embedders)
    with pytest.raises(RuntimeError, match="cuda"):
        tqa.answer_question(DOC, "What was stored?", store=both[1][0], embedder=embedders[1], engine="lm")


@pytest.fixture
def cpu_entry_points(monkeypatch):
    """The entry points' own runners on the CPU, built afresh."""
    monkeypatch.setattr(tconfig, "RUNTIME", dataclasses.replace(tconfig.RUNTIME, device="cpu"))
    monkeypatch.setattr(tqa, "_ANSWER_RUNNER_CACHE", {})


def test_answer_runner_is_the_shipped_ocr_bpe(cpu_entry_points):
    """Fault 1: in the repo tree the answer model resolves to the shipped
    ocr_bpe, and the port loads it with the checkpoint's weights."""
    runner = tqa._get_answer_runner()
    assert runner.cfg == tconfigs.get_preset("ocr_bpe") and tqa._get_answer_runner() is runner
    restored = ocp.StandardCheckpointer().restore(jckpt.latest_params(tconfig.shipped_checkpoint_dir("ocr_bpe")))
    state = runner.model.state_dict()
    for name, value in params_from_jax(restored).items():
        assert torch.equal(state[name], value), name


def test_default_engine_answers_with_the_shipped_ocr_bpe(tmp_path, embedders, same_memory_ids,
                                                        cpu_entry_points, monkeypatch):
    """Fault 1: answer_question with the default engine no longer raises; it
    answers through VLMRunner.answer of the shipped ocr_bpe."""
    both = _ingest_both(tmp_path, prose_pages(9, 6), embedders)
    calls = []
    answer = tvlm.VLMRunner.answer
    monkeypatch.setattr(tvlm.VLMRunner, "answer",
                        lambda self, *a, **k: calls.append(self.cfg) or answer(self, *a, max_new=16))
    # The engine's default, "auto" (tests/conftest.py sets "extractive" for every test).
    monkeypatch.setattr(tqa, "RUNTIME", dataclasses.replace(tqa.RUNTIME, answer_engine="auto"))
    got = tqa.answer_question(DOC, "What did the audit team review?", store=both[1][0], embedder=embedders[1])
    assert calls == [tconfigs.get_preset("ocr_bpe")]
    assert len(got["retrieved"]) == 6 and got["answer_md"].strip()


def test_shipped_ocr_bpe_answers_equal_in_f32(monkeypatch):
    """Both packages' load_runner on the shipped ocr_bpe, the config's dtype
    set to f32 on both sides: the same answer text over one evidence pack."""
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")

    def f32(cfg):
        return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                                   decoder=dataclasses.replace(cfg.decoder, dtype="float32"))

    ckpt = tconfig.shipped_checkpoint_dir("ocr_bpe")
    jr = jckpt.load_runner(f32(jconfigs.get_preset("ocr_bpe")), ckpt)
    tr = tckpt.load_runner(f32(tconfigs.get_preset("ocr_bpe")), ckpt, device="cpu")
    pack = "\n\n---\n\n".join(f"[Page {i} | memory_id=mem{i:06d}]\n{text}"
                                for i, text in enumerate(prose_pages(10, 4), 1))
    question = "What did the billing service process?"
    got = tr.answer(question, pack, max_new=40)
    assert got == jr.answer(question, pack, max_new=40) and got.strip()


@pytest.fixture(scope="module")
def answer_runners():
    jcfg, tcfg = mini_bpe_configs("float32")
    params = numpy_params(jcfg, seed=3)
    return jvlm.VLMRunner(jcfg, params=params), tvlm.VLMRunner(tcfg, params=params_from_jax(params), device="cpu")


def test_answer_lm_identical(tmp_path, embedders, same_memory_ids, answer_runners, monkeypatch):
    """f32 mini ocr_bpe: the same greedy answer tokens, so the same answer."""
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    jr, tr = answer_runners
    both = _ingest_both(tmp_path, prose_pages(5, 10), embedders)
    question = "How many units did plant delta ship?"
    got, want = _answers(both, embedders, question, engine="lm",
                         jax_runner=jr, port_runner=tr)
    assert got == want and len(got["retrieved"]) == 8

    # The tokens themselves, over the evidence pack the question retrieved.
    results = both[1][0].search(embedders[1].embed([question]), top_k=8, doc_id=DOC)[0]
    pack = tqa._build_evidence_pack(results, None, DOC, 1500)
    prompt, bound = tr.answer_prompt(question, pack)
    assert len(prompt) > 600  # the evidence fills the budget
    jtoks = np.asarray(jr._start_generate([prompt], jr._blank_vision(), bound, task="answer"))
    ttoks = tr.generate([prompt], tr._blank_vision(), bound, task="answer").numpy()
    np.testing.assert_array_equal(ttoks, jtoks)
    assert tr.answer(question, pack) == jr.answer(question, pack)


@pytest.mark.parametrize("kind", ["byte", "bpe"])
def test_answer_logit_mask_equal(kind):
    got = tvlm._task_logit_mask(ttok.get_tokenizer(kind), "answer")
    want = jvlm._task_logit_mask(jtok.get_tokenizer(kind), "answer")
    np.testing.assert_array_equal(got, want)
    assert got[ttok.EOS_ID] == 0 and got[ttok.SEP_ID] < 0
    with pytest.raises(ValueError):
        tvlm._task_logit_mask(ttok.get_tokenizer(kind), "nope")


def test_answer_first_logits_bf16(answer_runners, monkeypatch):
    """bf16 first-step answer logits over [blank page ; answer prompt]."""
    import torch

    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    params = answer_runners[0].params
    jcfg, tcfg = mini_bpe_configs("bfloat16")
    jr = jvlm.VLMRunner(jcfg, params=params)
    tr = tvlm.VLMRunner(tcfg, params=params_from_jax(params), device="cpu")
    prompt, _ = tr.answer_prompt("Which plant shipped the most units?", " ".join(prose_pages(6, 8)))
    vis_j = jr._blank_vision()
    ids, lens = tr.pad_prompts([prompt])
    kv_len = vis_j.shape[1] + lens[0]
    logits, _ = jr.model.apply(
        {"params": jr.params}, vis_j, jnp.asarray(ids.numpy(), jnp.int32),
        jnp.asarray([kv_len], jnp.int32), 1024, method=jvlm.OpticalVLM.prefill_mixed,
    )
    want = np.asarray(logits[:, kv_len - 1], np.float32)
    got, _, _ = tr.first_logits(ids, lens, tr._blank_vision(), 1024)
    got = got.to(torch.float32).numpy()
    assert np.isfinite(got).all() and got.shape == (1, 4096)
    np.testing.assert_allclose(got, want, atol=BF16_LOGITS_ATOL)


def test_rewrite_queries_equal(embedders):
    jx, tx = embedders
    for question in ("What did the audit team review?", "How many units were shipped by plant delta in total?",
                     "the of", "Cache"):
        assert tqa.rewrite_query(question) == jqa.rewrite_query(question)
        assert tqa.rewrite_query_learned(question, tx) == jqa.rewrite_query_learned(question, jx)


def test_answer_preset_resolution_equal(monkeypatch):
    assert tconfig.resolve_answer_preset() == jconfig.resolve_answer_preset()
    for preset in ("ocr_bpe", "ocr_real", "nope"):
        assert tconfig.shipped_meta(preset) == jconfig.shipped_meta(preset)
        assert tconfig.shipped_checkpoint_dir(preset) == jconfig.shipped_checkpoint_dir(preset)
    assert tqa.lm_answer_available() == jqa.lm_answer_available()


def test_page_vector_set_matches_jax(embedders):
    jx, tx = embedders
    content = prose_pages(7, 1, sentences=10)[0] + " Short one. And a final sentence without end"
    want_vecs, want_sents = jingest.page_vector_set(jx, content)
    got_vecs, got_sents = tingest.page_vector_set(tx, content)
    assert got_sents == want_sents and len(got_sents) == 7
    np.testing.assert_allclose(got_vecs, np.asarray(want_vecs), atol=1e-6, rtol=0)
