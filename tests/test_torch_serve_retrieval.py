"""The port's HTTP server against the JAX package's, request by request, in
the two retrieval settings beside the default one: multi-vector MaxSim
retrieval (VCP_RETRIEVAL=multi, with the hash embedder) and the neural
embedder (VCP_EMBED_BACKEND=neural, single mode). tests/test_torch_serve.py
covers the default settings; this file sends the requests whose answers
depend on retrieval, with that file's comparison: statuses, headers other
than Date, and body bytes equal, each server's temporary root masked.

Each pair of servers gets its settings as the running service does, through
its state's embedder and store. The neural embedder is a small f32 one (dim
64, depth 2, heads 2, max_seq 256), the JAX side at its flax init and the
port with those parameters carried over by `params_from_jax`; the JAX side
runs its Pallas attention in interpret mode. Pages are read by the text
engine and answered by the extractive engine (tests/conftest.py), so no
other model runs. A last test checks that the environment variables
themselves select these settings in the port's service.
"""

import dataclasses
import itertools
import threading

import jax
import numpy as np
import pytest

from vision_compression_project_tpu.index import IndexStore as JIndexStore
from vision_compression_project_tpu.index import multivector as jmv
from vision_compression_project_tpu.index import vector_index as jvi
from vision_compression_project_tpu.models import EmbedderConfig as JEmbedderConfig
from vision_compression_project_tpu.models import HashNGramEmbedder as JHashNGramEmbedder
from vision_compression_project_tpu.models import NeuralEmbedder as JNeuralEmbedder
from vision_compression_project_tpu.raster import make_pdf
from vision_compression_project_tpu.serve import httpd as jhttpd
from vision_compression_project_tpu.utils import metrics as jmetrics
from vision_compression_project_tpu_torch import config as tconfig
from vision_compression_project_tpu_torch.index import IndexStore, MultiVectorIndex
from vision_compression_project_tpu_torch.index import multivector as tmv
from vision_compression_project_tpu_torch.index import store as tstore
from vision_compression_project_tpu_torch.index import vector_index as tvi
from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
from vision_compression_project_tpu_torch.models.embedder import HashNGramEmbedder, NeuralEmbedder
from vision_compression_project_tpu_torch.pipeline import ingest as tingest
from vision_compression_project_tpu_torch.serve import httpd as thttpd
from vision_compression_project_tpu_torch.utils import metrics as tmetrics
from vision_compression_project_tpu_torch.weights import params_from_jax

from test_torch_serve import _FakeClock, _browser_multipart, _json, _multipart, _same, _same_artifacts

NEURAL = dict(dim=64, depth=2, heads=2, max_seq=256, dtype="float32")
PAGES = [
    "Solar Energy Report\nSolar panels convert sunlight into electricity.\n"
    "Panel efficiency reached 22 percent in the field trial.",
    "Wind Power\nWind turbines generate power from moving air.\n"
    "The offshore farm added 40 turbines during the year.",
    "Storage\nBatteries store renewable energy for the night.\n"
    "Grid operators dispatch stored power at the evening peak.",
    "Blank section follows.",
]
QUESTIONS = ("How do solar panels work?", "What moves the turbines?", "How is energy stored for the night?",
             "What happened at the evening peak?", "efficiency", "?")


def _embedders_and_stores(setting, tmp):
    """((JAX embedder, JAX store), (port embedder, port store)) of a setting."""
    if setting == "multi":
        cfg = dict(dim=128, ngram_buckets=2048)
        jx, tx = JHashNGramEmbedder(JEmbedderConfig(**cfg)), HashNGramEmbedder(EmbedderConfig(**cfg), device="cpu")
        mode = "multi"
    else:
        jx = JNeuralEmbedder(JEmbedderConfig(**NEURAL), seed=0)
        tx = NeuralEmbedder(EmbedderConfig(**NEURAL), params=params_from_jax(
            jax.tree_util.tree_map(np.asarray, jx.params)), device="cpu")
        mode = "single"
    return ((jx, JIndexStore(tmp / "j" / "index", dim=jx.dim, mode=mode)),
            (tx, IndexStore(tmp / "t" / "index", dim=tx.dim, mode=mode, device="cpu")))


@pytest.fixture(scope="module", params=["multi", "neural"])
def servers(request, tmp_path_factory):
    """{"jax": (host, port, base_tmp), "port": ...} in one setting."""
    tmp = tmp_path_factory.mktemp(f"serve_{request.param}")
    (jx, jst), (tx, tst) = _embedders_and_stores(request.param, tmp)
    out, started = {}, []
    with pytest.MonkeyPatch.context() as mp:
        for httpd_mod, id_mods in ((jhttpd, (jvi, jmv)), (thttpd, (tvi, tmv))):
            doc_ids, mem_ids = itertools.count(), itertools.count()
            mp.setattr(httpd_mod, "generate_doc_id", lambda c=doc_ids: f"20240101_000000_{next(c):06d}")
            for module in id_mods:
                mp.setattr(module, "_new_memory_id", lambda c=mem_ids: f"mem{next(c):019d}")
        for name, mod, emb, store in (("jax", jhttpd, jx, jst), ("port", thttpd, tx, tst)):
            base = tmp / name[0] / "tmp"
            srv = mod.create_server(host="127.0.0.1", port=0, base_tmp=base)
            srv.vcp_state._embedder, srv.vcp_state._store = emb, store
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            started.append(srv)
            out[name] = ("127.0.0.1", srv.server_address[1], base)
        out["setting"], out["port_store"] = request.param, tst
        yield out
        for srv in started:
            srv.shutdown()
            srv.server_close()


@pytest.fixture(scope="module")
def pdf_bytes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pdfs_retrieval")
    return {"doc": make_pdf(PAGES, tmp / "doc.pdf").read_bytes(),
            "compat": make_pdf(["First page about optical compression.", "Second page about indexes."],
                               tmp / "b.pdf").read_bytes()}


@pytest.fixture(scope="module")
def ingested(servers, pdf_bytes):
    body, headers = _multipart("doc.pdf", pdf_bytes["doc"], fields={"dpi": "72"})
    status, ingest = _same(servers, "POST", "/ingest", body, headers)
    assert status == 200 and ingest["pages_ingested"] == len(PAGES) and ingest["failed_pages"] == []
    _same_artifacts(servers, ingest["doc_id"])
    return ingest["doc_id"]


def test_ingest_stores_the_setting(servers, ingested):
    """The upload reached the port's store in its setting."""
    store = servers["port_store"]
    if servers["setting"] == "multi":
        assert isinstance(store.index, MultiVectorIndex)
        assert all("sentences" in rec for rec in store.index.metadata)
    else:
        assert store.mode == "single" and store.index.count >= len(PAGES)


@pytest.mark.parametrize("question", QUESTIONS)
@pytest.mark.parametrize("top_k", [1, 3, 8])
def test_chat_equal(servers, ingested, question, top_k):
    status, chat = _same(servers, "POST", "/chat", *_json({"doc_id": ingested, "question": question,
                                                           "top_k": top_k, "max_chars_per_page": 200}))
    assert status == 200 and len(chat["retrieved"]) == min(top_k, len(PAGES))


def test_chat_unknown_doc(servers):
    status, body = _same(servers, "POST", "/chat", *_json({"doc_id": "missing_doc", "question": "hi"}))
    assert status == 200 and body == {"doc_id": "missing_doc", "answer_md": "Not found in provided pages.",
                                      "retrieved": []}


def test_ingest_chat_roundtrip(servers, pdf_bytes):
    """The UI's upload (only 'file', so dpi 150) and its chat body."""
    status, ingest = _same(servers, "POST", "/ingest", *_browser_multipart("mydoc.pdf", pdf_bytes["compat"]))
    assert status == 200 and ingest["pages_total"] == 2
    _same_artifacts(servers, ingest["doc_id"])
    payload = {"doc_id": ingest["doc_id"], "question": "What is this about?", "top_k": 8,
               "max_chars_per_page": 1500}
    status, chat = _same(servers, "POST", "/chat", *_json(payload, origin=True))
    assert status == 200 and chat["retrieved"]


def test_metrics_endpoint(servers, pdf_bytes, monkeypatch):
    for module in (jmetrics, tmetrics):
        monkeypatch.setattr(module, "time", _FakeClock())
        module.METRICS.reset()
        monkeypatch.setattr(module.METRICS, "_started", 0.0)
    body, headers = _multipart("doc.pdf", pdf_bytes["doc"], fields={"dpi": "72", "start_page": "2"})
    status, ingest = _same(servers, "POST", "/ingest", body, headers)
    assert status == 200 and ingest["pages_ingested"] == len(PAGES) - 1
    _same(servers, "POST", "/chat", *_json({"doc_id": ingest["doc_id"], "question": "What moves the turbines?"}))
    status, metrics = _same(servers, "GET", "/metrics")
    assert status == 200 and metrics["counters"] == {"extract.pages": 3.0, "ingest.pages": 3.0, "qa.queries": 1.0}


@pytest.mark.parametrize("retrieval,backend", [("multi", "hash"), ("single", "neural"), ("multi", "neural")])
def test_environment_selects_the_setting(tmp_path, monkeypatch, retrieval, backend):
    """VCP_RETRIEVAL and VCP_EMBED_BACKEND, read into RUNTIME, give the
    service's state a store of that mode and an embedder of that backend."""
    runtime = dataclasses.replace(tconfig.RUNTIME, retrieval_mode=retrieval, embed_backend=backend,
                                  embed_dim=32, index_root=str(tmp_path / "index"), device="cpu")
    monkeypatch.setattr(tconfig, "RUNTIME", runtime)
    monkeypatch.setattr(tstore, "_default_store", None)
    tingest._get_embedder.cache_clear()
    try:
        state = thttpd.ServiceState(base_tmp=tmp_path / "tmp")
        embedder_cls = NeuralEmbedder if backend == "neural" else HashNGramEmbedder
        assert isinstance(state.embedder, embedder_cls) and state.embedder.dim == 32
        assert state.store.mode == retrieval and state.store.index.dim == 32
        assert isinstance(state.store.index, MultiVectorIndex) == (retrieval == "multi")
    finally:
        tingest._get_embedder.cache_clear()
