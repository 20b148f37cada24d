"""The port's BPE training (`models/tokenizer.py::BPETokenizer.train`,
`scripts/train_bpe.py`) against the JAX package's tokenizer and the
repository's scripts/train_bpe.py: the same corpus lists (mixed, with and
without golden pages, and real), the same merges on the same texts, and a
command line that writes its merges only where --out says."""

import json

import numpy as np
import pytest

from vision_compression_project_tpu.models.tokenizer import BPETokenizer as JBPETokenizer
from vision_compression_project_tpu.models.tokenizer import DEFAULT_MERGES_PATH as JAX_MERGES
from vision_compression_project_tpu.train import corpus as jcorpus
from vision_compression_project_tpu_torch.models import tokenizer as ttok
from vision_compression_project_tpu_torch.scripts import train_bpe
from vision_compression_project_tpu_torch.train import corpus as tcorpus

from torch_parity import jax_script

PAGES = 40
VOCAB = 400


@pytest.fixture(scope="module")
def jax_train_bpe():
    return jax_script("train_bpe")


@pytest.fixture
def golden(tmp_path, monkeypatch, jax_train_bpe):
    """A golden-pages directory both scripts read (absent until a test
    writes into it)."""
    pages = tmp_path / "golden_pages"
    monkeypatch.setattr(jax_train_bpe, "GOLDEN_PAGES", pages)
    monkeypatch.setenv("VCP_GOLDEN_PAGES", str(pages))
    return pages


def test_mixed_corpus_equal_to_the_jax_script(golden, jax_train_bpe):
    assert not golden.exists()
    want = jax_train_bpe.build_corpus(n_pages=PAGES)
    got = train_bpe.build_corpus(n_pages=PAGES)
    assert len(got) == len(want) and got == want


def test_mixed_corpus_with_golden_pages_equal_to_the_jax_script(golden, jax_train_bpe):
    golden.mkdir()
    (golden / "page_001.json").write_text(json.dumps({"markdown": "# Golden one\nText.", "summary": "One."}))
    (golden / "page_002.json").write_text(json.dumps({"markdown": "Second page", "summary": None}))
    (golden / "page_003.json").write_text("{not json")
    want = jax_train_bpe.build_corpus(n_pages=8)
    got = train_bpe.build_corpus(n_pages=8)
    assert got == want
    assert "# Golden one\nText." in got and "Second page" in got


def test_real_corpus_equal_to_the_jax_script(monkeypatch, jax_train_bpe):
    """build_real_corpus over one small sentence pool given to both corpus
    modules (the harvest of the docs is tested in test_torch_train_data)."""
    rng = np.random.default_rng(0)
    words = ["north", "ledger", "valve", "quarterly", "audit", "signal", "harbor", "sample", "review", "margin"]
    pool = [" ".join(rng.choice(words, size=int(rng.integers(5, 12)))).capitalize() + "." for _ in range(400)]
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {"_all": list(pool)})
    want = jax_train_bpe.build_real_corpus(n_pages=20)
    got = train_bpe.build_real_corpus(n_pages=20)
    assert len(got) > 20 and got == want


def test_merges_equal_the_jax_tokenizer(golden):
    texts = train_bpe.build_corpus(n_pages=PAGES)
    want = JBPETokenizer.train(texts, vocab_size=VOCAB)
    got = ttok.BPETokenizer.train(texts, vocab_size=VOCAB)
    assert len(got.merges) == VOCAB - ttok.FIRST_MERGE_ID
    assert got.merges == want.merges and got.vocab_size == want.vocab_size
    sample = texts[3]
    assert got.encode(sample) == want.encode(sample) and got.decode(got.encode(sample)) == sample


def test_command_line_writes_only_to_out(golden, tmp_path, capsys):
    """--out takes the merges; neither package's merges file changes, and
    the default --out is the port's own file."""
    before = {p: p.read_bytes() for p in (JAX_MERGES, ttok.DEFAULT_MERGES_PATH)}
    out = tmp_path / "out" / "merges.json"
    out.parent.mkdir()
    assert train_bpe.main(["--pages", str(PAGES), "--vocab_size", str(VOCAB), "--out", str(out)]) == 0
    assert sorted(p.name for p in out.parent.iterdir()) == ["merges.json"]
    merges = json.loads(out.read_text())["merges"]
    want = JBPETokenizer.train(train_bpe.build_corpus(n_pages=PAGES), vocab_size=VOCAB).merges
    assert [tuple(m) for m in merges] == want
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("corpus: ") and lines[1] == f"trained {len(want)} merges -> vocab 512"
    assert lines[2] == f"saved: {out}" and lines[3].startswith("sample compression: ")
    assert {p: p.read_bytes() for p in before} == before
    default_out = train_bpe.parse_args([]).out
    assert default_out == str(ttok.DEFAULT_MERGES_PATH) != str(JAX_MERGES)
    assert default_out.endswith("vision_compression_project_tpu_torch/models/bpe_merges.json")
