"""The port's answer-task data (train/data.py: the QA example generators and
qa_batches) and the golden corpus split (train/corpus.py) against the JAX
package's on the same seeds.

Tolerance: none. Questions, evidence packs, teacher answers, facts,
token_ids, loss_mask and pages_u8 are compared exactly, and so is the next
draw of the generator after an example (the port makes the same numpy draws
in the same order). Both corpora read the same small sentence pool, so no
case harvests the installed packages.
"""

import numpy as np
import pytest

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.train import corpus as jcorpus
from vision_compression_project_tpu.train import data as jdata
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.train import corpus as tcorpus
from vision_compression_project_tpu_torch.train import data as tdata

SEEDS = [0, 1, 23]


@pytest.fixture
def small_pool(monkeypatch):
    """Both corpora on one seeded pool of 400 sentences (some over the
    evidence packs' 120-character limit)."""
    rng = np.random.default_rng(0)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel", "india", "juliet",
             "kilometre", "lighthouse", "mountains", "november"]
    pool = [" ".join(rng.choice(words, size=int(rng.integers(4, 24)))).capitalize() + "." for _ in range(400)]
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {"_all": list(pool)})
    return pool


def _both(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _next_draw(rng):
    return int(rng.integers(0, 2**31))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pool_split", [None, "train", "heldout"])
def test_qa_example_equals_jax(small_pool, seed, pool_split):
    pool = None if pool_split is None else tdata.qa_sentence_pool(pool_split)
    if pool_split is not None:
        assert pool == jdata.qa_sentence_pool(pool_split) and pool
    got_rng, want_rng = _both(seed)
    for _ in range(3):
        assert tdata._synthetic_qa_example(got_rng, sentence_pool=pool) == jdata._synthetic_qa_example(
            want_rng, sentence_pool=pool)
    assert _next_draw(got_rng) == _next_draw(want_rng)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_pool", [False, True], ids=["words", "pool"])
def test_agg_example_equals_jax(small_pool, seed, with_pool):
    pool = tdata.qa_sentence_pool("train") if with_pool else None
    got_rng, want_rng = _both(seed)
    for _ in range(4):
        got = tdata._synthetic_agg_qa_example(got_rng, sentence_pool=pool)
        want = jdata._synthetic_agg_qa_example(want_rng, sentence_pool=pool)
        assert got[:3] == want[:3]
        assert got[3] == want[3] and {k: type(v) for k, v in got[3].items()} == {
            k: type(v) for k, v in want[3].items()}
    assert _next_draw(got_rng) == _next_draw(want_rng)


@pytest.mark.parametrize("preset", ["tiny", "ocr_bpe"])
@pytest.mark.parametrize("agg_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("data_kind", ["words", "real", "mixed"])
def test_qa_batches_equal_jax(small_pool, preset, agg_frac, data_kind):
    """The first two batches: a blank page per row, token ids, and a loss
    mask over the answer span only."""
    got = tdata.qa_batches(tconfigs.get_preset(preset), 4, text_len=320, seed=5, agg_frac=agg_frac,
                           data_kind=data_kind)
    want = jdata.qa_batches(jconfigs.get_preset(preset), 4, text_len=320, seed=5, agg_frac=agg_frac,
                            data_kind=data_kind)
    for _ in range(2):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["loss_mask", "pages_u8", "token_ids"]
        for key in g:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            assert np.array_equal(g[key], w[key]), key
        assert g["pages_u8"].shape == (4, 64, 64, 3) and int(g["pages_u8"].min()) == 255
        assert bool(g["loss_mask"].any(axis=1).all())


def test_qa_batches_cut_text_len_to_the_context(small_pool):
    """ocr_bpe: max_seq 1024 - 256 vision tokens - 1 = 767."""
    batch = next(tdata.qa_batches(tconfigs.get_preset("ocr_bpe"), 1, text_len=4096))
    assert batch["token_ids"].shape == (1, 767)


GOLDEN_MD = """# Golden Report

The audit team reviewed every invoice in the third quarter. Short.
The night shift rejected twelve defect reports after the inspection.

- The billing service processed the remaining requests on time.
- The billing service processed the remaining requests on time.

Results were stored in the archive! Were the totals correct? They were checked twice.
"""


@pytest.mark.parametrize("fetch", ["golden_sentences", "corpus_sentences"])
def test_golden_split_equals_jax(tmp_path, monkeypatch, fetch):
    path = tmp_path / "combined.md"
    path.write_text(GOLDEN_MD)
    monkeypatch.setenv("VCP_GOLDEN_MD", str(path))
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {})
    if fetch == "golden_sentences":
        got, want = tcorpus.golden_sentences(), jcorpus.golden_sentences()
    else:
        got, want = tcorpus.corpus_sentences("golden"), jcorpus.corpus_sentences("golden")
    assert got == want and len(got) >= 4
    assert tcorpus.GOLDEN_MD_ENV == jcorpus.GOLDEN_MD_ENV == "VCP_GOLDEN_MD"


def test_golden_split_raises_without_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("VCP_GOLDEN_MD", str(tmp_path / "missing.md"))
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {})
    messages = []
    for module in (tcorpus, jcorpus):
        with pytest.raises(FileNotFoundError) as err:
            module.corpus_sentences("golden")
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "VCP_GOLDEN_MD" in messages[0]
