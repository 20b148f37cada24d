"""The port's training data (train/data.py, train/corpus.py) against the JAX
package's on the same seeds: page bytes and token ids of `synthetic_batches`
for every kind and option, the corpus's page generators, the harvested
sentence pool, `device_batch`'s tensors, and
`prefetch_batches`, which hands a generator's error to the consumer.

Tolerance: none except for patch tokens; pages, token ids, texts and
sentence pools are compared exactly. Patch tokens: bf16 of the same f32
preprocessing, at most one bf16 step apart (atol 1/64 on values in [-1, 1]),
as tests/test_torch_slice.py holds them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.train import corpus as jcorpus
from vision_compression_project_tpu.train import data as jdata
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.train import corpus as tcorpus
from vision_compression_project_tpu_torch.train import data as tdata

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


@pytest.fixture
def small_harvest(monkeypatch):
    """Both corpora on the same small sentence pool, so jumble and real pages
    need no harvest of the installed packages."""
    rng = np.random.default_rng(0)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel", "india", "juliet"]
    pool = [" ".join(rng.choice(words, size=int(rng.integers(5, 12)))).capitalize() + "." for _ in range(300)]
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {"_all": list(pool)})
    return pool


def _tiny():
    return jconfigs.get_preset("tiny"), tconfigs.get_preset("tiny")


@pytest.mark.parametrize(
    "kw",
    [
        dict(kind="words"),
        dict(kind="words_easy"),
        dict(kind="codes", code_groups=2, code_digits=4),
        dict(kind="codes_easy"),
        dict(kind="real"),
        dict(kind="real", jumble_frac=0.5),
        dict(kind="jumble", vocab_cap=8),
        dict(kind="jumble", jumble_plain=True),
        dict(kind="real", jumble_frac=0.5, fonts=["builtin", "dejavu_sans"]),
        dict(kind="words", fonts=["builtin", "dejavu_sans"]),
    ],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_synthetic_batches_equal_jax(small_harvest, tmp_path, kw):
    if "fonts" in kw and not os.path.exists(DEJAVU):
        pytest.skip("DejaVu Sans is not installed")
    jcfg, tcfg = _tiny()
    common = dict(text_len=200, dpi=40, seed=3, font_size=14, lines=8)
    got = tdata.synthetic_batches(tcfg, 3, workdir=tmp_path / "port", **common, **kw)
    want = jdata.synthetic_batches(jcfg, 3, workdir=tmp_path / "jax", **common, **kw)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g["pages_u8"].dtype == np.uint8 and g["pages_u8"].shape == w["pages_u8"].shape
        assert np.array_equal(g["pages_u8"], w["pages_u8"])
        assert g["token_ids"].dtype == w["token_ids"].dtype
        assert np.array_equal(g["token_ids"], w["token_ids"])


def test_text_len_is_cut_to_the_context():
    """max_seq - tokens_out - 1: ocr_real's 2048 - 1024 - 1 = 1023."""
    _, tcfg = _tiny()
    batch = next(tdata.synthetic_batches(tcfg, 1, text_len=4096, dpi=30, lines=2))
    assert batch["token_ids"].shape == (1, tcfg.decoder.max_seq - tcfg.vision.tokens_out - 1)


def test_target_tokens_and_page_texts_equal_jax():
    tok = tdata.get_tokenizer(tconfigs.get_preset("ocr_real"))
    from vision_compression_project_tpu.models.tokenizer import get_tokenizer as jget_tokenizer

    jtok = jget_tokenizer(jconfigs.get_preset("ocr_real"))
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for gen in ("synthetic_page_text", "synthetic_code_page"):
            t1, t2 = getattr(tdata, gen)(r1), getattr(jdata, gen)(r2)
            assert t1 == t2
            for max_len in (16, 600):
                assert np.array_equal(tdata.target_tokens(t1, seed + 1, max_len, tok=tok),
                                      jdata.target_tokens(t2, seed + 1, max_len, tok=jtok))


@pytest.mark.parametrize("font", ["builtin", "dejavu_serif"])
def test_corpus_pages_equal_jax(small_harvest, font):
    if font != "builtin" and not os.path.exists("/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"):
        pytest.skip("DejaVu Serif is not installed")
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        assert tcorpus.real_page_text(r1, lines=20, font=font) == jcorpus.real_page_text(r2, lines=20, font=font)
        for cap, plain in ((0, False), (16, True)):
            assert (tcorpus.jumble_page_text(r1, lines=12, font=font, vocab_cap=cap, plain=plain)
                    == jcorpus.jumble_page_text(r2, lines=12, font=font, vocab_cap=cap, plain=plain))
    assert tcorpus.corpus_sentences("heldout") == jcorpus.corpus_sentences("heldout")
    assert tcorpus.capped_vocabulary(5) == jcorpus.capped_vocabulary(5)


def test_harvest_equals_jax():
    """Both packages harvest the same sentences from the installed packages:
    the port reads the interpreter's site-packages, the directory the
    reference names in its source."""
    assert tcorpus._harvest() == jcorpus._harvest()


def test_device_batch_equals_jax():
    jcfg, tcfg = jconfigs.get_preset("ocr_bpe"), tconfigs.get_preset("ocr_bpe")
    rng = np.random.default_rng(2)
    pages = rng.integers(0, 256, size=(2, 300, 231), dtype=np.uint8)
    host = {"pages_u8": np.repeat(pages[..., None], 3, axis=-1),
            "token_ids": rng.integers(0, 4096, size=(2, 20)).astype(np.int32)}
    got = tdata.device_batch(tcfg, host, device="cpu")
    want = jdata.device_batch(jcfg, host)
    assert got["patch_tokens"].dtype == torch.bfloat16
    assert tuple(got["patch_tokens"].shape) == want["patch_tokens"].shape
    np.testing.assert_allclose(got["patch_tokens"].float().numpy(),
                               np.asarray(want["patch_tokens"].astype(jnp.float32)), atol=1 / 64, rtol=0)
    assert np.array_equal(got["token_ids"].numpy(), np.asarray(want["token_ids"]))
    assert np.array_equal(got["loss_mask"].numpy(), np.asarray(want["loss_mask"]))
    host["loss_mask"] = (rng.random((2, 20)) < 0.5).astype(np.int32)
    assert np.array_equal(tdata.device_batch(tcfg, host, device="cpu")["loss_mask"].numpy(), host["loss_mask"])


def test_prefetch_batches_keeps_order_and_raises_the_generators_error():
    def gen():
        yield {"i": 0}
        yield {"i": 1}
        raise ValueError("page synthesis failed")

    it = tdata.prefetch_batches(gen(), depth=2)
    assert next(it) == {"i": 0} and next(it) == {"i": 1}
    with pytest.raises(ValueError, match="page synthesis failed"):
        next(it)
    assert [b["i"] for b in tdata.prefetch_batches(iter([{"i": k} for k in range(5)]), depth=1)] == list(range(5))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown data kind"):
        next(tdata.synthetic_batches(tconfigs.get_preset("tiny"), 1, kind="scans"))
