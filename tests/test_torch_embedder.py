"""The port's hashed n-gram embedder against the JAX package's: the
projection matrix bit for bit, the host featurization exactly, and the
embeddings of a small corpus within f32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_compression_project_tpu.models import embedder as jemb
from vision_compression_project_tpu_torch.models import embedder as temb
from vision_compression_project_tpu_torch.models.configs import EmbedderConfig

# Unit vectors from the same bf16 inputs and exact +-1 weights; only the
# order of the f32 sum over the nonzero buckets differs.
EMBED_ATOL = 1e-6

TEXTS = [
    "Quarterly revenue rose 12% to $4.2M (see Table 3).",
    "The cache module stores pages. It has 12 entries and evicts the oldest.",
    "",
    "Plant delta produced 300 units in total; plant gamma produced 120.",
    "Ünïcödé words, dashes — and 日本語 text mixed with ASCII words.",
    "one two three one two three one two three",
    "A single word",
    "Retrieval scores each page against the question and keeps the top eight.",
]


@pytest.fixture(scope="module")
def embedders():
    return jemb.HashNGramEmbedder(), temb.HashNGramEmbedder(device="cpu")


def _jax_signs(seed, shape):
    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed), shape, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", [(5, 7), (64, 33), (300, 512)])
def test_rademacher_bit_exact_small(seed, shape):
    got = temb.rademacher_signs(seed, shape)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got.astype(np.float32), _jax_signs(seed, shape))


def test_rademacher_bit_exact_full_matrix():
    cfg = EmbedderConfig()
    shape = (cfg.ngram_buckets, cfg.dim)
    np.testing.assert_array_equal(temb.rademacher_signs(0, shape).astype(np.float32), _jax_signs(0, shape))


def test_featurize_identical(embedders):
    jx, tx = embedders
    for text in TEXTS:
        np.testing.assert_array_equal(tx._featurize(text), jx._featurize(text))


def test_embed_matches_jax(embedders):
    jx, tx = embedders
    want = np.asarray(jx.embed(TEXTS))
    got = tx.embed(TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 512)
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)
    norms = np.linalg.norm(got, axis=1)
    assert norms[2] == 0.0  # the empty text has no n-grams
    np.testing.assert_allclose(np.delete(norms, 2), 1.0, atol=1e-6)


def test_get_embedder_backends():
    assert isinstance(temb.get_embedder("hash", device="cpu"), temb.HashNGramEmbedder)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        temb.get_embedder("neural", device="cpu")
    with pytest.raises(ValueError):
        temb.get_embedder("nope", device="cpu")
