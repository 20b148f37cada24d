"""The port's embedders against the JAX package's. The hashed n-gram
embedder: the projection matrix bit for bit, the host featurization exactly,
and the embeddings of a small corpus within f32 rounding. The neural
embedder: with the JAX embedder's flax parameters carried over by
`params_from_jax`, the same vectors in f32 and in bf16, on texts that include
an empty one, one longer than max_seq bytes and non-ASCII ones. The JAX side
runs its Pallas attention in interpret mode (every padded S is >= 128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.models import embedder as jemb
from vision_compression_project_tpu.models.configs import EmbedderConfig as JEmbedderConfig
from vision_compression_project_tpu_torch.models import embedder as temb
from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
from vision_compression_project_tpu_torch.weights import params_from_jax

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
    cfg = EmbedderConfig(dim=32, depth=1, heads=2, max_seq=128)
    neural = temb.get_embedder("neural", cfg, seed=3, device="cpu")
    assert isinstance(neural, temb.NeuralEmbedder) and neural.dim == 32 and neural.cfg is cfg
    assert neural.device.type == "cpu" and neural.embed(["a"]).shape == (1, 32)
    with pytest.raises(ValueError):
        temb.get_embedder("nope", device="cpu")


# -- the neural embedder ----------------------------------------------------------

# f32: the same arithmetic summed in another order (unit vectors). bf16: the
# two frameworks round to bf16 at other places; the reference's own limit for
# bf16 vectors that differ by padding (tests/test_models.py).
NEURAL_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMALL = dict(dim=64, depth=2, heads=2, max_seq=256)

NEURAL_TEXTS = TEXTS + [
    "x" * 40 + " longer than max_seq: " + "byte " * 60,
    "Ωmega ünïcödé — 日本語のテキスト and emoji 🙂 in one line.",
]


def _neural_pair(dtype, seed=0):
    """(JAX NeuralEmbedder at its flax init from `seed`, the port's with
    those parameters) in the small config."""
    jx = jemb.NeuralEmbedder(JEmbedderConfig(**SMALL, dtype=dtype), seed=seed)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jx.params))
    return jx, temb.NeuralEmbedder(EmbedderConfig(**SMALL, dtype=dtype), params=params, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neural_embed_matches_jax(dtype):
    jx, tx = _neural_pair(dtype)
    assert max(len(t.encode()) for t in NEURAL_TEXTS) > SMALL["max_seq"]
    want = np.asarray(jx.embed(NEURAL_TEXTS))
    got = tx.embed(NEURAL_TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(NEURAL_TEXTS), SMALL["dim"])
    np.testing.assert_allclose(got, want, atol=NEURAL_ATOL[dtype], rtol=0)
    norms = np.linalg.norm(got, axis=1)
    assert norms[2] == 0.0 and np.asarray(want)[2].tolist() == [0.0] * SMALL["dim"]  # "" embeds to zero
    np.testing.assert_allclose(np.delete(norms, 2), 1.0, atol=1e-5)


@pytest.mark.parametrize("texts", [["short question"], ["", ""], ["", "one", "two words here"],
                                   ["a" * 129, "b"], ["é" * 100]], ids=range(5))
def test_neural_padding_matches_jax(texts):
    """Each padded length the rule gives (8 for a batch of empty texts, 128,
    256) in f32, and a text embedded alone equals the same text in a batch."""
    jx, tx = _neural_pair("float32", seed=1)
    want = np.asarray(jx.embed(texts))
    got = tx.embed(texts)
    assert tx.padded_length(texts) == min(256, max(8, -(-max(len(t.encode()) for t in texts) // 128) * 128))
    np.testing.assert_allclose(got, want, atol=NEURAL_ATOL["float32"], rtol=0)
    for i, text in enumerate(texts):
        np.testing.assert_allclose(tx.embed([text])[0], got[i], atol=NEURAL_ATOL["float32"], rtol=0)


def test_neural_seeded_init():
    """params=None: the same seed gives the same weights and vectors, another
    seed others; the initializers' scales (N(0, 0.02) embeddings, unit norm
    scales, lecun-normal kernels)."""
    cfg = EmbedderConfig(**SMALL)
    a, b, c = (temb.NeuralEmbedder(cfg, seed=s, device="cpu") for s in (5, 5, 6))
    for (name, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.model.embed.weight, c.model.embed.weight)
    np.testing.assert_array_equal(a.embed(TEXTS), b.embed(TEXTS))
    sd = a.model.state_dict()
    assert abs(float(sd["embed.weight"].std()) - 0.02) < 2e-3 and abs(float(sd["pos_embed"].std()) - 0.02) < 2e-3
    assert all(float(v.min()) == float(v.max()) == 1.0 for k, v in sd.items() if k.endswith("scale"))
    w = sd["blocks.0.mlp.down.weight"]  # fan_in 4 * dim
    assert abs(float(w.std()) * np.sqrt(4 * SMALL["dim"]) - 1.0) < 0.05
    assert set(sd) == set(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jemb.NeuralEmbedder(JEmbedderConfig(**SMALL), seed=0).params)))

