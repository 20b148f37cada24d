"""The port's masked similarity and top-k (ops/topk.py) against the JAX
package's, whose Pallas kernel runs in interpret mode on the CPU. On a CPU
tensor the port runs the kernel's plain version; the kernel itself is held
against it on the card (chip_smoke.py, tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.ops import topk as jtopk
from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.ops import topk as ttopk

# Unit vectors on both sides, f32 sums of 512 products in another order:
# scores of magnitude <= 1 agree to a few f32 ulps.
ATOL = 1e-5


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed, n, d, b):
    rng = np.random.default_rng(seed)
    emb, q = _unit(rng, (n, d)), _unit(rng, (b, d))
    mask = (rng.uniform(size=n) > 0.5).astype(np.float32)
    return emb, q, mask


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("b", [1, 3])
def test_masked_similarity_matches_jax_kernel(n, b):
    emb, q, mask = _inputs(n + b, n, 512, b)
    want = np.asarray(jtopk.masked_similarity(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(mask)))
    before = dict(kernels.launches)
    got = ttopk.masked_similarity(torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask))
    assert kernels.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32 and got.shape == (b, n)
    got = got.numpy()
    off = mask <= 0
    assert (got[:, off] == ttopk.NEG_INF).all() and (want[:, off] == np.float32(-1e30)).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_masked_similarity_ragged_matches_reference():
    emb, q, mask = _inputs(5, 1000, 512, 3)
    got = ttopk.masked_similarity(torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask))
    want = jtopk.masked_similarity_reference(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    plain = ttopk.masked_similarity_reference(
        torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask)
    )
    assert torch.equal(got, plain)


def test_masked_similarity_bf16_rows():
    emb, q, mask = _inputs(6, 1000, 512, 2)
    emb16 = jnp.asarray(emb, jnp.bfloat16)
    want = np.asarray(jtopk.masked_similarity(emb16, jnp.asarray(q), jnp.asarray(mask)))
    got = ttopk.masked_similarity(
        torch.from_numpy(emb).to(torch.bfloat16), torch.from_numpy(q), torch.from_numpy(mask)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 8, 37])
def test_cosine_topk_matches_jax(k):
    emb, q, mask = _inputs(7 + k, 2048, 512, 3)
    jv, ji = jtopk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(mask), k)
    tv, ti = ttopk.cosine_topk(torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask), k)
    # Random unit rows: the top scores are distinct, so the indices agree exactly.
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def _tied_scores(seed, b, n):
    """Scores with many exact ties: a few levels, +0.0 and -0.0 among them,
    and the mask's -1e30 filler."""
    rng = np.random.default_rng(seed)
    levels = np.array([0.5, 0.25, 0.0, -0.0, -0.25, -1e30], np.float32)
    return levels[rng.integers(0, len(levels), (b, n))]


@pytest.mark.parametrize("k", [1, 5, 8, 40, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_ties_ordered_as_lax_top_k(seed, k):
    """Equal scores come lowest row first, the lowest rows are kept among
    those tied at the k-th score, and +0.0 ranks above -0.0: lax.top_k's
    order, index for index. torch.topk orders ties arbitrarily."""
    import jax

    scores = _tied_scores(seed, 3, 200)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    tv, ti = ttopk.topk_lowest_first(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_cosine_topk_ties_match_jax():
    """Zero rows (blank pages embed to zero) tie at score 0: the JAX
    package's cosine_topk and the port's give the same rows in the same order."""
    rng = np.random.default_rng(11)
    emb = np.zeros((64, 512), np.float32)
    emb[[3, 17, 40]] = _unit(rng, (3, 512))
    q = np.concatenate([emb[3:4], _unit(rng, (1, 512))])
    mask = np.ones(64, np.float32)
    mask[[5, 9]] = 0
    jv, ji = jtopk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(mask), 12)
    tv, ti = ttopk.cosine_topk(torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
