"""The whole page-extraction slice of the PyTorch port against the JAX package,
on a mini ocr_real (same structure, narrow widths), with the JAX package's
parameters carried across by `params_from_jax`.

The JAX side runs its XLA attention (VCP_FORCE_XLA_ATTENTION=1); the port runs
on the CPU, where attention takes the kernel's plain version.
"""

import numpy as np
import pytest

from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.weights import params_from_jax

from torch_parity import mini_configs, numpy_params

MAX_NEW = 24
PAGE_NUMBERS = [3, 4]

# bf16 first-step logits: both sides round activations to bf16 after every
# matmul and elementwise op, but not at the same places (XLA fuses
# elementwise chains in f32); over 4 blocks that leaves a few bf16 ulps of
# logits whose scale is ~1.
BF16_LOGITS_ATOL = 5e-2


def pages():
    rng = np.random.default_rng(11)
    pg = np.full((2, 300, 232), 255, np.uint8)
    pg[:, 40:260:12, 20:210] = rng.integers(0, 120, (2, 19, 190), dtype=np.uint8)
    return pg


@pytest.fixture(scope="module")
def runners_f32():
    jcfg, tcfg = mini_configs("float32")
    params = numpy_params(jcfg, seed=0)
    jr = jvlm.VLMRunner(jcfg, params=params)
    tr = tvlm.VLMRunner(tcfg, params=params_from_jax(params), device="cpu")
    return jr, tr


def test_slice_f32_tokens_and_pages_identical(runners_f32, monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    jr, tr = runners_f32
    pg = pages()
    jhandle = jr.extract_batch_async(pg, PAGE_NUMBERS, max_new=MAX_NEW)
    jtoks = np.asarray(jhandle[0])
    want = jr.collect_extract(jhandle)

    tvis = tr.encode(tr.preprocess_patches(pg))
    ttoks = tr.generate([[tvlm.BOS_ID, tvlm.TASK_EXTRACT_ID]] * 2, tvis, MAX_NEW)
    np.testing.assert_array_equal(ttoks.numpy(), jtoks)
    got = tr.extract_batch(pg, PAGE_NUMBERS, max_new=MAX_NEW)
    assert got == want
    assert [p["page_number"] for p in got] == PAGE_NUMBERS
    assert all(set(p) == {"page_number", "markdown", "entities", "summary"} for p in got)


def _jax_first_logits(jr, pg, monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    vis = jr._encode(jr.params, jr.preprocess_patches(pg))
    ids = np.full((pg.shape[0], 64), jvlm.PAD_ID, np.int32)
    ids[:, :2] = [jvlm.BOS_ID, jvlm.TASK_EXTRACT_ID]
    kv_len = jnp.full((pg.shape[0],), vis.shape[1] + 2, jnp.int32)
    logits, _ = jr.model.apply(
        {"params": jr.params}, vis, jnp.asarray(ids), kv_len, 256,
        method=jvlm.OpticalVLM.prefill_mixed,
    )
    return np.asarray(logits[:, vis.shape[1] + 1], np.float32)


def _torch_first_logits(tr, pg):
    vis = tr.encode(tr.preprocess_patches(pg))
    ids, lens = tr.pad_prompts([[tvlm.BOS_ID, tvlm.TASK_EXTRACT_ID]] * pg.shape[0])
    logits, _, _ = tr.first_logits(ids, lens, vis, 256)
    return logits.float().numpy()


def test_slice_f32_first_logits(runners_f32, monkeypatch):
    """f32 first-step logits agree to 1e-4 (f32 sums in another order)."""
    jr, tr = runners_f32
    pg = pages()
    np.testing.assert_allclose(
        _torch_first_logits(tr, pg), _jax_first_logits(jr, pg, monkeypatch), atol=1e-4
    )


def test_slice_bf16_first_logits(runners_f32, monkeypatch):
    jcfg, tcfg = mini_configs("bfloat16")
    params = runners_f32[0].params  # params are f32 whatever the compute dtype
    jr = jvlm.VLMRunner(jcfg, params=params)
    tr = tvlm.VLMRunner(tcfg, params=params_from_jax(params), device="cpu")
    pg = pages()
    want = _jax_first_logits(jr, pg, monkeypatch)
    got = _torch_first_logits(tr, pg)
    assert np.isfinite(got).all() and got.shape == (2, 4096)
    np.testing.assert_allclose(got, want, atol=BF16_LOGITS_ATOL)


def test_training_forward_f32(runners_f32):
    """OpticalVLM's full-sequence forward over [vision ; text] with a ragged
    text length, against the JAX module's __call__ (f32, XLA attention)."""
    import jax.numpy as jnp
    import torch

    jr, tr = runners_f32
    pg = pages()
    ids = np.random.default_rng(12).integers(0, 4096, (2, 10)).astype(np.int32)
    kv_len = np.array([10, 6], np.int32)
    patches = np.asarray(jr.preprocess_patches(pg), np.float32)
    want = jr.model.apply(
        {"params": jr.params}, jnp.asarray(patches), jnp.asarray(ids), jnp.asarray(kv_len)
    )
    got = tr.model(
        torch.from_numpy(patches), torch.from_numpy(ids).long(), torch.from_numpy(kv_len)
    )
    assert got.shape == (2, 64 + 10, 4096)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
