"""Each module of the PyTorch port against its JAX counterpart, on the same
inputs made with numpy from a seed: configs, tokenizer, resize, preprocess,
RMSNorm, RoPE, SwiGLU and attention (forward, prefill, both decode
branches)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models import decoder as jdecoder
from vision_compression_project_tpu.models import layers as jlayers
from vision_compression_project_tpu.models import tokenizer as jtok
from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu.ops import preprocess as jpre
from vision_compression_project_tpu.ops import resize as jresize
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import decoder as tdecoder
from vision_compression_project_tpu_torch.models import layers as tlayers
from vision_compression_project_tpu_torch.models import tokenizer as ttok
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.ops import preprocess as tpre
from vision_compression_project_tpu_torch.ops import resize as tresize
from vision_compression_project_tpu_torch.weights import params_from_jax

# f32 layers: the same arithmetic in another summation order.
F32_ATOL = 1e-5
# bf16 layers: outputs of magnitude ~1 rounded to bf16 (8 bits of mantissa)
# at slightly different places; one or two ulps.
BF16_ATOL = 2e-2

CORPUS = [
    "Quarterly revenue rose 12% to $4.2M (see Table 3).",
    "  Indented line\twith tab and trailing spaces  \n",
    "Ünïcödé — dashes, “quotes”, and 日本語 bytes.",
    "",
]


def test_presets_equal():
    """Every field the JAX package's configs have is equal in every preset;
    the port's own DecoderConfig fields (hybrid decoders) sit at their
    defaults, which give the JAX package's blocks."""
    assert sorted(tconfigs.PRESETS) == sorted(jconfigs.PRESETS)
    jax_fields = {f.name for f in dataclasses.fields(jconfigs.DecoderConfig)}
    port_only = [f for f in dataclasses.fields(tconfigs.DecoderConfig) if f.name not in jax_fields]
    assert port_only, "the port's DecoderConfig has fields of its own"
    for name in jconfigs.PRESETS:
        got, want = dataclasses.asdict(tconfigs.get_preset(name)), dataclasses.asdict(jconfigs.get_preset(name))
        assert {k: v for k, v in got["decoder"].items() if k in jax_fields} == want["decoder"], name
        assert {**got, "decoder": None} == {**want, "decoder": None}, name
        decoder = tconfigs.get_preset(name).decoder
        for f in port_only:
            assert getattr(decoder, f.name) == f.default, (name, f.name)
        got, want = tconfigs.get_preset(name), jconfigs.get_preset(name)
        assert (got.vision.grid, got.vision.tokens_out, got.decoder.mlp_dim) == (
            want.vision.grid, want.vision.tokens_out, want.decoder.mlp_dim,
        )
    with pytest.raises(KeyError):
        tconfigs.get_preset("nope")


@pytest.mark.parametrize("kind", ["byte", "bpe", "bpe:bpe_merges_real.json"])
def test_tokenizer_equal(kind):
    t, j = ttok.get_tokenizer(kind), jtok.get_tokenizer(kind)
    assert (t.vocab_size, t.cache_key) == (j.vocab_size, j.cache_key)
    assert t.expansions() == j.expansions()
    for text in CORPUS:
        ids = j.encode(text, add_bos=True, add_eos=True)
        assert t.encode(text, add_bos=True, add_eos=True) == ids
        assert t.decode(ids) == j.decode(ids)
    tb, tl = t.encode_batch(CORPUS, 24, add_bos=True)
    jb, jl = j.encode_batch(CORPUS, 24, add_bos=True)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tl, jl)
    preset = ttok.get_tokenizer(tconfigs.get_preset("ocr_real"))
    assert preset.vocab_size == tconfigs.get_preset("ocr_real").decoder.vocab


@pytest.mark.parametrize("kind", ["byte", "bpe:bpe_merges_real.json"])
def test_extract_logit_mask_equal(kind):
    """The extraction grammar mask, exactly equal."""
    got = tvlm._task_logit_mask(ttok.get_tokenizer(kind), "extract")
    want = jvlm._task_logit_mask(jtok.get_tokenizer(kind), "extract")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,out_hw", [((2, 37, 29, 1), (64, 48)), ((1, 50, 61, 3), (32, 96))])
def test_resize_f32(shape, out_hw):
    """Values are kept in [0, 1] (a float image) so f32 atol 1e-5 is a few
    ulps; uint8 pages are tested through preprocess below."""
    rng = np.random.default_rng(0)
    img = rng.uniform(size=shape).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.bilinear_matrix(shape[1], out_hw[0]), jresize.bilinear_matrix(shape[1], out_hw[0])
    )
    got = tresize.resize_bilinear(torch.from_numpy(img), *out_hw).numpy()
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), *out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("shape", [(2, 70, 53), (2, 70, 53, 1), (1, 40, 90, 3)])
def test_preprocess_pages_f32(shape):
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 256, shape, dtype=np.uint8)
    got = tpre.preprocess_pages(torch.from_numpy(pages), 64, 48, 16, out_dtype=torch.float32)
    want = jpre.preprocess_pages(jnp.asarray(pages), 64, 48, 16, out_dtype=jnp.float32)
    assert got.shape == want.shape == (shape[0], 12, 768)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    got_bf16 = tpre.preprocess_pages(torch.from_numpy(pages), 64, 48, 16)
    want_bf16 = jpre.preprocess_pages(jnp.asarray(pages), 64, 48, 16)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got_bf16.float().numpy(), np.asarray(want_bf16, np.float32), atol=BF16_ATOL
    )


def _init(module, *args, method=None):
    params = module.init(jax.random.PRNGKey(0), *args, method=method)["params"]
    return meta.unbox(params)


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jd, td = jlayers._dtype(dtype), tlayers.torch_dtype(dtype)
    params = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32)}
    want = jlayers.RMSNorm().apply({"params": params}, _to_jax(x, jd))
    norm = tlayers.RMSNorm(24)
    norm.load_state_dict(params_from_jax(params))
    got = norm(torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(
        got.float().detach().numpy(), np.asarray(want, np.float32),
        atol=F32_ATOL if dtype == "float32" else BF16_ATOL,
    )


def test_rope():
    cos, sin = tlayers.rope_table(32, 300, 10000.0)
    jcos, jsin = jlayers.rope_table(32, 300, 10000.0)
    # cos/sin of angles up to 300 rad: the libm and XLA results differ by an
    # ulp of the angle's argument reduction.
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=F32_ATOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=F32_ATOL)
    x = np.random.default_rng(3).standard_normal((2, 3, 7, 32)).astype(np.float32)
    got = tlayers.apply_rope(torch.from_numpy(x), cos[5:12], sin[5:12])
    want = jlayers.apply_rope(jnp.asarray(x), jcos[5:12], jsin[5:12])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    x = np.random.default_rng(4).standard_normal((2, 6, 32)).astype(np.float32)
    jmod = jlayers.SwiGLU(hidden=64, dtype=dtype)
    params = _init(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, _to_jax(x, jlayers._dtype(dtype)))
    tmod = tlayers.SwiGLU(32, 64, dtype=dtype)
    tmod.load_state_dict(params_from_jax(params))
    got = tmod(torch.from_numpy(x).to(tlayers.torch_dtype(dtype)))
    np.testing.assert_allclose(
        got.float().detach().numpy(), np.asarray(want, np.float32),
        atol=F32_ATOL if dtype == "float32" else BF16_ATOL,
    )


ATTN = dict(heads=6, kv_heads=2, head_dim=16)


def _attention_pair(causal, rope, dtype="float32", max_seq=64):
    jmod = jlayers.Attention(
        **ATTN, out_dim=48, causal=causal, rope=rope, max_seq=max_seq, dtype=dtype
    )
    params = _init(jmod, jnp.zeros((1, 4, 48)))
    tmod = tlayers.Attention(48, **ATTN, causal=causal, rope=rope, max_seq=max_seq, dtype=dtype)
    tmod.load_state_dict(params_from_jax(params))
    return jmod, params, tmod


@pytest.mark.parametrize("causal,rope", [(False, False), (True, True)])
def test_attention_forward(causal, rope):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, 48)).astype(np.float32)
    kv_len = np.array([20, 13], np.int32)
    jmod, params, tmod = _attention_pair(causal, rope)
    want = jmod.apply({"params": params}, jnp.asarray(x), kv_len=jnp.asarray(kv_len))
    got = tmod(torch.from_numpy(x), kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_prefill_and_decode(dtype):
    """prefill pads the cache to cache_len; decode then steps twice, once with
    a scalar position (lockstep) and once with per-row positions (ragged)."""
    rng = np.random.default_rng(6)
    jd, td = jlayers._dtype(dtype), tlayers.torch_dtype(dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    x = rng.standard_normal((2, 12, 48)).astype(np.float32)
    kv_len = np.array([12, 9], np.int32)
    jmod, params, tmod = _attention_pair(True, True, dtype=dtype)

    want_o, jcache = jmod.apply(
        {"params": params}, _to_jax(x, jd), jnp.asarray(kv_len), 32, method=jmod.prefill
    )
    got_o, tcache = tmod.prefill(torch.from_numpy(x).to(td), torch.from_numpy(kv_len), 32)
    assert tcache["k"].shape == (2, 2, 32, 16)
    np.testing.assert_allclose(got_o.float().detach().numpy(), np.asarray(want_o, np.float32), atol=atol)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key].float().detach().numpy(), np.asarray(jcache[key], np.float32), atol=atol
        )

    # Decode from the JAX cache on both sides, so each step is compared alone.
    def torch_cache(c):
        return {key: torch.from_numpy(np.array(c[key], np.float32)).to(td) for key in ("k", "v")}

    step = rng.standard_normal((2, 1, 48)).astype(np.float32)
    for jpos, tpos in [(jnp.asarray(12, jnp.int32), 12), (jnp.asarray([12, 9], jnp.int32), torch.tensor([12, 9]))]:
        want_o, want_cache = jmod.apply(
            {"params": params}, _to_jax(step, jd), jcache, jpos, method=jmod.decode
        )
        tc = torch_cache(jcache)
        got_o, got_cache = tmod.decode(torch.from_numpy(step).to(td), tc, tpos)
        assert got_cache["k"] is tc["k"]  # written in place
        np.testing.assert_allclose(
            got_o.float().detach().numpy(), np.asarray(want_o, np.float32), atol=atol
        )
        for key in ("k", "v"):
            np.testing.assert_allclose(
                got_cache[key].float().detach().numpy(), np.asarray(want_cache[key], np.float32),
                atol=atol,
            )


def test_init_cache():
    cfg_j, cfg_t = jconfigs.get_preset("tiny").decoder, tconfigs.get_preset("tiny").decoder
    want = jdecoder.init_cache(cfg_j, 3)
    got = tdecoder.init_cache(cfg_t, 3, device="cpu")
    assert len(got) == len(want) == cfg_t.depth
    for g, w in zip(got, want):
        for key in ("k", "v"):
            assert tuple(g[key].shape) == w[key].shape and g[key].dtype == torch.bfloat16
            assert not g[key].any()
