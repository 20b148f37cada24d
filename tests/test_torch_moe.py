"""Switch-MoE in the PyTorch port against the JAX package: the layer
(`models/layers.py::SwitchMoE`) on the same parameters, its capacity drops in
a prefill-sized call and in a decode step, MoE decoder blocks through
`extract_batch` at `tiny_moe` and at a small `prod`-shaped config, the loss
with the load-balancing term and its router gradient, and the weights'
round trips (params_from_jax / params_to_jax, orbax -> train/ocdbt.py) with
bf16 expert leaves.

Inputs come from numpy seeds. The JAX side runs its XLA attention
(VCP_FORCE_XLA_ATTENTION=1); the port runs on the CPU, where attention takes
the kernel's plain version.

Tolerances: the layer in f32 atol 1e-5 (the same f32 products summed in
another order) with expert indices equal; in bf16 atol 2e-2 (both round the
expert products to bf16, XLA and torch at different places); first-step
logits as tests/test_torch_slice.py holds them (f32 atol 1e-4, bf16 atol
5e-2); the loss atol 1e-5 and the router's gradient atol 1e-4 in f32;
weights bit-equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax.core import meta

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models import decoder as jdecoder
from vision_compression_project_tpu.models import layers as jlayers
from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu.models.tokenizer import BOS_ID, PAD_ID
from vision_compression_project_tpu.train import checkpoint as jckpt
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import decoder as tdecoder
from vision_compression_project_tpu_torch.models import layers as tlayers
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.train import checkpoint as tckpt
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.weights import leaf_tensor, params_from_jax, params_to_jax

from torch_parity import param_shapes

jts = importlib.import_module("vision_compression_project_tpu.train.train_step")

MAX_NEW = 24
BF16_LOGITS_ATOL = 5e-2  # tests/test_torch_slice.py's, for the same reason
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")


def _dtype(cfg, dtype):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
                               decoder=dataclasses.replace(cfg.decoder, dtype=dtype))


# prod's structure (vision 2-stage with downsample 4, head dims 64 / 96 / 128,
# GQA 4:1, 16 SwiGLU experts in every second decoder block, BPE vocab 4096),
# widths and depths cut to run in seconds on the CPU.
PROD_VISION = dict(image_size=256, patch=16, dim_local=128, dim_global=192, depth_local=1, depth_global=1,
                   heads_local=2, heads_global=2, window=8, downsample=4)
PROD_DECODER = dict(vocab=4096, tokenizer="bpe", dim=128, depth=2, heads=8, kv_heads=2, head_dim=128,
                    max_seq=512, num_experts=16, expert_every=2)


def configs(name, dtype):
    """(JAX VLMConfig, port VLMConfig) of `name` ("tiny_moe" or "mini_prod") in `dtype`."""
    if name == "tiny_moe":
        return _dtype(jconfigs.get_preset("tiny_moe"), dtype), _dtype(tconfigs.get_preset("tiny_moe"), dtype)
    jcfg = dataclasses.replace(jconfigs.get_preset("prod"), vision=jconfigs.VisionConfig(**PROD_VISION, dtype=dtype),
                               decoder=dataclasses.replace(jconfigs.get_preset("prod").decoder, **PROD_DECODER,
                                                           dtype=dtype))
    tcfg = dataclasses.replace(tconfigs.get_preset("prod"), vision=tconfigs.VisionConfig(**PROD_VISION, dtype=dtype),
                               decoder=dataclasses.replace(tconfigs.get_preset("prod").decoder, **PROD_DECODER,
                                                           dtype=dtype))
    return jcfg, tcfg


def _make_leaf(rng, name, parent, shape, dtype):
    """A random leaf at its initializer's scale, in its own dtype (the
    experts' is the config's): kernels and experts ~ 1/sqrt(fan in), norm
    scales around 1, biases and embeddings small."""
    if name == "kernel" or name in EXPERT_WEIGHTS:
        fan_in = shape[0] if parent in ("wq", "wk", "wv") else shape[-2] if name in EXPERT_WEIGHTS \
            else int(np.prod(shape[:-1]))
        arr = rng.standard_normal(shape) / np.sqrt(fan_in)
    elif name == "scale":
        arr = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        arr = 0.02 * rng.standard_normal(shape)
    return np.asarray(arr.astype(np.float32), dtype=dtype)


def moe_params(jcfg, seed):
    """Random flax params for OpticalVLM(jcfg), each leaf in its init dtype."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _make_leaf(rng, path[-1].key, path[-2].key if len(path) > 1 else "", s.shape, s.dtype),
        param_shapes(jcfg))


def _layer_params(seed, d, e, hidden, dtype, bias_expert=None):
    """A SwitchMoE's flax params; with `bias_expert` the router pushes every
    token towards that expert (x[..., 0] is kept at 1 by `_layer_input`)."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if bias_expert is not None:
        router[0, bias_expert] += 8.0
    tree = {"router": {"kernel": router}}
    for name, shape in (("w_gate", (e, d, hidden)), ("w_up", (e, d, hidden)), ("w_down", (e, hidden, d))):
        tree[name] = np.asarray((rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32), dtype=dtype)
    return tree


def _layer_input(seed, b, s, d, dtype, pin=False):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    if pin:
        x[..., 0] = 1.0
    return np.asarray(x, dtype=dtype)


def _jax_layer(tree, x, e, hidden, dtype):
    """(output, aux) of the JAX SwitchMoE."""
    layer = jlayers.SwitchMoE(num_experts=e, hidden=hidden, dtype=dtype)
    out, state = layer.apply({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(x),
                             mutable=["losses"])
    return np.asarray(out.astype(jnp.float32)), float(jax.tree_util.tree_leaves(state)[0])


def _port_layer(tree, d, e, hidden, dtype):
    layer = tlayers.SwitchMoE(d, e, hidden, dtype=dtype)
    layer.load_state_dict(params_from_jax(tree))
    return layer


def _expert_index(tree, x):
    """Each token's expert as the reference routes it (f32 router, argmax of
    the softmax), computed in JAX."""
    logits = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1]) @ jnp.asarray(tree["router"]["kernel"])
    return np.asarray(jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_switch_moe_layer_matches_jax(dtype, atol):
    d, e, hidden = 64, 8, 96
    tree = _layer_params(1, d, e, hidden, jnp.dtype(dtype))
    x = _layer_input(2, 3, 40, d, jnp.dtype(dtype))
    want, want_aux = _jax_layer(tree, x, e, hidden, dtype)
    layer = _port_layer(tree, d, e, hidden, dtype)
    got, aux = layer(leaf_tensor(x))
    assert got.dtype == tlayers.torch_dtype(dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=atol)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-6)
    if dtype == "float32":
        probs = torch.softmax(layer.router(leaf_tensor(x).float()).reshape(-1, e), dim=-1)
        np.testing.assert_array_equal(torch.argmax(probs, dim=-1).numpy(), _expert_index(tree, x))
    # The experts' weights are stored in the config dtype, as the reference's are.
    assert all(getattr(layer, n).dtype == tlayers.torch_dtype(dtype) for n in EXPERT_WEIGHTS)


def _expected_drops(expert, capacity):
    """Tokens past their expert's capacity, by the reference's rule: the
    running count of each expert over the flattened (b, s) order."""
    seen = {}
    drops = []
    for t, ex in enumerate(expert):
        seen[ex] = seen.get(ex, 0) + 1
        drops.append(seen[ex] > capacity)
    return np.asarray(drops)


def test_capacity_drops_match_jax():
    """A router biased so that far more than C tokens pick one expert: the
    same tokens are dropped on both sides, and they get exactly 0."""
    d, e, hidden, b, s = 32, 4, 48, 2, 24
    tree = _layer_params(3, d, e, hidden, np.float32, bias_expert=2)
    x = _layer_input(4, b, s, d, np.float32, pin=True)
    capacity = max(1, int(1.25 * b * s / e))
    expert = _expert_index(tree, x)
    assert (expert == 2).sum() > capacity
    drops = _expected_drops(expert, capacity)
    want, _ = _jax_layer(tree, x, e, hidden, "float32")
    got, _ = _port_layer(tree, d, e, hidden, "float32")(leaf_tensor(x))
    got = got.detach().numpy().reshape(b * s, d)
    np.testing.assert_array_equal(np.all(want.reshape(b * s, d) == 0, axis=-1), drops)
    np.testing.assert_array_equal(np.all(got == 0, axis=-1), drops)
    np.testing.assert_allclose(got, want.reshape(b * s, d), atol=1e-5)


def test_decode_step_capacity_one_drops_the_second_row():
    """A decode step calls the MoE with T = b: at batch 4 and 4 experts C = 1,
    so of two rows on one expert the second is dropped, as in the reference."""
    d, e, hidden, b = 32, 4, 48, 4
    tree = _layer_params(5, d, e, hidden, np.float32)
    rng = np.random.default_rng(6)
    # Rows 0 and 2 on expert 1, rows 1 and 3 on experts 0 and 3.
    router = tree["router"]["kernel"]
    x = np.zeros((b, 1, d), np.float32)
    x[:, 0, 4:] = 0.1 * rng.standard_normal((b, d - 4))
    for row, ex in enumerate((1, 0, 1, 3)):
        x[row, 0, ex] = 1.0
    router[:4, :4] += 10.0 * np.eye(4, dtype=np.float32)
    np.testing.assert_array_equal(_expert_index(tree, x), [1, 0, 1, 3])
    assert max(1, int(1.25 * b / e)) == 1
    want, _ = _jax_layer(tree, x, e, hidden, "float32")
    got, _ = _port_layer(tree, d, e, hidden, "float32")(leaf_tensor(x))
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.all(got[:, 0] == 0, axis=-1), [False, False, True, False])
    np.testing.assert_array_equal(np.all(want[:, 0] == 0, axis=-1), [False, False, True, False])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_moe_block_prefill_and_decode_match_jax():
    """A MoE decoder block's prefill and one decode step at batch 4 (C = 1 in
    the step), with its KV cache, against the JAX block."""
    jcfg, tcfg = configs("mini_prod", "float32")
    jblock = jdecoder.DecoderBlock(jcfg.decoder, use_moe=True)
    x = _layer_input(7, 4, 8, jcfg.decoder.dim, np.float32)
    x1 = _layer_input(8, 4, 1, jcfg.decoder.dim, np.float32)
    shapes = meta.unbox(jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))))["params"]
    rng = np.random.default_rng(9)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: _make_leaf(rng, path[-1].key, path[-2].key if len(path) > 1 else "", s.shape, s.dtype),
        shapes)
    jp = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    kv_len = jnp.full((4,), 8, jnp.int32)
    jh, jcache = jblock.apply(jp, jnp.asarray(x), kv_len, 16, method=jdecoder.DecoderBlock.prefill)
    jout, _ = jblock.apply(jp, jnp.asarray(x1), jcache, jnp.full((4,), 8, jnp.int32),
                           method=jdecoder.DecoderBlock.decode)
    block = tdecoder.DecoderBlock(tcfg.decoder, use_moe=True)
    block.load_state_dict(params_from_jax(tree))
    assert isinstance(block.mlp, tlayers.SwitchMoE)
    with torch.no_grad():
        th, cache = block.prefill(leaf_tensor(x), kv_len=torch.full((4,), 8, dtype=torch.int32), cache_len=16)
        tout, _ = block.decode(leaf_tensor(x1), cache, torch.full((4,), 8, dtype=torch.long))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)


def test_decoder_places_moe_blocks_as_the_reference():
    for name in ("tiny_moe", "prod"):
        dec = tconfigs.get_preset(name).decoder
        want = [dec.num_experts > 0 and i % max(dec.expert_every, 1) == 0 for i in range(dec.depth)]
        with torch.device("meta"):
            model = tdecoder.Decoder(dec)
        assert [b.use_moe for b in model.blocks] == want
        assert [isinstance(b.mlp, tlayers.SwitchMoE) for b in model.blocks] == want


def _pages(cfg, n=2):
    rng = np.random.default_rng(11)
    side = cfg.vision.image_size
    pg = np.full((n, side + 20, side - 12), 255, np.uint8)
    pg[:, 10:side - 10:7, 8:side - 30] = rng.integers(0, 120, (n, len(range(10, side - 10, 7)), side - 38),
                                                      dtype=np.uint8)
    return pg


def _runners(name, dtype, tree=None):
    jcfg, tcfg = configs(name, dtype)
    tree = moe_params(jcfg, seed=0) if tree is None else tree
    jr = jvlm.VLMRunner(jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree))
    tr = tvlm.VLMRunner(tcfg, params=params_from_jax(tree), device="cpu")
    return jr, tr, tree


def _jax_first_logits(jr, pg):
    vis = jr._encode(jr.params, jr.preprocess_patches(pg))
    ids = np.full((pg.shape[0], 64), jvlm.PAD_ID, np.int32)
    ids[:, :2] = [jvlm.BOS_ID, jvlm.TASK_EXTRACT_ID]
    kv_len = jnp.full((pg.shape[0],), vis.shape[1] + 2, jnp.int32)
    logits, _ = jr.model.apply({"params": jr.params}, vis, jnp.asarray(ids), kv_len, 256,
                               method=jvlm.OpticalVLM.prefill_mixed)
    return np.asarray(logits[:, vis.shape[1] + 1], np.float32)


def _torch_first_logits(tr, pg):
    vis = tr.encode(tr.preprocess_patches(pg))
    ids, lens = tr.pad_prompts([[tvlm.BOS_ID, tvlm.TASK_EXTRACT_ID]] * pg.shape[0])
    logits, _, _ = tr.first_logits(ids, lens, vis, 256)
    return logits.float().numpy()


@pytest.mark.parametrize("name", ["tiny_moe", "mini_prod"])
def test_extract_batch_f32_tokens_and_first_logits_equal_jax(name):
    """Greedy tokens (prefill over T = b x (vision + 64) tokens, decode steps
    at T = b, so C = 1 and same-expert rows drop) and page dicts equal to the
    JAX runner's; first-step logits within 1e-4."""
    jr, tr, _ = _runners(name, "float32")
    pg = _pages(jr.cfg)
    jhandle = jr.extract_batch_async(pg, [1, 2], max_new=MAX_NEW)
    jtoks = np.asarray(jhandle[0])
    want = jr.collect_extract(jhandle)
    tvis = tr.encode(tr.preprocess_patches(pg))
    ttoks = tr.generate([[tvlm.BOS_ID, tvlm.TASK_EXTRACT_ID]] * 2, tvis, MAX_NEW)
    np.testing.assert_array_equal(ttoks.numpy(), jtoks)
    assert tr.extract_batch(pg, [1, 2], max_new=MAX_NEW) == want
    np.testing.assert_allclose(_torch_first_logits(tr, pg), _jax_first_logits(jr, pg), atol=1e-4)


@pytest.mark.parametrize("name", ["tiny_moe", "mini_prod"])
def test_first_logits_bf16_match_jax(name):
    """bf16 models (bf16 experts, f32 everything else, as the reference
    stores them): first-step logits of one page within test_torch_slice's
    5e-2, and an extract_batch that gives four well-formed pages.

    One page, because capacity couples the rows of a batch: a token's slot
    counts every earlier token of its expert, the earlier rows' included. In
    bf16 the two sides' router inputs differ by rounding, and at tiny_moe a
    few PAD positions of the first page sit nearly tied between two experts,
    so which expert takes them is decided by rounding, and with it which
    tokens of the second page are dropped. On one page the first-step logits
    read only the first positions, whose slots no later token changes. f32
    holds routing and drops exactly, on two pages."""
    jr, tr, _ = _runners(name, "bfloat16")
    assert all(p.dtype == torch.bfloat16 for n, p in tr.model.named_parameters() if n.split(".")[-1] in EXPERT_WEIGHTS)
    pg = _pages(jr.cfg, n=1)
    got = _torch_first_logits(tr, pg)
    assert np.isfinite(got).all() and got.shape == (1, jr.cfg.decoder.vocab)
    np.testing.assert_allclose(got, _jax_first_logits(jr, pg), atol=BF16_LOGITS_ATOL)
    pages = tr.extract_batch(np.concatenate([pg] * 4), [1, 2, 3, 4], max_new=8)
    assert [sorted(p) for p in pages] == [["entities", "markdown", "page_number", "summary"]] * 4


def _loss_batch(jcfg, seed, b=2, t=40):
    rng = np.random.default_rng(seed)
    v = jcfg.vision
    patches = rng.standard_normal((b, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32)
    ids = rng.integers(0, 256, size=(b, t)).astype(np.int32)
    ids[:, 0] = BOS_ID
    ids[1, 30:] = PAD_ID
    return {"patch_tokens": patches, "token_ids": ids}


def test_vlm_loss_with_aux_and_router_gradient_equal_jax():
    """tiny_moe in f32: the loss (cross-entropy + 0.01 x the MoE blocks'
    load-balancing terms) within 1e-5 of JAX's, each router's gradient
    within 1e-4, with the port's decoder blocks under remat."""
    jcfg, tcfg = configs("tiny_moe", "float32")
    tree = moe_params(jcfg, seed=3)
    batch = _loss_batch(jcfg, seed=4)
    jmodel = jvlm.OpticalVLM(jcfg)
    want_loss, want_grads = jax.value_and_grad(lambda p: jts.vlm_loss(jmodel, p, batch))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = tvlm.OpticalVLM(tcfg)
    model.load_state_dict(params_from_jax(tree))
    model.train()
    tbatch = {k: torch.tensor(v, dtype=torch.float32 if k == "patch_tokens" else torch.long) for k, v in batch.items()}
    aux = []
    model(tbatch["patch_tokens"], tbatch["token_ids"][:, :-1], aux_losses=aux)
    assert len(aux) == tcfg.decoder.depth  # tiny_moe: every block is a MoE block
    loss = tts.vlm_loss(model, tbatch)
    loss.backward()
    assert tts.MOE_AUX_WEIGHT == jts.MOE_AUX_WEIGHT
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5, rtol=0)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    routers = [n for n in want if n.endswith("mlp.router.weight")]
    assert len(routers) == tcfg.decoder.depth
    grads = dict(model.named_parameters())
    for name in routers:
        torch.testing.assert_close(grads[name].grad, want[name], atol=1e-4, rtol=0, msg=name)
        assert float(grads[name].grad.abs().max()) > 0


# ------------------------------------------------------------- weights


def _bits(value):
    """A leaf's dtype name, shape and bytes, for a numpy array or a tensor."""
    if isinstance(value, torch.Tensor):
        t = value.contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    arr = np.ascontiguousarray(value)
    return arr.dtype.name, arr.shape, arr.tobytes()


def _flat(tree):
    return {jax.tree_util.keystr(k): _bits(v) for k, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}


def _jax_init(jcfg):
    """The JAX package's own seeded init of OpticalVLM(jcfg), as numpy."""
    return jax.tree_util.tree_map(np.asarray, jvlm.VLMRunner(jcfg, seed=0).params)


def test_params_round_trip_bit_equal_with_bf16_experts():
    jcfg, tcfg = configs("tiny_moe", "bfloat16")
    tree = _jax_init(jcfg)
    state = params_from_jax(tree)
    assert {state[n].dtype for n in state if n.split(".")[-1] in EXPERT_WEIGHTS} == {torch.bfloat16}
    model = tvlm.OpticalVLM(tcfg)
    model.load_state_dict(state)
    back = params_to_jax(model.state_dict(), tcfg)
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    assert sum(w[0] == "bfloat16" for w in want.values()) == 3 * tcfg.decoder.depth
    for name, w in want.items():
        assert got[name] == w, name


def test_orbax_checkpoint_with_bf16_experts_reads_bit_equal(tmp_path):
    """A tiny_moe params tree saved by the JAX package (orbax, bf16 expert
    arrays) reads through train/ocdbt.py as orbax restores it, and loads
    into a runner that extracts as the JAX one does."""
    jcfg, tcfg = configs("tiny_moe", "bfloat16")
    tree = _jax_init(jcfg)
    path = jckpt.save_params(tmp_path, jax.tree_util.tree_map(jnp.asarray, tree), step=3)
    want = _flat(ocp.StandardCheckpointer().restore(path))
    got_tree = tckpt.load_params(tmp_path)
    got = _flat(got_tree)
    assert sorted(got) == sorted(want) and got == want
    assert sum(w[0] == "bfloat16" for w in got.values()) == 3 * tcfg.decoder.depth
    runner = tckpt.load_runner(tcfg, tmp_path, device="cpu")
    for name, value in params_from_jax(tree).items():
        assert _bits(runner.model.state_dict()[name]) == _bits(value), name
