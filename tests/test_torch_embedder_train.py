"""The port's contrastive embedder training (train/embedder_train.py)
against the JAX package's on the same seeds and the same f32 parameters:
the pair batches, `info_nce_loss` with every parameter's gradient, and the
parameters after two `embedder_train_step`s with optax.adamw(lr)'s defaults.

The JAX side runs with VCP_FORCE_XLA_ATTENTION=1; the port's documents (S
256) take FlashAttentionFn (plain forward on the CPU, the port's backward),
its queries (S 64) the plain attention, as the reference's s >= 128 rule
routes them.

Tolerances (f32): batches exact; the loss rtol 1e-5; gradients atol 1e-5
plus rtol 1e-4 (the same sums in another order); parameters after two steps
atol 2e-5 (two AdamW updates of at most lr = 1e-4 each, whose direction
g / sqrt(v) amplifies the gradients' rounding where a gradient is tiny).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models.embedder import NeuralEmbedderModule as JModule
from vision_compression_project_tpu.train import embedder_train as jet
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.embedder import NeuralEmbedderModule
from vision_compression_project_tpu_torch.ops import attention as tattn
from vision_compression_project_tpu_torch.train import embedder_train as tet
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

SMALL = dict(dim=64, depth=2, heads=4, max_seq=256, dtype="float32")
LR = 1e-4


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")


def _params(jcfg, seed):
    """Seeded f32 flax params of the JAX embedder (kernels ~ 1/sqrt(fan_in),
    the rest 0.02-scale, norm scales near 1)."""
    model = JModule(jcfg)
    shapes = meta.unbox(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32))
    )["params"])
    rng = np.random.default_rng(seed)

    def make(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = s.shape[0]
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def _configs():
    return jconfigs.EmbedderConfig(**SMALL), tconfigs.EmbedderConfig(**SMALL)


def test_pair_batches_equal_jax():
    got, want = tet.synthetic_pair_batches(6, seed=3), jet.synthetic_pair_batches(6, seed=3)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    assert g["d_ids"].shape == (6, 256) and g["q_ids"].shape == (6, 64)


def test_info_nce_loss_and_gradients_equal_jax():
    jcfg, tcfg = _configs()
    tree = _params(jcfg, seed=1)
    batch = next(jet.synthetic_pair_batches(5, seed=2))
    jmodel = JModule(jcfg)
    want_loss, want_grads = jax.value_and_grad(lambda p: jet.info_nce_loss(jmodel, p, batch))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = NeuralEmbedderModule(tcfg)
    model.load_state_dict(params_from_jax(tree))
    loss = tet.info_nce_loss(model, tet.pair_batch(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        torch.testing.assert_close(p.grad, want[name], atol=1e-5, rtol=1e-4, msg=name)


def test_two_train_steps_equal_jax(monkeypatch):
    jcfg, tcfg = _configs()
    tree = _params(jcfg, seed=4)
    data = jet.synthetic_pair_batches(4, seed=5)
    batches = [next(data), next(data)]
    jmodel = JModule(jcfg)
    tx = optax.adamw(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    jlosses = []
    for b in batches:
        jparams, jstate, loss = jet.embedder_train_step(jmodel, tx, jparams, jstate, b)
        jlosses.append(float(loss))

    model, opt, params, opt_state = tet.make_embedder_train_state(tcfg, lr=LR, device="cpu")
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.max_norm) == (0.9, 0.999, 1e-8, 1e-4, None)
    model.load_state_dict(params_from_jax(tree))
    calls = []
    real = tattn._forward
    monkeypatch.setattr(tattn, "_forward", lambda *a: calls.append(a[0].shape[2]) or real(*a))
    losses = []
    for b in batches:
        params, opt_state, loss = tet.embedder_train_step(model, opt, params, opt_state, tet.pair_batch(b, "cpu"))
        losses.append(float(loss))
    # The documents' attention goes through the flash route, once per block
    # and step (no remat in the embedder); the 64-byte queries do not.
    assert calls == [256] * (2 * tcfg.depth)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_jax(params, tcfg)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    g, w = flat(got), flat(jparams)
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0, err_msg=name)


def test_embedder_seeded_init_equals_the_serving_embedder():
    """make_embedder_train_state and NeuralEmbedder draw the same weights
    from one seed, so a trained run starts where serving's random weights
    are."""
    from vision_compression_project_tpu_torch.models.embedder import NeuralEmbedder

    _, tcfg = _configs()
    model, _, _, _ = tet.make_embedder_train_state(tcfg, seed=9, device="cpu")
    served = NeuralEmbedder(tcfg, seed=9, device="cpu").model
    for name, value in served.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name
