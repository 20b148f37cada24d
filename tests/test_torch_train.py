"""The port's VLM training step (train/train_step.py) against the JAX
package's (vision_compression_project_tpu/train/train_step.py) on the same
seeded numpy inputs and the same f32 parameters: the learning-rate schedule
at every step, the optimizer against optax's chain, `vlm_loss` and every
parameter's gradient against `jax.value_and_grad`, the parameters after
three `train_step`s; and, in the port alone, rematerialisation (on against
off) and the attention calls a step makes (the forward and again in the
recompute).

The JAX side runs whole models with VCP_FORCE_XLA_ATTENTION=1 (its XLA
attention and autodiff); the port's attention at S >= 128 goes through
FlashAttentionFn (plain forward on the CPU, the port's chunked backward).

Tolerances (f32): the schedule rtol 1e-6 (optax evaluates it in f32); the
optimizer on equal gradients atol 1e-7 (the same f32 formulas); the loss
rtol 1e-5; gradients atol 1e-5 plus rtol 1e-4 (the same sums in another
order); parameters after 3 steps atol 2e-5 (three AdamW updates of at most
lr = 1e-3, whose direction g / sqrt(v) amplifies the gradients' rounding
where a gradient is tiny).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models.tokenizer import BOS_ID, PAD_ID
from vision_compression_project_tpu.models.vlm import OpticalVLM as JOpticalVLM
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.vlm import OpticalVLM
from vision_compression_project_tpu_torch.ops import attention as tattn
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

from torch_parity import numpy_params

# The JAX package's train/__init__ exports the function train_step under the module's name.
jts = importlib.import_module("vision_compression_project_tpu.train.train_step")


def _f32(cfg):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                               decoder=dataclasses.replace(cfg.decoder, dtype="float32"))


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")


@pytest.mark.parametrize("peak,total,warmup", [(3e-4, 1000, 100), (8e-4, 50, 100), (1e-3, 7, 3), (1.5e-3, 1, 100)])
def test_cosine_lr_equals_optax_at_every_step(peak, total, warmup):
    want = jts.cosine_lr(peak, total, warmup=warmup)
    got = tts.cosine_lr(peak, total, warmup=warmup)
    steps = np.arange(total + 20)
    np.testing.assert_allclose([got(int(t)) for t in steps], np.asarray(jax.vmap(want)(steps)), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["clip_inactive", "clip_active"])
def test_optimizer_three_steps_equal_optax_chain(grad_scale):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal((7,)).astype(np.float32)}
    tx = jts.make_optimizer(jts.cosine_lr(1e-2, 30, warmup=5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = tts.make_optimizer(tts.cosine_lr(1e-2, 30, warmup=5))
    tstate = opt.init(tp)
    for _ in range(3):
        grads = {k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        assert (norm >= 1.0) == (grad_scale > 1)
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(grads[k])
        tstate = opt.update(tp, tstate)
    assert tstate.count == 3
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)


def _tiny():
    return _f32(jconfigs.get_preset("tiny")), _f32(tconfigs.get_preset("tiny"))


def _batch(jcfg, seed, b=2, t=130, pad_from=100, loss_mask=False):
    """Seeded patch tokens and token ids (BOS first, row 1 padded from
    `pad_from`), and a random loss mask when asked."""
    rng = np.random.default_rng(seed)
    v = jcfg.vision
    patches = rng.standard_normal((b, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32)
    ids = rng.integers(0, 256, size=(b, t)).astype(np.int32)
    ids[:, 0] = BOS_ID
    if pad_from is not None:
        ids[1, pad_from:] = PAD_ID
    batch = {"patch_tokens": patches, "token_ids": ids}
    if loss_mask:
        batch["loss_mask"] = (rng.random((b, t)) < 0.7).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v, dtype=torch.float32 if k == "patch_tokens" else torch.long)
            for k, v in batch.items()}


def _port_model(tcfg, tree):
    model = OpticalVLM(tcfg)
    model.load_state_dict(params_from_jax(tree))
    return model.train()


@pytest.mark.parametrize("loss_mask,pad_from", [(False, None), (False, 100), (True, 100)],
                         ids=["no_pad", "pad", "pad_and_loss_mask"])
def test_vlm_loss_and_every_gradient_equal_jax(loss_mask, pad_from):
    jcfg, tcfg = _tiny()
    tree = numpy_params(jcfg, seed=3)
    batch = _batch(jcfg, seed=4, pad_from=pad_from, loss_mask=loss_mask)
    jmodel = JOpticalVLM(jcfg)
    want_loss, want_grads = jax.value_and_grad(lambda p: jts.vlm_loss(jmodel, p, batch))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = _port_model(tcfg, tree)
    loss = tts.vlm_loss(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g is not None and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, want[name], atol=1e-5, rtol=1e-4, msg=name)
    # The decoder's attention projections get a gradient through FlashAttentionFn.
    assert float(model.decoder.blocks[0].attn.wq.weight.grad.abs().max()) > 0


def test_params_after_three_train_steps_equal_jax():
    jcfg, tcfg = _tiny()
    tree = numpy_params(jcfg, seed=6)
    batches = [_batch(jcfg, seed=10 + i, loss_mask=(i == 2)) for i in range(3)]
    jmodel = JOpticalVLM(jcfg)
    tx = jts.make_optimizer(jts.cosine_lr(1e-3, 20))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jts.TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jlosses = []
    for b in batches:
        jstate, loss = jts.train_step(jmodel, tx, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(loss))

    model = _port_model(tcfg, tree)
    opt = tts.make_optimizer(tts.cosine_lr(1e-3, 20))
    params_t = dict(model.named_parameters())
    state = tts.TrainState(params=params_t, opt_state=opt.init(params_t), step=0, cfg=tcfg)
    losses = []
    for b in batches:
        state, loss = tts.train_step(model, opt, state, _torch_batch(b))
        losses.append(float(loss))
    assert state.step == 3 and state.opt_state.count == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_jax(state.params, tcfg)
    want = jax.tree_util.tree_map(np.asarray, jstate.params)
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    flat_want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for name, value in flat_want.items():
        np.testing.assert_allclose(flat_got[name], value, atol=2e-5, rtol=0, err_msg=name)


# A model whose every attention call takes the flash route (S >= 128):
# one 16x16 window of patches, no downsample, so the global stage has 256
# tokens, and a decoder over 256 + 7 positions.
_COUNT = tconfigs.VLMConfig(
    vision=tconfigs.VisionConfig(image_size=256, patch=16, dim_local=32, dim_global=32, depth_local=2,
                                 depth_global=1, heads_local=2, heads_global=2, window=16, downsample=1,
                                 dtype="float32"),
    decoder=tconfigs.DecoderConfig(dim=32, depth=2, heads=2, kv_heads=1, head_dim=16, max_seq=512,
                                   dtype="float32"),
)


def _count_batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, size=(2, 8))
    ids[:, 0] = BOS_ID
    return {"patch_tokens": torch.tensor(rng.standard_normal((2, 256, 768)), dtype=torch.float32),
            "token_ids": torch.tensor(ids)}


def test_a_step_runs_attention_forward_again_in_the_recompute(monkeypatch):
    """Every block's attention runs in the forward and once more when the
    backward recomputes the block (remat): 2 x (local + global + decoder
    blocks) calls a step, the count chip_smoke.py holds K1's launches to
    (28 for ocr_real)."""
    calls = []
    real = tattn._forward
    monkeypatch.setattr(tattn, "_forward", lambda *a: calls.append(a[0].shape) or real(*a))
    model, opt, state = tts.make_train_state(_COUNT, device="cpu", seed=0, lr=1e-3)
    state, loss = tts.train_step(model, opt, state, _count_batch())
    v, d = _COUNT.vision, _COUNT.decoder
    assert len(calls) == 2 * (v.depth_local + v.depth_global + d.depth) == 10
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in state.params.values())
    for block in list(model.vision.local_blocks) + list(model.vision.global_blocks) + list(model.decoder.blocks):
        assert float(block.attn.wq.weight.grad.abs().max()) > 0
    calls.clear()
    with torch.no_grad():
        model(_count_batch()["patch_tokens"], _count_batch()["token_ids"])
    assert len(calls) == v.depth_local + v.depth_global + d.depth


def test_remat_on_equals_remat_off(monkeypatch):
    batch = _count_batch(1)

    def grads():
        model, _, _ = tts.make_train_state(_COUNT, device="cpu", seed=2)
        loss = tts.vlm_loss(model, batch)
        loss.backward()
        return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}

    loss_on, on = grads()
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, use_reentrant, preserve_rng_state, **k: fn(*a, **k))
    loss_off, off = grads()
    assert loss_on == loss_off
    for name in on:
        torch.testing.assert_close(on[name], off[name], atol=0, rtol=0, msg=name)


def test_missing_gradient_raises():
    p = {"a": torch.nn.Parameter(torch.ones(3)), "b": torch.nn.Parameter(torch.ones(2))}
    p["a"].grad = torch.ones(3)
    opt = tts.make_optimizer(1e-3)
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.update(p, opt.init(p))


def test_train_state_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="cuda"):
        tts.make_train_state(tconfigs.get_preset("tiny"))
