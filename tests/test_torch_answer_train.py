"""The answer task's training (train_answer: qa_batches through vlm_loss and
train_step) in the port against the JAX package's, on `tiny` in f32 with the
same parameters carried over by params_from_jax: the loss on a qa_batches
batch, the parameters after a train_answer-style pair of steps (an
extraction batch, then an answer batch), and the loss against a
cross-entropy computed by hand over the loss_mask span alone.

The JAX side runs with VCP_FORCE_XLA_ATTENTION=1 (its XLA attention and
autodiff), as tests/test_torch_train.py runs it. Tolerances are that file's:
the loss rtol 1e-5; parameters after the steps atol 2e-5. The hand-computed
cross-entropy (float64 log-softmax of the port's own logits) rtol 1e-5.
Patch tokens of the two device_batch functions atol 1/64 (one bf16 step).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models.tokenizer import PAD_ID
from vision_compression_project_tpu.models.vlm import OpticalVLM as JOpticalVLM
from vision_compression_project_tpu.train import data as jdata
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.vlm import OpticalVLM
from vision_compression_project_tpu_torch.train import data as tdata
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

from torch_parity import numpy_params

jts = importlib.import_module("vision_compression_project_tpu.train.train_step")

TEXT_LEN = 160


def _f32(cfg):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                               decoder=dataclasses.replace(cfg.decoder, dtype="float32"))


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")


def _tiny():
    return _f32(jconfigs.get_preset("tiny")), _f32(tconfigs.get_preset("tiny"))


def _answer_batch(tcfg, seed, agg_frac=0.5):
    return next(tdata.qa_batches(tcfg, 3, text_len=TEXT_LEN, seed=seed, agg_frac=agg_frac))


def _step_batches(jcfg, tcfg, host):
    """(JAX batch, port batch) of one host batch: the JAX package's
    device_batch, and the same arrays as torch tensors. The port's own
    device_batch gives the same ids and mask, and patch tokens at most one
    bf16 step apart (atol 1/64, as tests/test_torch_train_data.py holds
    them)."""
    jb = jdata.device_batch(jcfg, host)
    tb = {k: torch.tensor(np.asarray(v, np.float32 if k == "patch_tokens" else np.int64))
          for k, v in jb.items()}
    own = tdata.device_batch(tcfg, host, device="cpu")
    assert sorted(own) == sorted(tb)
    for k in ("token_ids", "loss_mask"):
        assert torch.equal(own[k].long(), tb[k])
    torch.testing.assert_close(own["patch_tokens"].float(), tb["patch_tokens"], atol=1 / 64, rtol=0)
    return jb, tb


def _port_model(tcfg, tree):
    model = OpticalVLM(tcfg)
    model.load_state_dict(params_from_jax(tree))
    return model.train()


@pytest.mark.parametrize("agg_frac", [0.0, 1.0], ids=["imitate", "agg"])
def test_answer_loss_equals_jax(agg_frac):
    jcfg, tcfg = _tiny()
    tree = numpy_params(jcfg, seed=21)
    jb, tb = _step_batches(jcfg, tcfg, _answer_batch(tcfg, seed=3, agg_frac=agg_frac))
    want = jts.vlm_loss(JOpticalVLM(jcfg), jax.tree_util.tree_map(jnp.asarray, tree), jb)
    got = tts.vlm_loss(_port_model(tcfg, tree), tb)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_train_answer_steps_equal_jax(tmp_path):
    """Step 1 an extraction batch (synthetic_batches, rendered pages), step 2
    an answer batch, as train_answer --answer_every 2 alternates them, with
    its warmup-cosine schedule."""
    jcfg, tcfg = _tiny()
    tree = numpy_params(jcfg, seed=22)
    extract = next(tdata.synthetic_batches(tcfg, 2, text_len=TEXT_LEN, dpi=30, seed=0, workdir=tmp_path,
                                           font_size=24, lines=6))
    hosts = [extract, _answer_batch(tcfg, seed=7)]
    jmodel = JOpticalVLM(jcfg)
    tx = jts.make_optimizer(jts.cosine_lr(5e-4, 2))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jts.TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    model = _port_model(tcfg, tree)
    opt = tts.make_optimizer(tts.cosine_lr(5e-4, 2))
    tparams = dict(model.named_parameters())
    state = tts.TrainState(params=tparams, opt_state=opt.init(tparams), step=0, cfg=tcfg)
    jstep = jax.jit(lambda st, b: jts.train_step(jmodel, tx, st, b))
    losses, jlosses = [], []
    for host in hosts:
        jb, tb = _step_batches(jcfg, tcfg, host)
        jstate, jloss = jstep(jstate, jb)
        state, loss = tts.train_step(model, opt, state, tb)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_jax(state.params, tcfg)
    want = jax.tree_util.tree_map(np.asarray, jstate.params)
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    flat_want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for name, value in flat_want.items():
        np.testing.assert_allclose(flat_got[name], value, atol=2e-5, rtol=0, err_msg=name)


def test_answer_loss_is_the_answer_span_cross_entropy():
    """vlm_loss on a qa_batches batch is the mean cross-entropy of the
    targets that loss_mask marks (the answer and its EOS), none of the
    question or evidence tokens; and a batch whose mask is all ones gives
    another loss."""
    _, tcfg = _tiny()
    model = OpticalVLM(tcfg)
    tts.init_params(model, 5)
    host = _answer_batch(tcfg, seed=11)
    batch = tdata.device_batch(tcfg, host, device="cpu")
    batch["patch_tokens"] = batch["patch_tokens"].float()
    with torch.no_grad():
        loss = float(tts.vlm_loss(model, batch))
        ids = batch["token_ids"]
        logits = model(batch["patch_tokens"], ids[:, :-1]).double().numpy()
    text = logits[:, logits.shape[1] - (ids.shape[1] - 1):]
    logp = text - np.log(np.exp(text - text.max(-1, keepdims=True)).sum(-1, keepdims=True)) - text.max(
        -1, keepdims=True)
    targets = host["token_ids"][:, 1:]
    span = host["loss_mask"][:, 1:].astype(bool)
    assert bool((targets[span] != PAD_ID).all())
    picked = np.take_along_axis(logp, targets[..., None].astype(np.int64), -1)[..., 0]
    want = -picked[span].mean()
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    full = dict(batch, loss_mask=torch.ones_like(batch["loss_mask"]))
    with torch.no_grad():
        assert abs(float(tts.vlm_loss(model, full)) - loss) > 1e-3
