"""The sharded train step of the PyTorch port (train/train_step.py with a
mesh) against the JAX package's train step on the same weights and batches.

Config: `tiny_moe` in f32 with a Switch-MoE block and a dense block
(expert_every 2) and capacity factor 0.5, so that every MoE call drops
tokens: a rank that routed only its own tokens would pick other capacities
and slots. The batch has rows with unequal PAD counts on the two `data`
ranks, and the second step's batch carries an answer-task loss_mask, so the
mask count must be the whole batch's. At the seed the gradient's global
norm is above 1 (asserted), so the clip acts and must see every shard.

The port runs on 4 gloo ranks (one spawn) at (data 2, model 2), (expert 2,
model 2) and (data 2, seq 2), the last also with a sequence of odd length,
which runs whole on each `seq` rank. The JAX side is its single-device
`train_step` (jitted, XLA attention): its mesh step computes the same global
function, and compiling it for each mesh would cost minutes here.

Tolerances, after tests/test_torch_moe_train.py's for f32 steps: the
losses within 1e-5; mu within 1e-4 and nu within 2e-4 of each leaf's
largest value (f32 sums in another order, over ranks too; nu squares the
gradient, which doubles its relative error; the worst leaves are the
attention keys' projections, whose gradients cancel under the softmax:
7.9e-5 and 1.9e-4 measured); the parameters within 1e-5 of each leaf's
largest value plus 0.1 x STEPS x lr (Adam divides by sqrt(nu) + eps, so a
gradient near eps moves one update by a share of lr; 0.08 x STEPS x lr
measured). The ranks' losses are equal to the bit. This module imports JAX only inside its tests: the
spawned ranks import it for `_rank_steps` and must not load JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID, PAD_ID
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn
from vision_compression_project_tpu_torch.parallel.sharding import gather_params, shard_batch
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

LR = 1e-3
STEPS = 2
MOMENT_RTOL = {"mu": 1e-4, "nu": 2e-4}  # nu squares the gradient: twice mu's relative error
SPAWN_TIMEOUT_S = 300
TEXT = 21      # [4 vision ; 20 text] = 24 positions: chunks at seq 2
TEXT_ODD = 20  # 23 positions: whole on each seq rank
MESHES = {
    "data2_model2": (2, 1, 1, 2),
    "expert2_model2": (1, 1, 2, 2),
    "data2_seq2": (2, 2, 1, 1),
    "data2_seq2_odd": (2, 2, 1, 1),
}


def _cfg(module):
    """The test config in `module` (the port's or the JAX package's configs)."""
    base = module.get_preset("tiny_moe")
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, dtype="float32"),
        decoder=dataclasses.replace(base.decoder, dtype="float32", expert_every=2, capacity_factor=0.5))


def _batches(text):
    """STEPS batches of 4 rows (numpy): unequal PAD counts across the two
    halves, and a loss_mask on the second."""
    rng = np.random.default_rng(11)
    v = _cfg(tconfigs).vision
    out = []
    for step in range(STEPS):
        ids = rng.integers(3, 256, size=(4, text)).astype(np.int64)
        ids[:, 0] = BOS_ID
        ids[1, -5:] = PAD_ID
        ids[2, -12:] = PAD_ID
        ids[3, -2:] = PAD_ID
        batch = {"patch_tokens": rng.standard_normal((4, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32),
                 "token_ids": ids}
        if step == 1:
            mask = np.zeros_like(ids)
            mask[:, text // 2:] = 1
            mask[0, :3] = 1
            batch["loss_mask"] = mask
        out.append(batch)
    return out


def _rank_steps(tree):
    """On each of 4 ranks, for every mesh: the model from `tree`, its shard
    kept, STEPS sharded train steps on the rank's rows; returns the losses
    and (rank 0) the gathered params and moments in the JAX layout."""
    cfg = _cfg(tconfigs)
    whole = params_from_jax(tree)
    out = {}
    for name, shape in MESHES.items():
        mesh = build_mesh(MeshConfig(*shape), "cpu")
        model, opt, state = tts.make_train_state(cfg, "cpu", lr=LR, mesh=mesh)
        tts.load_whole_params(model, whole, mesh)
        losses = []
        for batch in _batches(TEXT_ODD if name.endswith("odd") else TEXT):
            local = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
            state, loss = tts.train_step(model, opt, state, local, mesh=mesh)
            losses.append(float(loss))
        rec = {"losses": losses}
        gathered = [gather_params(t, mesh) for t in (state.params, state.opt_state.mu, state.opt_state.nu)]
        if torch.distributed.get_rank() == 0:
            rec["trees"] = [params_to_jax(t, cfg) for t in gathered]
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def runs():
    """The JAX package's single-device steps (per text length) and the
    port's ranks, from the same numpy parameters."""
    import os

    import jax
    import jax.numpy as jnp
    import optax

    from torch_parity import numpy_params
    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models import vlm as jvlm
    import importlib

    jts = importlib.import_module("vision_compression_project_tpu.train.train_step")

    old = os.environ.get("VCP_FORCE_XLA_ATTENTION")
    os.environ["VCP_FORCE_XLA_ATTENTION"] = "1"
    try:
        jcfg = _cfg(jconfigs)
        tree = numpy_params(jcfg, seed=4)
        model = jvlm.OpticalVLM(jcfg)
        tx = jts.make_optimizer(LR)
        step = jax.jit(lambda s, b: jts.train_step(model, tx, s, b))
        want = {}
        for text in (TEXT, TEXT_ODD):
            params = jax.tree_util.tree_map(jnp.asarray, tree)
            state = jts.TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
            batches = [jax.tree_util.tree_map(jnp.asarray, b) for b in _batches(text)]
            grads = jax.jit(jax.grad(lambda p, b: jts.vlm_loss(model, p, b)))(params, batches[0])
            losses = []
            for b in batches:
                state, loss = step(state, b)
                losses.append(float(loss))
            adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(
                x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)][0]
            want[text] = {"losses": losses, "grad_norm": float(optax.global_norm(grads)),
                          "trees": [jax.tree_util.tree_map(np.asarray, t) for t in (state.params, adam.mu, adam.nu)]}
    finally:
        if old is None:
            os.environ.pop("VCP_FORCE_XLA_ATTENTION")
        else:
            os.environ["VCP_FORCE_XLA_ATTENTION"] = old
    ranks = spawn(_rank_steps, 4, jax.tree_util.tree_map(np.asarray, tree), device_type="cpu",
                  timeout_s=SPAWN_TIMEOUT_S)
    return want, ranks


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def test_the_clip_acts_at_the_seed(runs):
    want, _ = runs
    assert want[TEXT]["grad_norm"] > 1.0 and want[TEXT_ODD]["grad_norm"] > 1.0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_losses_match_jax_and_agree_across_ranks(runs, mesh):
    want, ranks = runs
    w = want[TEXT_ODD if mesh.endswith("odd") else TEXT]["losses"]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[mesh]["losses"], w, atol=1e-5, rtol=0, err_msg=f"rank {r}")
        assert got[mesh]["losses"] == ranks[0][mesh]["losses"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_params_and_moments_match_jax(runs, mesh):
    want, ranks = runs
    w_trees = want[TEXT_ODD if mesh.endswith("odd") else TEXT]["trees"]
    for what, w_tree, g_tree in zip(("params", "mu", "nu"), w_trees, ranks[0][mesh]["trees"]):
        w, g = _leaves(w_tree), _leaves(g_tree)
        assert sorted(g) == sorted(w), what
        for k in w:
            scale = float(np.abs(w[k]).max())
            atol = 1e-5 * scale + 0.1 * STEPS * LR if what == "params" else MOMENT_RTOL[what] * max(scale, 1e-30)
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=f"{mesh} {what} {k}")


def test_mesh_of_one_changes_no_number():
    """make_train_state and train_step on a mesh of one rank (gloo) against
    the same calls without a mesh: losses and every parameter bit-equal."""
    out = spawn(_rank_mesh_of_one, 1, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)[0]
    assert out["losses"][0] == out["losses"][1]
    assert out["params_equal"]


def _rank_mesh_of_one():
    cfg = _cfg(tconfigs)
    results = []
    for mesh in (None, build_mesh(MeshConfig(1, 1, 1, 1), "cpu")):
        model, opt, state = tts.make_train_state(cfg, "cpu", seed=3, lr=LR, mesh=mesh)
        losses = []
        for batch in _batches(TEXT):
            state, loss = tts.train_step(model, opt, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         mesh=mesh)
            losses.append(float(loss))
        results.append((losses, {k: v.detach().clone() for k, v in state.params.items()}))
    (l0, p0), (l1, p1) = results
    return {"losses": [l0, l1], "params_equal": all(torch.equal(p0[k], p1[k]) for k in p0)}

