"""The pipeline-parallel training of the PyTorch port (train/pp_train.py)
against the JAX package's on the same weights (`weights.params_from_jax` of
numpy parameters) and batches: the cases of tests/test_pp_train.py.

- `pp_lm_loss`: the loss and every gradient at data 2 x model 4 with 4
  microbatches (rtol 1e-5 for the loss; rtol 2e-4, atol 2e-5 for the
  gradients, the reference's limits).
- `pp_vlm_loss` on a dense VLM with a loss_mask: loss (rtol 1e-5) and
  gradients (rtol 3e-4, atol 3e-5).
- The Switch term of a uniform-MoE VLM: the loss equals the per-microbatch
  reference (the model applied to each microbatch, its aux averaged; rtol
  1e-5) and JAX's pipelined loss at data 2, whose microbatches the PP row
  layout reproduces; contiguous `data` rows give another loss.
- `train_vlm --pp_microbatches 2` on 2 ranks at VCP_MESH_MODEL=2 (one
  decoder block a stage): rank 0 alone logs, with the reference's PP line,
  the losses of the same command run alone, and saves the state gathered
  from both stages, equal to the one-stage checkpoint within rtol 1e-5,
  atol 1e-6 (the clip's norm sums the stages' squares in another order).
- Training: 10 steps reduce the loss by 20% (dense LM, uniform-MoE LM,
  uniform-MoE VLM with a loss_mask); bf16 gives a finite loss and
  gradients; one stage (model 1) equals vlm_loss (rtol 1e-5); a dense VLM
  whose 3-row microbatches do not divide over data 2 still runs, to the
  same loss; one `make_pp_vlm_train_step` step's parameters, gathered,
  against JAX's after the same step: within 1e-5 of each leaf's largest
  value plus 0.1 x lr, but for at most 0.1% of a leaf's elements, which
  must stay within 2 x lr. Adam's first update is lr x g / (|g| + eps): a
  gradient whose size is near eps, or whose sign is rounding noise (f32 sums
  in another order), moves its element by up to lr either way (one element
  of 24,576 of the patch embedding, by 1.03 x lr, in this test's first run).

The port runs on 8 gloo ranks (one spawn) at data 2 x model 4; the JAX side
on the 8 virtual CPU devices at the same mesh, under
VCP_FORCE_XLA_ATTENTION=1. This module imports JAX only inside its fixtures.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.decoder import Decoder
from vision_compression_project_tpu_torch.models.tokenizer import PAD_ID
from vision_compression_project_tpu_torch.models.vlm import OpticalVLM
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, shard_batch, spawn
from vision_compression_project_tpu_torch.parallel.tensor_parallel import sum_over
from vision_compression_project_tpu_torch.train import pp_train as pp
from vision_compression_project_tpu_torch.train.train_step import MOE_AUX_WEIGHT, make_optimizer, vlm_loss
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

REPO = Path(__file__).resolve().parents[1]
LR = 3e-3
STEP_LR = 1e-3
STEP_OUTLIERS = 1e-3  # share of a leaf's elements allowed past a tenth of an update (gradients near eps)
TRAIN_STEPS = 10
SPAWN_TIMEOUT_S = 600
LM_TOL = dict(rtol=2e-4, atol=2e-5)
VLM_TOL = dict(rtol=3e-4, atol=3e-5)
VISION = dict(image_size=64, patch=16, dim_local=32, dim_global=32, depth_local=1, depth_global=1, heads_local=2,
              heads_global=2, window=2, downsample=2, dtype="float32")
DECODER = dict(vocab=300, dim=32, depth=4, heads=4, kv_heads=2, head_dim=8, max_seq=96, dtype="float32")
MOE = dict(num_experts=4, expert_every=1)


def _cfg(module, moe=False, dtype="float32"):
    """The test VLM in `module` (the port's or the JAX package's configs)."""
    return module.VLMConfig(vision=module.VisionConfig(**dict(VISION, dtype=dtype)),
                            decoder=module.DecoderConfig(**dict(DECODER, dtype=dtype, **(MOE if moe else {}))))


def _lm_ids(seed=0, n=8, length=33, pad=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 250, size=(n, length)).astype(np.int64)
    if pad:
        ids[:, -pad:] = PAD_ID
    return ids


def _vlm_batch(b=4, text_len=17, seed=0, with_mask=False):
    v = _cfg(tconfigs).vision
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 250, size=(b, text_len)).astype(np.int64)
    ids[:, -3:] = PAD_ID
    batch = {"patch_tokens": rng.standard_normal((b, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32),
             "token_ids": ids}
    if with_mask:
        mask = np.ones_like(ids)
        mask[:, : text_len // 2] = 0
        batch["loss_mask"] = mask
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _vlm(tree, moe=False):
    model = OpticalVLM(_cfg(tconfigs, moe))
    model.load_state_dict(params_from_jax(tree))
    return model


def _lm(tree, moe=False):
    decoder = Decoder(_cfg(tconfigs, moe).decoder)
    decoder.load_state_dict(params_from_jax(tree["decoder"]))
    return decoder


def _grads(params):
    return {k: p.grad.numpy().copy() for k, p in params.items()}


def _rank_all(trees):
    """Every port case on this rank of data 2 x model 4."""
    mesh = build_mesh(MeshConfig(data=2, model=4), "cpu")
    out = {}
    # pp_lm_loss: loss and gradients.
    decoder = _lm(trees["dense"])
    params = pp.pp_stage_params(dict(decoder.named_parameters()), 4, mesh, prefix=pp.LM_BLOCKS)
    ids = pp.pp_shard_batch({"ids": torch.from_numpy(_lm_ids())}, mesh, 4)["ids"]
    loss = pp.pp_lm_loss(decoder, ids, mesh, n_micro=4)
    loss.backward()
    pp.pp_sum_gradients(params, mesh, prefix=pp.LM_BLOCKS)
    out["lm"] = {"loss": float(sum_over(loss.detach(), ("data", "model"), mesh)), "grads": _grads(params)}
    # pp_vlm_loss, dense, with a loss_mask.
    model = _vlm(trees["dense"])
    params = pp.pp_stage_params(dict(model.named_parameters()), 4, mesh)
    batch = pp.pp_shard_batch(_torch(_vlm_batch(with_mask=True)), mesh, 2)
    loss = pp.pp_vlm_loss(model, batch, mesh, n_micro=2)
    loss.backward()
    pp.pp_sum_gradients(params, mesh)
    out["vlm"] = {"loss": float(sum_over(loss.detach(), ("data", "model"), mesh)), "grads": _grads(params)}
    # The MoE aux at data 2: the PP rows, then contiguous rows.
    model = _vlm(trees["moe"], moe=True)
    whole = _torch(_vlm_batch(b=4, seed=1))
    with torch.no_grad():
        for name, rows in (("moe_pp_rows", pp.pp_shard_batch(whole, mesh, 2, uniform_moe=True)),
                           ("moe_contiguous_rows", shard_batch(whole, mesh))):
            out[name] = float(sum_over(pp.pp_vlm_loss(model, rows, mesh, n_micro=2), ("data", "model"), mesh))
        try:
            pp.pp_shard_batch(_torch(_vlm_batch(b=6, seed=1)), mesh, 2, uniform_moe=True)
            out["moe_odd_rows_refused"] = False
        except ValueError:
            out["moe_odd_rows_refused"] = True
        # A dense decoder whose 3-row microbatches do not divide over data 2.
        model = _vlm(trees["dense"])
        rows = pp.pp_shard_batch(_torch(_vlm_batch(b=6, seed=2)), mesh, 2)
        out["dense_odd_rows"] = float(sum_over(pp.pp_vlm_loss(model, rows, mesh, n_micro=2), ("data", "model"), mesh))
        out["dense_odd_rows_local"] = int(rows["token_ids"].shape[0])
    # Training steps.
    for name, moe, n_micro in (("train_lm", False, 4), ("train_lm_moe", True, 2)):
        decoder = _lm(trees["moe" if moe else "dense"], moe)
        opt, step = pp.make_pp_train_step(decoder, mesh, lr=LR, n_micro=n_micro)
        state = pp.pp_train_state(decoder, opt, 4, mesh, prefix=pp.LM_BLOCKS)
        ids = pp.pp_shard_batch({"ids": torch.from_numpy(_lm_ids(seed=1, length=17, pad=0))}, mesh, n_micro)["ids"]
        out[name] = [float(step(state, ids)[1]) for _ in range(TRAIN_STEPS)]
    model = _vlm(trees["moe"], moe=True)
    opt = make_optimizer(LR)
    state = pp.pp_train_state(model, opt, 4, mesh)
    step, rows = pp.make_pp_vlm_train_step(model, opt, mesh, n_micro=2)
    batch = rows(_torch(_vlm_batch(b=4, seed=3, with_mask=True)))
    out["train_vlm"] = [float(step(state, batch)[1]) for _ in range(TRAIN_STEPS)]
    out["train_vlm_step"] = state.step
    # One step of the dense VLM from the JAX weights, the state gathered.
    model = _vlm(trees["dense"])
    opt = make_optimizer(STEP_LR)
    state = pp.pp_train_state(model, opt, 4, mesh)
    step, rows = pp.make_pp_vlm_train_step(model, opt, mesh, n_micro=2)
    state, loss = step(state, rows(_torch(_vlm_batch(with_mask=True))))
    whole = pp.gather_pp_state(state, 4, mesh)
    out["one_step"] = {"loss": float(loss), "params": params_to_jax(whole.params, whole.cfg)
                       if torch.distributed.get_rank() == 0 else None, "names": sorted(whole.params)}
    # bf16 through the pipeline (uniform MoE, seeded weights).
    model, opt, state = pp.make_pp_train_state(_cfg(tconfigs, moe=True, dtype="bfloat16"), "cpu", seed=4, mesh=mesh)
    loss = pp.pp_vlm_loss(model, pp.pp_shard_batch(_torch(_vlm_batch(seed=5)), mesh, 2, True), mesh, n_micro=2)
    loss.backward()
    pp.pp_sum_gradients(state.params, mesh)
    out["bf16"] = {"loss": float(sum_over(loss.detach(), ("data", "model"), mesh)),
                   "grads_finite": all(bool(torch.isfinite(p.grad.float()).all()) for p in state.params.values())}
    # One stage: a mesh of data 8 x model 1.
    mesh1 = build_mesh(MeshConfig(data=8, model=1), "cpu")
    model = _vlm(trees["one_stage"])
    batch = pp.pp_shard_batch(_torch(_vlm_batch(b=8, seed=6)), mesh1, 2)
    with torch.no_grad():
        out["one_stage"] = float(sum_over(pp.pp_vlm_loss(model, batch, mesh1, n_micro=2), ("data",), mesh1))
    return out


def _rank_cli(argv, env):
    """train_vlm.main(argv) on this rank with `env` set; its stdout."""
    os.environ.update(env)
    from vision_compression_project_tpu_torch.scripts import train_vlm

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_vlm.main(argv)
    return buf.getvalue()


def _xla_attention():
    """VCP_FORCE_XLA_ATTENTION=1 within the block, as a whole model runs."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get("VCP_FORCE_XLA_ATTENTION")
        os.environ["VCP_FORCE_XLA_ATTENTION"] = "1"
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("VCP_FORCE_XLA_ATTENTION")
            else:
                os.environ["VCP_FORCE_XLA_ATTENTION"] = old

    return ctx()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's pipelined losses, gradients and step at data 2 x model 4, and
    the numpy parameters they start from."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from torch_parity import numpy_params
    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models.vlm import OpticalVLM as JOpticalVLM
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh
    import importlib

    # The package exports a function named train_step: import the module by name.
    jpp = importlib.import_module("vision_compression_project_tpu.train.pp_train")
    jts = importlib.import_module("vision_compression_project_tpu.train.train_step")

    with _xla_attention():
        mesh = jbuild_mesh(JMeshConfig(data=2, seq=1, expert=1, model=4))
        trees = {"dense": numpy_params(_cfg(jconfigs), seed=0), "moe": numpy_params(_cfg(jconfigs, moe=True), seed=1),
                 "one_stage": numpy_params(_cfg(jconfigs), seed=5)}
        jparams = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in trees.items()}

        def sharded(batch):
            return {k: jax.device_put(jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype),
                                      NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))))
                    for k, v in batch.items()}

        want = {"trees": trees}
        dcfg = _cfg(jconfigs).decoder
        ids = sharded({"ids": _lm_ids()})["ids"]
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(lambda p: jpp.pp_lm_loss(dcfg, p, ids, mesh, n_micro=4)))(
                jparams["dense"]["decoder"])
        want["lm"] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads)}
        cfg = _cfg(jconfigs)
        batch = sharded(_vlm_batch(with_mask=True))
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(lambda p: jpp.pp_vlm_loss(cfg, p, batch, mesh, n_micro=2)))(
                jparams["dense"])
        want["vlm"] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads)}
        cfg_moe = _cfg(jconfigs, moe=True)
        batch = sharded(_vlm_batch(b=4, seed=1))
        with mesh:
            want["moe"] = float(jax.jit(lambda p: jpp.pp_vlm_loss(cfg_moe, p, batch, mesh, n_micro=2))(jparams["moe"]))
            want["dense_odd_rows"] = float(jax.jit(lambda p, b: jpp.pp_vlm_loss(cfg, p, b, mesh, n_micro=2))(
                jparams["dense"], jax.tree_util.tree_map(jnp.asarray, {k: v.astype(np.int32) if v.dtype == np.int64
                                                                       else v for k, v in _vlm_batch(b=6, seed=2).items()})))
        model = JOpticalVLM(cfg)
        one = jax.tree_util.tree_map(jnp.asarray, {k: v.astype(np.int32) if v.dtype == np.int64 else v
                                                   for k, v in _vlm_batch(b=8, seed=6).items()})
        want["one_stage_vlm_loss"] = float(jax.jit(lambda p: jts.vlm_loss(model, p, one))(jparams["one_stage"]))
        tx = jts.make_optimizer(STEP_LR)
        step_fn, shardings = jpp.make_pp_vlm_train_step(cfg, tx, mesh, n_micro=2)
        state = jts.TrainState(params=jparams["dense"], opt_state=tx.init(jparams["dense"]),
                               step=jnp.zeros((), jnp.int32))
        batch = {k: jax.device_put(jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype), shardings[k])
                 for k, v in _vlm_batch(with_mask=True).items()}
        with mesh:
            state, loss = step_fn(state, batch)
        want["one_step"] = {"loss": float(loss), "params": jax.tree_util.tree_map(np.asarray, state.params)}
    return want


@pytest.fixture(scope="module")
def ranks(jax_side):
    return spawn(_rank_all, 8, jax_side["trees"], device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _check_grads(got, want_tree, tol):
    want = params_from_jax(want_tree)
    assert got and set(got) <= set(want)
    for k, g in got.items():
        w = want[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


def test_pp_lm_loss_and_grads_match_jax(jax_side, ranks):
    want = jax_side["lm"]
    blocks = set()
    for r in ranks:
        np.testing.assert_allclose(r["lm"]["loss"], want["loss"], rtol=1e-5, atol=1e-6)
        _check_grads(r["lm"]["grads"], want["grads"], LM_TOL)
        blocks |= {k.split(".")[1] for k in r["lm"]["grads"] if k.startswith("blocks.")}
    assert blocks == {"0", "1", "2", "3"}


def test_pp_vlm_loss_and_grads_match_jax(jax_side, ranks):
    want = jax_side["vlm"]
    for r in ranks:
        np.testing.assert_allclose(r["vlm"]["loss"], want["loss"], rtol=1e-5, atol=1e-6)
        _check_grads(r["vlm"]["grads"], want["grads"], VLM_TOL)


def test_pp_vlm_moe_aux_matches_microbatch_reference(jax_side):
    """One process, no mesh: the pipelined loss against the model applied to
    each microbatch (Switch capacity counts the apply's own tokens), its
    aux averaged over the microbatches."""
    model = _vlm(jax_side["trees"]["moe"], moe=True)
    batch = _torch(_vlm_batch(b=4, seed=1))
    n_micro, mb = 2, 2
    with torch.no_grad():
        got = float(pp.pp_vlm_loss(model, batch, None, n_micro=n_micro))
        logits, aux_terms = [], []
        for i in range(n_micro):
            aux = []
            logits.append(model(batch["patch_tokens"][i * mb:(i + 1) * mb],
                                batch["token_ids"][i * mb:(i + 1) * mb, :-1], aux_losses=aux))
            aux_terms.append(sum(aux))
        logits = torch.cat(logits)
        targets = batch["token_ids"][:, 1:]
        vis_len = logits.shape[1] - targets.shape[1]
        mask = (targets != PAD_ID).float()
        ce = torch.nn.functional.cross_entropy(logits[:, vis_len:].reshape(-1, logits.shape[-1]).float(),
                                               targets.reshape(-1), reduction="none").view_as(mask)
        ref_ce = float((ce * mask).sum() / mask.sum())
        ref_aux = float(sum(aux_terms) / n_micro)
    assert ref_aux > 0.0
    np.testing.assert_allclose(got, ref_ce + MOE_AUX_WEIGHT * ref_aux, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jax_side["moe"], rtol=1e-5, atol=1e-6)
    assert abs(got - ref_ce) > 1e-7  # the aux is material


def test_pp_vlm_moe_at_data_2_routes_over_the_reference_rows(jax_side, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["moe_pp_rows"], jax_side["moe"], rtol=1e-5, atol=1e-6)
        # Contiguous data rows put other rows into each microbatch: another loss.
        assert abs(r["moe_contiguous_rows"] - jax_side["moe"]) > 1e-4 * abs(jax_side["moe"])
        assert r["moe_odd_rows_refused"]


def test_dense_microbatches_that_do_not_divide_over_data_still_run(jax_side, ranks):
    assert sorted(r["dense_odd_rows_local"] for r in ranks) == [2] * 4 + [4] * 4
    for r in ranks:
        np.testing.assert_allclose(r["dense_odd_rows"], jax_side["dense_odd_rows"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["train_lm", "train_lm_moe", "train_vlm"])
def test_pp_train_steps_reduce_the_loss(ranks, name):
    for r in ranks:
        losses = r[name]
        assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.8, losses
        assert losses == ranks[0][name]
    assert all(r["train_vlm_step"] == TRAIN_STEPS for r in ranks)


def test_pp_vlm_bf16_is_finite(ranks):
    for r in ranks:
        assert np.isfinite(r["bf16"]["loss"]) and r["bf16"]["grads_finite"]


def test_one_stage_equals_vlm_loss(jax_side, ranks):
    model = _vlm(jax_side["trees"]["one_stage"])
    batch = _torch(_vlm_batch(b=8, seed=6))
    with torch.no_grad():
        ref = float(vlm_loss(model, batch))
        alone = float(pp.pp_vlm_loss(model, batch, None, n_micro=2))
    np.testing.assert_allclose(alone, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref, jax_side["one_stage_vlm_loss"], rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["one_stage"], ref, rtol=1e-5, atol=1e-6)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def test_one_pp_vlm_step_matches_jax(jax_side, ranks):
    want = jax_side["one_step"]
    names = sorted(dict(OpticalVLM(_cfg(tconfigs)).named_parameters()))
    for r in ranks:
        np.testing.assert_allclose(r["one_step"]["loss"], want["loss"], rtol=1e-5, atol=1e-6)
        assert r["one_step"]["names"] == names
    w, g = _leaves(want["params"]), _leaves(ranks[0]["one_step"]["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        scale = 1e-5 * float(np.abs(w[k]).max())
        diff = np.abs(g[k] - w[k])
        # Every element within two updates; all but STEP_OUTLIERS of each leaf within a tenth of one.
        assert diff.max() <= scale + 2 * STEP_LR, (k, float(diff.max()))
        assert np.mean(diff > scale + 0.1 * STEP_LR) <= STEP_OUTLIERS, (k, float(np.mean(diff > scale + 0.1 * STEP_LR)))


def test_a_mixed_decoder_is_refused():
    cfg = dataclasses.replace(_cfg(tconfigs), decoder=dataclasses.replace(_cfg(tconfigs).decoder, num_experts=4,
                                                                          expert_every=2))
    with pytest.raises(AssertionError, match=r"PP needs a uniform decoder \(dense or expert_every=1\)"):
        pp.make_pp_train_state(cfg, "cpu")
    with pytest.raises(AssertionError, match="PP needs a uniform decoder"):
        pp.pp_vlm_loss(OpticalVLM(cfg), _torch(_vlm_batch()), None, n_micro=2)


def test_train_vlm_on_two_pipeline_stages_saves_the_one_stage_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("VCP_DEVICE", "cpu")
    args = ["--preset", "tiny", "--steps", "2", "--batch", "4", "--text_len", "32", "--pp_microbatches", "2",
            "--log_every", "1"]
    # One thread, as each spawned rank runs.
    alone = subprocess.run(
        [sys.executable, "-m", "vision_compression_project_tpu_torch.scripts.train_vlm", *args, "--ckpt_dir",
         str(tmp_path / "alone")], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert alone.returncode == 0, alone.stderr[-3000:]
    two = spawn(_rank_cli, 2, args + ["--ckpt_dir", str(tmp_path / "two")], {"VCP_MESH_MODEL": "2"},
                device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    lines = two[0].splitlines()
    assert lines[1:3] == ["mesh: {'data': 1, 'seq': 1, 'expert': 1, 'model': 2} devices=2",
                          "PP training: 2 microbatches over 2 pipeline stage(s)"]
    assert two[1] == ""
    losses = [line.split()[3] for line in lines if line.startswith("step ")]
    assert len(losses) == 2 and losses == [line.split()[3] for line in alone.stdout.splitlines()
                                           if line.startswith("step ")]
    load = [torch.load(tmp_path / d / "step_00000002" / "checkpoint.pt", map_location="cpu", weights_only=True)
            for d in ("alone", "two")]
    for what in ("params", "mu", "nu"):
        want, got = ((c["params"] if what == "params" else c["opt_state"][what]) for c in load)
        assert sorted(got) == sorted(want), what
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-5, atol=1e-6, msg=f"{what} {k}")
