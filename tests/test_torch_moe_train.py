"""Switch-MoE training in the PyTorch port against the JAX package on the CPU:
the optimizer (`train_step.AdamW`) against optax's chain on the same
gradients, three `train_step`s of `tiny_moe` against the JAX package's
`train_step` with `make_optimizer`, and the `train_vlm --preset tiny_moe`
command line, whose checkpoint reads back bit-equal through the port's
reader and through the JAX package's orbax restore.

Inputs come from numpy seeds. The JAX side runs its XLA attention
(VCP_FORCE_XLA_ATTENTION=1); the port runs on the CPU, where attention takes
the kernel's plain version.

Tolerances. The optimizer on the same gradients: bf16 leaves, their moments
included, bit-equal (the port rounds to bf16 after every operation, with
every constant first rounded to bf16, as optax's arithmetic on a bf16 leaf
does); f32 leaves within 1e-6 of the largest value (the same f32 operations,
fused or ordered otherwise by XLA). Three train steps in f32: the loss
within 1e-5; mu and nu within 1e-4 of each leaf's largest value (the
gradients are the models' f32 sums in another order; the router's gradient
is held to 1e-4 in tests/test_torch_moe.py); the parameters within 1e-5 of
each leaf's largest value plus 0.05 x STEPS x lr: Adam divides by sqrt(nu) +
eps, so where one step's gradient is near eps (1e-8) an f32 rounding moves
that step's update by a share of lr (0.035 lr at most over the three steps,
measured). With bf16 compute and bf16
experts: the loss within 2e-2 (bf16 activations, as tests/test_torch_moe.py
holds bf16 logits), and every parameter within 3 x 2 x lr plus 2 bf16 ulps
of its value: a gradient computed with other bf16 roundings can point the
other way where it is near 0, and each Adam step moves a parameter by at
most about lr, either way.
"""

import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu.models.tokenizer import BOS_ID, PAD_ID
from vision_compression_project_tpu.train import checkpoint as jckpt
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.train import checkpoint as tckpt
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.weights import leaf_tensor, params_from_jax, params_to_jax

from torch_parity import param_shapes

jts = importlib.import_module("vision_compression_project_tpu.train.train_step")

LR = 1e-3
STEPS = 3
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
REPO = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  pages/s \d+\.\d  \(inst \d+\.\d\)  host enqueue ms/step "
                       r"feed (\d+\.\d\d|-) forward (\d+\.\d\d|-) backward (\d+\.\d\d|-) optimizer (\d+\.\d\d|-)$")


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")


def _dtype(cfg, dtype):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
                               decoder=dataclasses.replace(cfg.decoder, dtype=dtype))


def _flat(tree):
    """{path: float32 tensor} of a flax-named tree, and {path: dtype name}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    values, dtypes = {}, {}
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        t = leaf_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
        values[name], dtypes[name] = t.float(), str(t.dtype).replace("torch.", "")
    return values, dtypes


def _bits(t: torch.Tensor):
    """A tensor's dtype, shape and bytes."""
    t = t.contiguous()
    return t.dtype, tuple(t.shape), (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _run(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), VCP_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", f"vision_compression_project_tpu_torch.scripts.{module}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-1000:]
    return proc.stdout


def _adam_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
             if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _np_leaf(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("clip", [True, False])
def test_adamw_equals_optax_on_the_same_gradients(clip):
    """Three updates of f32 and bf16 leaves from the same gradients (global
    norm 15 or 0.5: clipped or not): parameters, mu and nu. The moments take
    each leaf's dtype, as optax's do."""
    rng = np.random.default_rng(1)
    shapes = {"dense": ((64, 32), np.float32), "experts": ((4, 32, 48), ml_dtypes.bfloat16),
              "bias": ((32,), np.float32), "router": ((32, 4), np.float32)}

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32).astype(d) for k, (s, d) in shapes.items()}

    params = tree(0.05)
    grads = [tree(0.1 if clip else 0.003) for _ in range(STEPS)]
    tx = jts.make_optimizer(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for g in grads:
        jp, st = step(jp, st, jax.tree_util.tree_map(jnp.asarray, g))
    adam = _adam_state(st)

    tp = {k: leaf_tensor(v).clone() for k, v in params.items()}
    opt = tts.make_optimizer(LR)
    state = opt.init(tp)
    for g in grads:
        for k in tp:
            tp[k].grad = leaf_tensor(g[k]).clone()
        state = opt.update(tp, state)
    assert state.count == STEPS
    for name, want, got in (("params", jp, tp), ("mu", adam.mu, state.mu), ("nu", adam.nu, state.nu)):
        for k in shapes:
            w = leaf_tensor(np.asarray(want[k]))
            assert got[k].dtype == w.dtype, (name, k)
            if w.dtype == torch.bfloat16:
                assert torch.equal(got[k].view(torch.int16), w.view(torch.int16)), (name, k)
            else:
                torch.testing.assert_close(got[k], w, atol=1e-6 * float(w.abs().max()), rtol=0, msg=f"{name} {k}")


# ----------------------------------------------------------- train steps


def _batches(jcfg, seed, n=STEPS, b=2, t=48):
    rng = np.random.default_rng(seed)
    v = jcfg.vision
    out = []
    for _ in range(n):
        patches = rng.standard_normal((b, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32)
        ids = rng.integers(0, 256, size=(b, t)).astype(np.int32)
        ids[:, 0] = BOS_ID
        ids[1, 35:] = PAD_ID
        out.append({"patch_tokens": patches, "token_ids": ids})
    return out


def _train_both(dtype):
    """(JAX (losses, params, mu, nu), port's) after STEPS train steps of
    tiny_moe in `dtype` from the JAX package's seeded init, on the same
    batches."""
    jcfg = _dtype(jconfigs.get_preset("tiny_moe"), dtype)
    tcfg = _dtype(tconfigs.get_preset("tiny_moe"), dtype)
    tree = jax.tree_util.tree_map(np.asarray, jvlm.VLMRunner(jcfg, seed=0).params)
    batches = _batches(jcfg, seed=5)

    jmodel = jvlm.OpticalVLM(jcfg)
    tx = jts.make_optimizer(LR)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jts.TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, b: jts.train_step(jmodel, tx, s, b))
    jlosses = []
    for batch in batches:
        state, loss = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        jlosses.append(float(loss))
    adam = _adam_state(state.opt_state)
    want = (jlosses, state.params, adam.mu, adam.nu)

    model = tvlm.OpticalVLM(tcfg)
    model.load_state_dict(params_from_jax(tree))
    model.train()
    opt = tts.make_optimizer(LR)
    named = dict(model.named_parameters())
    tstate = tts.TrainState(params=named, opt_state=opt.init(named), step=0, cfg=tcfg)
    tlosses = []
    for batch in batches:
        tb = {k: torch.tensor(v, dtype=torch.float32 if k == "patch_tokens" else torch.long) for k, v in batch.items()}
        tstate, loss = tts.train_step(model, opt, tstate, tb)
        tlosses.append(float(loss))
    got = (tlosses, params_to_jax(tstate.params, tcfg), params_to_jax(tstate.opt_state.mu, tcfg),
           params_to_jax(tstate.opt_state.nu, tcfg))
    return want, got, tcfg


def test_tiny_moe_three_train_steps_f32_equal_jax():
    (jl, jp, jmu, jnu), (tl, tp, tmu, tnu), tcfg = _train_both("float32")
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for name, want, got in (("params", jp, tp), ("mu", jmu, tmu), ("nu", jnu, tnu)):
        w, wd = _flat(want)
        g, gd = _flat(got)
        assert sorted(g) == sorted(w) and gd == wd, name
        for k in w:
            scale = float(w[k].abs().max())
            atol = 1e-5 * scale + 0.05 * STEPS * LR if name == "params" else 1e-4 * max(scale, 1e-30)
            torch.testing.assert_close(g[k], w[k], atol=atol, rtol=0, msg=f"{name} {k}")


def test_tiny_moe_three_train_steps_bf16_experts_match_jax():
    (jl, jp, jmu, jnu), (tl, tp, tmu, tnu), tcfg = _train_both("bfloat16")
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    experts = 0
    for name, want, got in (("params", jp, tp), ("mu", jmu, tmu), ("nu", jnu, tnu)):
        w, wd = _flat(want)
        g, gd = _flat(got)
        assert sorted(g) == sorted(w) and gd == wd, name  # optax's moment dtypes, per leaf
        experts += sum(d == "bfloat16" for d in gd.values())
        if name != "params":
            continue
        for k in w:
            ulp = 2.0 ** -7 if wd[k] == "bfloat16" else 2.0 ** -23
            atol = STEPS * 2 * LR + 2 * ulp * float(w[k].abs().max())
            torch.testing.assert_close(g[k], w[k], atol=atol, rtol=0, msg=k)
    assert experts == 3 * 3 * tcfg.decoder.depth  # w_gate, w_up, w_down in params, mu and nu


# ------------------------------------------------------------- the CLI


def test_train_vlm_tiny_moe_two_steps_checkpoint_reads_bit_equal(tmp_path):
    """`train_vlm --preset tiny_moe --steps 2` on the CPU: its step lines, and
    a checkpoint whose bf16 expert leaves (params and moments) read back
    bit-equal through the port's reader (load_params, restore_checkpoint)
    and, saved by the JAX package (orbax), through orbax's restore, in the
    layout of the JAX package's own tiny_moe parameters."""
    out = _run("train_vlm", ["--preset", "tiny_moe", "--steps", "2", "--batch", "2", "--log_every", "1",
                             "--text_len", "128", "--ckpt_dir", "ck"], tmp_path).splitlines()
    assert out[0] == "device: cpu (cpu)"
    assert len(out) == 4 and all(STEP_LINE.match(line) for line in out[1:3]), out
    ckpt = (tmp_path / "ck" / "step_00000002").resolve()
    assert out[3] == f"final checkpoint: {ckpt}"

    raw = torch.load(ckpt / tckpt.PORT_FILE, map_location="cpu", weights_only=True)
    tcfg = tconfigs.get_preset("tiny_moe")
    bf16 = [n for n, t in raw["params"].items() if t.dtype == torch.bfloat16]
    assert sorted(n.rsplit(".", 1)[-1] for n in bf16) == sorted(EXPERT_WEIGHTS * tcfg.decoder.depth)
    for part in ("mu", "nu"):
        assert {n for n, t in raw["opt_state"][part].items() if t.dtype == torch.bfloat16} == set(bf16)
    assert raw["opt_state"]["count"] == 2 and raw["step"] == 2

    # The port's reader.
    tree = tckpt.load_params(tmp_path / "ck")
    model = tvlm.OpticalVLM(tcfg)
    model.load_state_dict(params_from_jax(tree))
    named = dict(model.named_parameters())
    opt = tts.make_optimizer(1e-3)
    state = tts.TrainState(params=named, opt_state=opt.init(named), step=0, cfg=tcfg)
    tckpt.restore_checkpoint(tmp_path / "ck", state)
    for part, flat in (("params", params_to_jax(state.params, tcfg)), ("mu", params_to_jax(state.opt_state.mu, tcfg)),
                       ("nu", params_to_jax(state.opt_state.nu, tcfg))):
        saved = raw[part] if part == "params" else raw["opt_state"][part]
        back = tckpt._flatten(flat)
        assert sorted(back) == sorted(saved)
        for n, t in saved.items():
            assert _bits(back[n]) == _bits(t), (part, n)

    # The JAX package's orbax save and restore, in the JAX model's layout.
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(_np_leaf(x) if isinstance(x, torch.Tensor) else x),
                                   tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    shapes = param_shapes(jconfigs.get_preset("tiny_moe"))
    assert jax.tree_util.tree_structure(jtree) == jax.tree_util.tree_structure(shapes)
    for a, s in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    path = jckpt.save_params(tmp_path / "orbax", jtree, step=2)
    restored = tckpt._flatten(jax.tree_util.tree_map(np.asarray, ocp.StandardCheckpointer().restore(path)))
    assert sorted(restored) == sorted(raw["params"])
    assert sum(t.dtype == torch.bfloat16 for t in restored.values()) == 3 * tcfg.decoder.depth
    for n, t in raw["params"].items():
        assert _bits(restored[n]) == _bits(t), n
