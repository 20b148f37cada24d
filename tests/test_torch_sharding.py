"""Parameter sharding, the sharded forward and the sharded runner of the
PyTorch port against the JAX package.

- The logical-axes table (`parallel.sharding.param_logical_axes`) against
  the JAX package's `nn.get_partition_spec` of `tiny`, `tiny_moe` and `prod`
  (shapes only), after weights.py's name and layout mapping: a flax kernel's
  (in..., out) axes reversed to the Linear weight's (out, in), wq/wk/wv's
  (embed, heads, head_dim) to (heads, embed), wo's (heads, head_dim, embed)
  to (embed, heads), a conv kernel's HWIO to OIHW.
- The JAX parameters carried across (`params_from_jax`, `shard_params` on
  each rank, `gather_params`, `params_to_jax`) come back bit for bit, and
  each rank's block is the slice the JAX package's `shard_params` puts on
  the device at the rank's mesh coordinates.
- A head count that does not divide `model` raises ValueError in both
  packages (`tiny`'s 2 vision heads at `model` = 4).
- The forward of `tiny_moe` in f32 (a MoE block and a dense block, capacity
  factor 0.5 so that tokens drop) at (model 2) on 2 gloo ranks, and at
  (expert 2, model 2) and (data 2, seq 2) on 4: the gathered logits against
  the JAX forward on the same weights (XLA attention), atol 1e-5 (f32 sums
  in another order).
- `VLMRunner(mesh=)` at (data 2, model 2), `tiny` and `tiny_moe` in f32: the
  same page JSON as one device, on every rank; under a `seq` mesh
  `extract_batch` still raises.

This module imports JAX only inside its tests: the spawned ranks import it
for their functions and must not load JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models.vlm import OpticalVLM, VLMRunner
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn, use_mesh
from vision_compression_project_tpu_torch.parallel.sharding import (gather_params, gather_shards, local_shard,
                                                                     param_logical_axes, shard_params)
from vision_compression_project_tpu_torch.weights import params_from_jax, params_to_jax

SPAWN_TIMEOUT_S = 300
ATOL = 1e-5
TEXT = 20  # [4 vision ; 20 text]: 24 positions, chunks at seq 2
FORWARD_MESHES = {"expert2_model2": (1, 1, 2, 2), "data2_seq2": (2, 2, 1, 1)}


def _f32(cfg, **decoder):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                               decoder=dataclasses.replace(cfg.decoder, dtype="float32", **decoder))


def _moe_cfg(module):
    return _f32(module.get_preset("tiny_moe"), expert_every=2, capacity_factor=0.5)


def _batch():
    rng = np.random.default_rng(2)
    v = _moe_cfg(tconfigs).vision
    return (rng.standard_normal((4, v.grid * v.grid, v.patch * v.patch * 3)).astype(np.float32),
            rng.integers(3, 256, size=(4, TEXT)).astype(np.int64))


def _pages():
    return np.random.default_rng(0).integers(0, 256, size=(4, 64, 64), dtype=np.uint8)


def _forward(model, mesh):
    """The model's logits on the batch, this rank's rows and chunk under
    `mesh`, gathered back whole."""
    pages, ids = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad(), use_mesh(mesh):
        logits = model(local_shard(pages, mesh, ("batch", None, None)), local_shard(ids, mesh, ("batch", None)))
    return gather_shards(logits, mesh, ("batch", "seq", None)).numpy()


def _model(tree, mesh):
    model = OpticalVLM(_moe_cfg(tconfigs)).eval()
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        for name, shard in shard_params(dict(model.named_parameters()), mesh).items():
            model.get_parameter(name).data = shard.clone()
    return model


def _rank_model2(tree):
    """On 2 ranks, a model = 2 mesh: the forward; the round trip."""
    mesh = build_mesh(MeshConfig(1, 1, 1, 2), "cpu")
    whole = params_from_jax(tree)
    shards = shard_params(whole, mesh)
    back = params_to_jax(gather_params(shards, mesh), _moe_cfg(tconfigs))
    return {"logits": _forward(_model(tree, mesh), mesh), "round_trip": back,
            "shards": {k: v.numpy() for k, v in shards.items()}}


def _rank_four(tree):
    """On 4 ranks: the forward at each of FORWARD_MESHES; the runners at
    (data 2, model 2); a head count that does not divide model = 4; a
    runner under seq = 2."""
    out = {}
    for name, shape in FORWARD_MESHES.items():
        mesh = build_mesh(MeshConfig(*shape), "cpu")
        out[name] = _forward(_model(tree, mesh), mesh)
    mesh = build_mesh(MeshConfig(2, 1, 1, 2), "cpu")
    for preset in ("tiny", "tiny_moe"):
        runner = VLMRunner(_f32(tconfigs.get_preset(preset)), seed=0, device="cpu", mesh=mesh, max_new_default=24)
        out[f"runner_{preset}"] = json.dumps(runner.extract_batch(_pages(), [1, 2, 3, 4]))
    try:
        VLMRunner(tconfigs.get_preset("tiny"), device="cpu", mesh=build_mesh(MeshConfig(1, 1, 1, 4), "cpu"))
    except ValueError as exc:
        out["model4"] = str(exc)
    runner = VLMRunner(_f32(tconfigs.get_preset("tiny")), device="cpu", mesh=build_mesh(MeshConfig(2, 2), "cpu"))
    try:
        runner.extract_batch(_pages(), [1, 2, 3, 4], max_new=4)
    except NotImplementedError as exc:
        out["seq_generate"] = str(exc)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """(numpy params of the test config, the JAX forward's logits on the batch)."""
    import os

    import jax
    import jax.numpy as jnp

    from torch_parity import numpy_params
    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models import vlm as jvlm

    old = os.environ.get("VCP_FORCE_XLA_ATTENTION")
    os.environ["VCP_FORCE_XLA_ATTENTION"] = "1"
    try:
        jcfg = _moe_cfg(jconfigs)
        tree = jax.tree_util.tree_map(np.asarray, numpy_params(jcfg, seed=8))
        pages, ids = _batch()
        model = jvlm.OpticalVLM(jcfg)
        logits = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b, mutable=["losses"])[0])(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(pages), jnp.asarray(ids))
    finally:
        if old is None:
            os.environ.pop("VCP_FORCE_XLA_ATTENTION")
        else:
            os.environ["VCP_FORCE_XLA_ATTENTION"] = old
    return tree, np.asarray(logits)


@pytest.fixture(scope="module")
def ranks(jax_side):
    tree, _ = jax_side
    return (spawn(_rank_model2, 2, tree, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S),
            spawn(_rank_four, 4, tree, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S))


# ------------------------------------------------------------ the table


def _port_axes(path, spec):
    """The JAX leaf at `path` with partition spec `spec`: (its state_dict
    name, its logical axes in the port's layout)."""
    from vision_compression_project_tpu_torch.weights import _module_name

    parts = [p.key for p in path]
    parent, leaf = parts[-2], parts[-1]
    axes = tuple(spec)
    if leaf == "kernel":
        if parent in ("wq", "wk", "wv"):
            axes = (axes[1], axes[0])
        elif parent == "wo":
            axes = (axes[2], axes[0])
        elif len(axes) == 4:
            axes = (axes[3], axes[2], axes[0], axes[1])
        else:
            axes = axes[::-1]
    name = ".".join([_module_name(p) for p in parts[:-1]] + ["weight" if leaf in ("kernel", "embedding") else leaf])
    return name, axes


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "prod"])
def test_logical_axes_table_equals_the_jax_partition_specs(preset):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models import vlm as jvlm

    jcfg = jconfigs.get_preset(preset)
    g, p = jcfg.vision.grid, jcfg.vision.patch
    boxed = jax.eval_shape(lambda: jvlm.OpticalVLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, g * g, p * p * 3), jnp.bfloat16), jnp.zeros((1, 8), jnp.int32)))["params"]
    specs = jax.tree_util.tree_flatten_with_path(nn.get_partition_spec(boxed),
                                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    with torch.device("meta"):
        port = dict(OpticalVLM(tconfigs.get_preset(preset)).named_parameters())
    seen = set()
    for path, spec in specs:
        name, axes = _port_axes(path, spec)
        assert name in port, name
        want = axes if axes else (None,) * port[name].dim()
        assert param_logical_axes(name, port[name].dim()) == want, name
        seen.add(name)
    assert seen == set(port)


def test_a_head_count_that_does_not_divide_raises_in_both(ranks):
    import jax
    import jax.numpy as jnp

    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models import vlm as jvlm
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh
    from vision_compression_project_tpu.parallel.sharding import shard_params as jshard_params

    jcfg = jconfigs.get_preset("tiny")
    g = jcfg.vision.grid
    boxed = jax.eval_shape(lambda: jvlm.OpticalVLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, g * g, 768), jnp.bfloat16), jnp.zeros((1, 8), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype), boxed)  # boxed zeros, as init's
    with pytest.raises(ValueError, match="divisible by 4"):
        jshard_params(params, jbuild_mesh(JMeshConfig(data=2, seq=1, expert=1, model=4)))
    _, four = ranks
    for got in four:
        assert "does not divide mesh axis model of 4" in got["model4"]


def test_weights_round_trip_bit_for_bit_and_shards_are_the_jax_blocks(jax_side, ranks):
    """gather_params(shard_params(params_from_jax(tree))) -> params_to_jax
    gives the tree back bit for bit; each rank's block of wq, wo, the
    experts, the unembed and the router is the JAX layout's slice at its
    `model` coordinate."""
    tree, _ = jax_side
    two, _ = ranks

    def leaves(t, prefix=""):
        out = {}
        for k, v in t.items():
            out.update(leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
        return out

    want = leaves(tree)
    for r, got in enumerate(two):
        back = leaves(got["round_trip"])
        assert sorted(back) == sorted(want)
        for k in want:
            assert back[k].dtype == want[k].dtype and np.array_equal(back[k], want[k]), k
        shards = got["shards"]
        dec = tree["decoder"]["block_1"]
        h = dec["attn"]["wq"]["kernel"].shape[1] // 2
        np.testing.assert_array_equal(shards["decoder.blocks.1.attn.wq.weight"],
                                      dec["attn"]["wq"]["kernel"][:, r * h:(r + 1) * h].reshape(
                                          dec["attn"]["wq"]["kernel"].shape[0], -1).T)
        np.testing.assert_array_equal(shards["decoder.blocks.1.attn.wo.weight"],
                                      dec["attn"]["wo"]["kernel"][r * h:(r + 1) * h].reshape(
                                          -1, dec["attn"]["wo"]["kernel"].shape[-1]).T)
        moe = tree["decoder"]["block_0"]["mlp"]
        f = moe["w_gate"].shape[2] // 2
        np.testing.assert_array_equal(shards["decoder.blocks.0.mlp.w_gate"], moe["w_gate"][:, :, r * f:(r + 1) * f])
        np.testing.assert_array_equal(shards["decoder.blocks.0.mlp.router.weight"], moe["router"]["kernel"].T)
        v = tree["decoder"]["unembed"]["kernel"].shape[1] // 2
        np.testing.assert_array_equal(shards["decoder.unembed.weight"],
                                      tree["decoder"]["unembed"]["kernel"][:, r * v:(r + 1) * v].T)


# ------------------------------------------------------- the forward


@pytest.mark.parametrize("mesh", ["model2"] + list(FORWARD_MESHES))
def test_sharded_forward_matches_jax(jax_side, ranks, mesh):
    _, want = jax_side
    two, four = ranks
    outs = [o["logits"] for o in two] if mesh == "model2" else [o[mesh] for o in four]
    for r, got in enumerate(outs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"{mesh} rank {r}")


# -------------------------------------------------------- the runner


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_sharded_runner_gives_the_page_json_of_one_device(ranks, preset):
    _, four = ranks
    runner = VLMRunner(_f32(tconfigs.get_preset(preset)), seed=0, device="cpu", max_new_default=24)
    want = json.dumps(runner.extract_batch(_pages(), [1, 2, 3, 4]))
    for got in four:
        assert got[f"runner_{preset}"] == want


def test_sharded_runner_under_a_seq_mesh_still_raises(ranks):
    _, four = ranks
    for got in four:
        assert "Attention.prefill under a seq-sharded mesh" in got["seq_generate"]
