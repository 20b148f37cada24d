"""The sequence-parallel decoder forward of the PyTorch port against the JAX
package's: tests/test_sp_forward.py's decoder (dim 64, 2 blocks, GQA 4:2 at
head_dim 16, RoPE, max_seq 256) with the same numpy parameters carried across
by `params_from_jax`, on (4, 64) token embeddings.

The port runs on 4 gloo ranks (one spawn) under a `data` = 2, `seq` = 2
mesh (`model` = 1 until tensor parallelism is ported): each rank feeds its
(2, 32) block of the embeddings to `Decoder.forward` under `use_mesh`, and
the logits are gathered back. A spy counts one ring call per block, so the
ring really runs; RoPE at an offset of 0 on the second `seq` rank would
break the match. The JAX side runs with no mesh and under its
`data=2, seq=2, model=2` mesh of the virtual CPU devices of tests/conftest.py.
Tolerances: bf16 atol 0.08 / rtol 0.05 (tests/test_sp_forward.py's own:
bf16 rounding in other places), f32 atol 1e-4 (f32 sums in another order).
Beside it, on the same ranks: a `seq` = 1 mesh keeps the single-rank path
(no ring call); a vision-encoder block under `seq` = 2 attends over its
whole input as without a mesh (no ring call); a prefill under `seq` = 2
raises; a Switch-MoE decoder (routing over the whole batch) and
`OpticalVLM.forward` (the vision encoder whole on every `seq` rank, the
decoder on the rank's chunk; a length that does not divide `seq` whole)
under `seq` = 2 give the logits of the same f32 model without a mesh,
within the f32 atol.
This module imports JAX only inside its tests: the spawned ranks import it
for `_rank_sp` and must not load JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import decoder as tdecoder
from vision_compression_project_tpu_torch.models import vit as tvit
from vision_compression_project_tpu_torch.models.layers import init_weights_
from vision_compression_project_tpu_torch.models.vlm import OpticalVLM, init_params
from vision_compression_project_tpu_torch.ops import ring_attention as ring
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn, use_mesh
from vision_compression_project_tpu_torch.parallel.sharding import gather_shards, local_shard
from vision_compression_project_tpu_torch.weights import params_from_jax

SPAWN_TIMEOUT_S = 180
DECODER = dict(vocab=64, dim=64, depth=2, heads=4, kv_heads=2, head_dim=16, max_seq=256)
TOL = {"bfloat16": dict(atol=0.08, rtol=0.05), "float32": dict(atol=1e-4, rtol=0)}
AXES_IN, AXES_OUT = ("batch", "seq", "embed"), ("batch", "seq", "vocab")


def _x():
    return (np.random.default_rng(1).standard_normal((4, 64, 64)) * 0.3).astype(np.float32)


def _decoder(tree, dtype):
    model = tdecoder.Decoder(tconfigs.DecoderConfig(**DECODER, dtype=dtype))
    # The JAX decoder's __call__ takes embeddings, so its init makes no
    # token embedding; the forward does not read the port's either.
    missing, unexpected = model.load_state_dict(params_from_jax(tree), strict=False)
    assert missing == ["embed.weight"] and not unexpected
    return model.eval()


def _rank_sp(trees):
    """On each of 4 ranks: the decoder's forward on this rank's block under
    a data = 2, seq = 2 mesh (per dtype), counting ring calls; the seq = 1
    mesh; a vision-encoder block; the refusals."""
    calls = []
    orig = ring.ring_attention

    def spying_ring(*args, **kwargs):
        calls.append(kwargs.get("axis_name"))
        return orig(*args, **kwargs)

    ring.ring_attention = spying_ring
    mesh = build_mesh(MeshConfig(data=2, seq=2), "cpu")
    out = {}
    for dtype, tree in trees.items():
        model = _decoder(tree, dtype)
        x = torch.from_numpy(_x()).to(model.dt)
        calls.clear()
        with torch.no_grad(), use_mesh(mesh):
            logits = model(local_shard(x, mesh, AXES_IN))
        out[dtype] = (gather_shards(logits, mesh, AXES_OUT).numpy(), list(calls))
    # seq = 1: the single-rank path on each rank's batch row.
    model = _decoder(trees["float32"], "float32")
    mesh1 = build_mesh(MeshConfig(data=4, seq=1), "cpu")
    x = torch.from_numpy(_x())
    calls.clear()
    with torch.no_grad(), use_mesh(mesh1):
        got = model(local_shard(x, mesh1, AXES_IN))
    with torch.no_grad():
        want = model(x)[[torch.distributed.get_rank()]]
    out["seq1"] = (float((got - want).abs().max()), len(calls))
    # A vision-encoder block is not sequence-parallel: under seq = 2 it
    # attends over its whole input, as without a mesh.
    torch.manual_seed(5)
    block = tvit.EncoderBlock(32, 2, "float32").eval()
    xv = torch.randn(2, 16, 32)
    calls.clear()
    with torch.no_grad():
        alone = block(xv)
        with use_mesh(mesh):
            meshed = block(xv)
    out["vit_block"] = (float((meshed - alone).abs().max()), len(calls))
    # Under seq = 2: the prefill refuses; a Switch-MoE decoder and the VLM's
    # forward run, against the same f32 models without a mesh.
    moe_cfg = dataclasses.replace(tconfigs.get_preset("tiny_moe").decoder, dim=32, depth=2, heads=2, kv_heads=1,
                                  head_dim=16, vocab=64, dtype="float32")
    moe = tdecoder.Decoder(moe_cfg).eval()
    init_weights_(moe, torch.Generator().manual_seed(6))
    torch.manual_seed(6)
    xm = torch.randn(2, 8, 32)
    tiny = tconfigs.get_preset("tiny")
    vlm = OpticalVLM(dataclasses.replace(tiny, vision=dataclasses.replace(tiny.vision, dtype="float32"),
                                         decoder=dataclasses.replace(tiny.decoder, dtype="float32"))).eval()
    init_params(vlm, 7)
    grid = vlm.cfg.vision.grid
    pages = torch.randn(2, grid * grid, 16 * 16 * 3)
    errs = {}
    with torch.no_grad():
        want_moe = moe(xm)
        with use_mesh(mesh):
            got = gather_shards(moe(local_shard(xm, mesh, AXES_IN)), mesh, AXES_OUT)
        errs["moe"] = float((got - want_moe).abs().max())
        for text in (8, 7):  # [16 vision ; 8 text] divides seq = 2; 16 + 7 runs whole
            ids = torch.randint(3, 200, (2, text), generator=torch.Generator().manual_seed(text))
            want = vlm(pages, ids)
            with use_mesh(mesh):
                got = vlm(local_shard(pages, mesh, ("batch", None, None)), local_shard(ids, mesh, ("batch", None)))
            if got.shape[1] != want.shape[1]:
                got = gather_shards(got, mesh, (None, "seq", None))
            got = gather_shards(got, mesh, ("batch", None, None))
            errs[f"vlm_{16 + text}"] = float((got - want).abs().max())
    out["seq_mesh_max_abs_err"] = errs
    refused = {}
    with torch.no_grad(), use_mesh(mesh):
        try:
            model.prefill(torch.zeros(2, 8, 64), cache_len=16)
        except NotImplementedError as exc:
            refused["prefill"] = str(exc)
    out["refused"] = refused
    return out


def _numpy_params(jcfg, seed):
    """Random f32 flax params of the JAX Decoder(jcfg), made with numpy at
    the scales of its initializers, norm scales perturbed off 1."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from vision_compression_project_tpu.models.decoder import Decoder as JDecoder

    shapes = meta.unbox(jax.eval_shape(
        lambda: JDecoder(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((4, 64, jcfg.dim), jnp.float32))))["params"]
    rng = np.random.default_rng(seed)

    def make(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = s.shape[0] if path[-2].key in ("wq", "wk", "wv") else int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def runs():
    """The JAX decoder without a mesh and under its data=2, seq=2, model=2
    mesh, and the port on 4 ranks, per dtype."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vision_compression_project_tpu.models.configs import DecoderConfig as JDecoderConfig
    from vision_compression_project_tpu.models.decoder import Decoder as JDecoder
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh

    trees, jax_out = {}, {}
    jmesh = jbuild_mesh(JMeshConfig(data=2, seq=2, expert=1, model=2))
    for dtype in ("bfloat16", "float32"):
        jcfg = JDecoderConfig(**DECODER, dtype=dtype)
        tree = _numpy_params(jcfg, seed=3)
        trees[dtype] = tree
        model = JDecoder(jcfg)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        x = jnp.asarray(_x()).astype(jcfg.dtype)
        plain = np.asarray(model.apply({"params": params}, x), np.float32)
        xs = jax.device_put(x, NamedSharding(jmesh, P("data", "seq", None)))
        with jmesh:
            meshed = np.asarray(jax.jit(lambda p, a: model.apply({"params": p}, a))(params, xs), np.float32)
        jax_out[dtype] = (plain, meshed)
    ranks = spawn(_rank_sp, 4, trees, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return jax_out, ranks


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("reference", ["no_mesh", "jax_mesh"])
def test_sp_decoder_matches_jax(runs, dtype, reference):
    jax_out, ranks = runs
    want = jax_out[dtype][0 if reference == "no_mesh" else 1]
    for r, o in enumerate(ranks):
        got = o[dtype][0]
        assert got.shape == want.shape == (4, 64, 64)
        np.testing.assert_allclose(got, want, err_msg=f"rank {r}", **TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sp_decoder_runs_the_ring_once_per_block(runs, dtype):
    _, ranks = runs
    for o in ranks:
        assert o[dtype][1] == ["seq"] * DECODER["depth"]


def test_seq_one_keeps_the_single_rank_path(runs):
    _, ranks = runs
    for o in ranks:
        err, n_calls = o["seq1"]
        assert n_calls == 0 and err <= 1e-6


def test_moe_and_prefill_refuse_a_seq_mesh(runs):
    """The prefill still refuses a seq = 2 mesh; the Switch-MoE decoder no
    longer does and gives the logits of the whole batch without a mesh."""
    _, ranks = runs
    for o in ranks:
        assert "moe" not in o["refused"]
        assert o["seq_mesh_max_abs_err"]["moe"] <= TOL["float32"]["atol"]
        assert "Attention.prefill under a seq-sharded mesh" in o["refused"]["prefill"]


def test_vision_block_attends_whole_under_a_seq_mesh(runs):
    _, ranks = runs
    for o in ranks:
        err, n_calls = o["vit_block"]
        assert n_calls == 0 and err == 0.0


def test_vlm_forward_refuses_a_seq_mesh(runs):
    """OpticalVLM.forward no longer refuses a seq = 2 mesh: a length that
    divides it (24) runs on chunks, one that does not (23) whole, both with
    the logits of the model without a mesh."""
    _, ranks = runs
    for o in ranks:
        assert "vlm" not in o["refused"]
        assert o["seq_mesh_max_abs_err"]["vlm_24"] <= TOL["float32"]["atol"]
        assert o["seq_mesh_max_abs_err"]["vlm_23"] <= TOL["float32"]["atol"]
