"""The pipelined decoder forward of the PyTorch port (train/pp_forward.py)
against the JAX package's `pipelined_decoder_hidden` and against the blocks
applied in turn, on the same weights (`weights.params_from_jax`) and inputs:
tests/test_pp_forward.py's case (a dense f32 decoder of 4 blocks, 4
microbatches through 4 stages; atol 2e-4), the same for a uniform-MoE
decoder with the Switch term (`with_aux`), and the virtual stages.

The port runs on 8 gloo ranks (one spawn) at data 2 x model 4, rank (d, s)
holding stage s's block and row d of each 2-row microbatch (the PP row
layout of train/pp_train.py); a MoE block routes over both rows of its
microbatch, so each rank's hidden rows and its share of the aux (summed over
`data`) are the whole microbatch's. The JAX side runs on the 8 virtual CPU
devices at the same mesh. This module imports JAX only inside its fixtures.
"""

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.models.configs import DecoderConfig
from vision_compression_project_tpu_torch.models.decoder import Decoder
from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, spawn
from vision_compression_project_tpu_torch.parallel.pipeline import StageView
from vision_compression_project_tpu_torch.parallel.tensor_parallel import sum_over
from vision_compression_project_tpu_torch.train.pp_forward import (
    pipelined_decoder_hidden, stack_block_params, stage_blocks,
)
from vision_compression_project_tpu_torch.weights import params_from_jax

ATOL = 2e-4
AUX_RTOL = 1e-5
SPAWN_TIMEOUT_S = 300
CFG = dict(dim=64, depth=4, heads=4, kv_heads=2, head_dim=16, max_seq=64, dtype="float32")
CFG_MOE = dict(CFG, vocab=300, num_experts=4, expert_every=1)


def _x():
    return np.random.default_rng(0).standard_normal((2, 16, 64)).astype(np.float32)


def _microbatches(x):
    return np.stack([x, x * 0.5, x * 2.0, -x])


def _decoder(kind, params):
    cfg = DecoderConfig(**(CFG_MOE if kind == "moe" else CFG))
    model = Decoder(cfg)
    # The JAX decoder was initialised on embeddings: it has no token table.
    missing, unexpected = model.load_state_dict(params_from_jax(params), strict=False)
    assert missing == ["embed.weight"] and not unexpected
    return cfg, model


def _rank_forward(trees):
    mesh = build_mesh(MeshConfig(data=2, model=4), "cpu")
    d = mesh.get_local_rank("data")
    x_local = torch.from_numpy(_microbatches(_x())[:, d:d + 1])
    out = {"data": d}
    with torch.no_grad():
        for kind, tree in trees.items():
            cfg, model = _decoder(kind, tree)
            res = pipelined_decoder_hidden(cfg, model, x_local, mesh, with_aux=kind == "moe")
            h, aux = res if kind == "moe" else (res, None)
            out[kind] = {"h": h.numpy(), "aux": None if aux is None else float(sum_over(aux, ("data",), mesh))}
    view = StageView(build_mesh(MeshConfig(data=2, seq=2, expert=1, model=2), "cpu"))
    out["view"] = {"shape": view.shape, "model_rank": view.get_local_rank("model")}
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's pipelined hidden states (and aux) at data 2 x model 4, with the
    decoders' flax parameters."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_compression_project_tpu.models.configs import DecoderConfig as JDecoderConfig
    from vision_compression_project_tpu.models.decoder import Decoder as JDecoder
    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh
    from vision_compression_project_tpu.train.pp_forward import pipelined_decoder_hidden as jpipelined
    from vision_compression_project_tpu.train.pp_forward import stack_block_params as jstack

    mesh = jbuild_mesh(JMeshConfig(data=2, seq=1, expert=1, model=4))
    x = jnp.asarray(_x())
    mbs = jnp.asarray(_microbatches(_x()))
    want = {}
    for kind, fields in (("dense", CFG), ("moe", CFG_MOE)):
        cfg = JDecoderConfig(**fields)
        params = nn.meta.unbox(JDecoder(cfg).init(jax.random.PRNGKey(0), x)["params"])
        tree = jax.tree_util.tree_map(np.asarray, params)
        if kind == "moe":
            h, aux = jpipelined(cfg, params, mbs, mesh, use_moe=True, with_aux=True)
            want[kind] = {"tree": tree, "h": np.asarray(h), "aux": float(aux)}
        else:
            h = jpipelined(cfg, params, mbs, mesh)
            want[kind] = {"tree": tree, "h": np.asarray(h),
                          "stacked": jax.tree_util.tree_map(np.asarray, jstack(params, cfg.depth, 2))}
    return want


@pytest.fixture(scope="module")
def ranks(jax_side):
    return spawn(_rank_forward, 8, {k: v["tree"] for k, v in jax_side.items()}, device_type="cpu",
                 timeout_s=SPAWN_TIMEOUT_S)


def _in_turn(model, x):
    h = torch.from_numpy(x)
    with torch.no_grad():
        for block in model.blocks:
            h = block(h)[0]
    return h.numpy()


def test_pipelined_decoder_matches_jax_and_the_blocks_in_turn(jax_side, ranks):
    want = jax_side["dense"]
    _, model = _decoder("dense", want["tree"])
    mbs = _microbatches(_x())
    seq = np.stack([_in_turn(model, mbs[i]) for i in range(4)])
    np.testing.assert_allclose(want["h"], seq, atol=ATOL)
    for r in ranks:
        d = r["data"]
        assert r["dense"]["h"].shape == (4, 1, 16, 64)
        np.testing.assert_allclose(r["dense"]["h"], want["h"][:, d:d + 1], atol=ATOL)
        np.testing.assert_allclose(r["dense"]["h"], seq[:, d:d + 1], atol=ATOL)


def test_pipelined_moe_decoder_and_aux_match_jax(jax_side, ranks):
    want = jax_side["moe"]
    assert want["aux"] > 0.0
    for r in ranks:
        d = r["data"]
        np.testing.assert_allclose(r["moe"]["h"], want["h"][:, d:d + 1], atol=ATOL)
        np.testing.assert_allclose(r["moe"]["aux"], want["aux"], rtol=AUX_RTOL)


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("stages", [2, 4])
def test_virtual_stages_equal_one_stage_bit_for_bit(jax_side, kind, stages):
    cfg, model = _decoder(kind, jax_side[kind]["tree"])
    x = torch.from_numpy(_microbatches(_x()))
    with torch.no_grad():
        one = pipelined_decoder_hidden(cfg, model, x, None, with_aux=kind == "moe")
        many = pipelined_decoder_hidden(cfg, model, x, None, with_aux=kind == "moe", virtual_stages=stages)
    if kind == "moe":
        (one, aux1), (many, aux_n) = one, many
        np.testing.assert_allclose(float(aux_n), float(aux1), rtol=AUX_RTOL)
    assert torch.equal(one, many)
    np.testing.assert_allclose(one.numpy(), jax_side[kind]["h"], atol=ATOL)


def test_stack_block_params_matches_jax(jax_side):
    want = jax_side["dense"]
    _, model = _decoder("dense", want["tree"])
    stacked = stack_block_params(model.state_dict(), 4, 2)
    assert stacked["attn.wq.weight"].shape == (2, 2, 64, 64)
    # The JAX kernel (embed, heads, head_dim) is the transposed Linear weight.
    wq = want["stacked"]["attn"]["wq"]["kernel"]
    np.testing.assert_array_equal(stacked["attn.wq.weight"].numpy(),
                                  np.swapaxes(wq.reshape(wq.shape[:3] + (-1,)), -1, -2))
    np.testing.assert_array_equal(stacked["norm1.scale"].numpy(), want["stacked"]["norm1"]["scale"])


def test_stage_blocks_and_the_stage_view(ranks):
    assert list(stage_blocks(6, 3, 1)) == [2, 3] and list(stage_blocks(6, 1, 0)) == list(range(6))
    with pytest.raises(AssertionError):
        stage_blocks(6, 4, 0)
    for r in ranks:
        assert r["view"] == {"shape": (2, 1, 1, 1), "model_rank": 0}
