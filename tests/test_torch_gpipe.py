"""GPipe of the PyTorch port (parallel/pipeline.py) against the JAX
package's `gpipe` on the same numpy inputs: the cases of tests/test_gpipe.py
(tanh stages over 6 microbatches, a single microbatch; atol 1e-5), the
gradients through the pipeline, the validity-gated aux, the one-stage path
and the virtual stages.

The port runs on 8 gloo ranks (one spawn) at data 2 x model 4: rank s of
the `model` group holds stage s's slice of the stacked parameters
(`shard_stacked_params`). The JAX side runs on the 8 virtual CPU devices at
the same mesh. Gradients: the port's backward leaves each stage rank the
gradient of its own stage's slice, and stage 0 the gradient of the
microbatches; they are held against `jax.grad` through JAX's `gpipe` and
against torch autograd through the stages applied in turn (atol 1e-5). This
module imports JAX only inside its fixtures: the spawned ranks import it
for `_rank_cases` and must not load JAX.
"""

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, gpipe, shard_stacked_params, spawn
from vision_compression_project_tpu_torch.parallel.pipeline import (
    bubble, gather_stacked_params, gpipe_virtual, schedule,
)

STAGES, M, D = 4, 6, 16
ATOL = 1e-5
AUX_WEIGHT = 3.0
SPAWN_TIMEOUT_S = 300


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((STAGES, D, D)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((STAGES, D)) * 0.1).astype(np.float32)
    mbs = rng.standard_normal((M, 8, D)).astype(np.float32)
    rng1 = np.random.default_rng(1)
    ws1 = (rng1.standard_normal((4, 8, 8)) * 0.2).astype(np.float32)
    mbs1 = rng1.standard_normal((1, 4, 8)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal((M, 8, D)).astype(np.float32)
    return {"ws": ws, "bs": bs, "mbs": mbs, "ws1": ws1, "mbs1": mbs1, "cot": cot}


def _tanh(params, x):
    w, b = params
    return torch.tanh(x @ w[0] + b[0])


def _tanh_aux(params, x):
    y = _tanh(params, x)
    return y, (y * y).mean()


def _grads(fn, inputs, with_aux=False, mesh=None):
    """gpipe's outputs (aux) and the gradients of sum(out * cot) (+ AUX_WEIGHT
    * aux) for this rank: its stage's rows of dws/dbs, and dmbs (stage 0)."""
    ws = torch.from_numpy(inputs["ws"]).requires_grad_()
    bs = torch.from_numpy(inputs["bs"]).requires_grad_()
    mbs = torch.from_numpy(inputs["mbs"]).requires_grad_()
    local = shard_stacked_params(mesh, (ws, bs))
    res = gpipe(mesh, fn, local, mbs, with_aux=with_aux)
    out, aux = res if with_aux else (res, None)
    loss = (out * torch.from_numpy(inputs["cot"])).sum()
    if aux is not None:
        loss = loss + AUX_WEIGHT * aux
    loss.backward()
    s = mesh.get_local_rank("model")
    return {"out": out.detach().numpy(), "aux": None if aux is None else float(aux),
            "dws": ws.grad[s].numpy().copy(), "dbs": bs.grad[s].numpy().copy(),
            "dws_other_rows_zero": bool((torch.cat([ws.grad[:s], ws.grad[s + 1:]]) == 0).all()),
            "dmbs": None if mbs.grad is None else mbs.grad.numpy().copy()}


def _rank_cases(inputs):
    mesh = build_mesh(MeshConfig(data=2, model=4), "cpu")
    s = mesh.get_local_rank("model")
    out = {"stage": s}
    with torch.no_grad():
        local = shard_stacked_params(mesh, (torch.from_numpy(inputs["ws"]), torch.from_numpy(inputs["bs"])))
        out["tanh"] = gpipe(mesh, _tanh, local, torch.from_numpy(inputs["mbs"])).numpy()
        w1 = shard_stacked_params(mesh, torch.from_numpy(inputs["ws1"]))
        out["single"] = gpipe(mesh, lambda w, x: x @ w[0], w1, torch.from_numpy(inputs["mbs1"])).numpy()
        # The same stages run virtually in this process: the same numbers to the bit.
        stacked = (torch.from_numpy(inputs["ws"]), torch.from_numpy(inputs["bs"]))
        virtual = gpipe_virtual(_tanh, [(stacked[0][i:i + 1], stacked[1][i:i + 1]) for i in range(STAGES)],
                                torch.from_numpy(inputs["mbs"]))
        out["virtual_bit_equal"] = bool(torch.equal(virtual, torch.from_numpy(out["tanh"])))
        gathered = gather_stacked_params(mesh, local)
        out["gather_round_trip"] = all(bool(torch.equal(g, t)) for g, t in zip(gathered, stacked))
    out["grad"] = _grads(_tanh, inputs, mesh=mesh)
    out["aux"] = _grads(_tanh_aux, inputs, with_aux=True, mesh=mesh)
    # model = 1: the degenerate path, every stage in one stage function.
    mesh1 = build_mesh(MeshConfig(data=8, model=1), "cpu")
    ws, bs = (torch.from_numpy(inputs[k]) for k in ("ws", "bs"))

    def all_stages(params, x):
        for i in range(STAGES):
            x = torch.tanh(x @ params[0][0, i] + params[1][0, i])
        return x, (x * x).mean()

    with torch.no_grad():
        y1, aux1 = gpipe(mesh1, all_stages, (ws[None], bs[None]), torch.from_numpy(inputs["mbs"]), with_aux=True)
        y0, aux0 = gpipe(None, all_stages, (ws[None], bs[None]), torch.from_numpy(inputs["mbs"]), with_aux=True)
    out["one_stage"] = {"out": y1.numpy(), "aux": float(aux1), "no_mesh_bit_equal": bool(torch.equal(y0, y1))
                        and float(aux0) == float(aux1)}
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's gpipe on the 8 virtual devices: data 2 x model 4, and model 1."""
    import jax
    import jax.numpy as jnp

    from vision_compression_project_tpu.parallel import MeshConfig as JMeshConfig
    from vision_compression_project_tpu.parallel import build_mesh as jbuild_mesh
    from vision_compression_project_tpu.parallel.pipeline import gpipe as jgpipe
    from vision_compression_project_tpu.parallel.pipeline import shard_stacked_params as jshard

    inputs = _inputs()
    mesh = jbuild_mesh(JMeshConfig(data=2, seq=1, expert=1, model=4))
    ws, bs, mbs, cot = (jnp.asarray(inputs[k]) for k in ("ws", "bs", "mbs", "cot"))

    def stage(p, x):
        return jnp.tanh(x @ p[0] + p[1])

    def stage_aux(p, x):
        y = stage(p, x)
        return y, jnp.mean(y * y)

    params = jshard(mesh, (ws, bs), axis_name="model")
    want = {"tanh": np.asarray(jgpipe(mesh, stage, params, mbs))}
    want["single"] = np.asarray(jgpipe(mesh, lambda w, x: x @ w, jshard(mesh, jnp.asarray(inputs["ws1"])),
                                       jnp.asarray(inputs["mbs1"])))

    def loss(ws_, bs_, mbs_):
        return jnp.sum(jgpipe(mesh, stage, (ws_, bs_), mbs_) * cot)

    def loss_aux(ws_, bs_, mbs_):
        y, aux = jgpipe(mesh, stage_aux, (ws_, bs_), mbs_, with_aux=True)
        return jnp.sum(y * cot) + AUX_WEIGHT * aux

    want["grad"] = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(ws, bs, mbs)]
    want["aux_grad"] = [np.asarray(g) for g in jax.grad(loss_aux, argnums=(0, 1, 2))(ws, bs, mbs)]
    y, aux = jgpipe(mesh, stage_aux, params, mbs, with_aux=True)
    want["aux"] = (np.asarray(y), float(aux))

    mesh1 = jbuild_mesh(JMeshConfig(data=8, model=1))

    def all_stages(p, x):
        for i in range(STAGES):
            x = jnp.tanh(x @ p[0][i] + p[1][i])
        return x, jnp.mean(x * x)

    y1, aux1 = jgpipe(mesh1, all_stages, (ws[None], bs[None]), mbs, with_aux=True)
    want["one_stage"] = (np.asarray(y1), float(aux1))
    return inputs, want


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank_cases, 8, _inputs(), device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _sequential(inputs):
    want = inputs["mbs"]
    for s in range(STAGES):
        want = np.tanh(want @ inputs["ws"][s] + inputs["bs"][s])
    return want


def test_gpipe_matches_sequential(jax_side, ranks):
    inputs, want = jax_side
    np.testing.assert_allclose(want["tanh"], _sequential(inputs), atol=ATOL)
    for r in ranks:
        np.testing.assert_allclose(r["tanh"], want["tanh"], atol=ATOL)
        np.testing.assert_allclose(r["tanh"], _sequential(inputs), atol=ATOL)


def test_gpipe_single_microbatch(jax_side, ranks):
    inputs, want = jax_side
    seq = inputs["mbs1"]
    for s in range(4):
        seq = seq @ inputs["ws1"][s]
    for r in ranks:
        np.testing.assert_allclose(r["single"], want["single"], atol=ATOL)
        np.testing.assert_allclose(r["single"], seq, atol=ATOL)


def test_gpipe_gradients_match_jax_and_the_stages_in_turn(jax_side, ranks):
    inputs, want = jax_side
    ws, bs, mbs = (torch.from_numpy(inputs[k]).requires_grad_() for k in ("ws", "bs", "mbs"))
    y = mbs
    for s in range(STAGES):
        y = torch.tanh(y @ ws[s] + bs[s])
    (y * torch.from_numpy(inputs["cot"])).sum().backward()
    for r in ranks:
        g, s = r["grad"], r["stage"]
        assert g["dws_other_rows_zero"]
        for got, jax_g, torch_g in ((g["dws"], want["grad"][0][s], ws.grad[s]),
                                    (g["dbs"], want["grad"][1][s], bs.grad[s])):
            np.testing.assert_allclose(got, jax_g, atol=ATOL)
            np.testing.assert_allclose(got, torch_g.numpy(), atol=ATOL)
        if s == 0:
            np.testing.assert_allclose(g["dmbs"], want["grad"][2], atol=ATOL)
            np.testing.assert_allclose(g["dmbs"], mbs.grad.numpy(), atol=ATOL)
        else:
            assert g["dmbs"] is None


def test_gpipe_aux_matches_jax(jax_side, ranks):
    _, want = jax_side
    y, aux = want["aux"]
    for r in ranks:
        a, s = r["aux"], r["stage"]
        np.testing.assert_allclose(a["out"], y, atol=ATOL)
        np.testing.assert_allclose(a["aux"], aux, rtol=1e-5)
        np.testing.assert_allclose(a["dws"], want["aux_grad"][0][s], atol=ATOL)
        np.testing.assert_allclose(a["dbs"], want["aux_grad"][1][s], atol=ATOL)
        if s == 0:
            np.testing.assert_allclose(a["dmbs"], want["aux_grad"][2], atol=ATOL)


def test_one_stage_path_matches_jax(jax_side, ranks):
    inputs, want = jax_side
    y, aux = want["one_stage"]
    np.testing.assert_allclose(y, _sequential(inputs), atol=ATOL)
    for r in ranks:
        np.testing.assert_allclose(r["one_stage"]["out"], y, atol=ATOL)
        np.testing.assert_allclose(r["one_stage"]["aux"], aux, rtol=1e-5)
        assert r["one_stage"]["no_mesh_bit_equal"]


def test_virtual_stages_equal_the_ranks_bit_for_bit(ranks):
    assert all(r["virtual_bit_equal"] for r in ranks)


def test_gather_stacked_params_inverts_shard(ranks):
    assert all(r["gather_round_trip"] for r in ranks)


@pytest.mark.parametrize("m,s", [(4, 1), (4, 2), (6, 4), (1, 4)])
def test_schedule_holds_every_microbatch_once_per_stage(m, s):
    slots = schedule(m, s)
    assert sorted((st, mb) for _, st, mb in slots) == [(st, mb) for st in range(s) for mb in range(m)]
    assert all(t - st == mb for t, st, mb in slots) and max(t for t, _, _ in slots) == m + s - 2
    steps_used = len(slots)
    assert bubble(m, s) == pytest.approx(1 - steps_used / ((m + s - 1) * s))
