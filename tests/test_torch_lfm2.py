"""LFM2's decoder in the port (`lfm2_moe`: `ShortConv`, QK-norm in
`Attention`, `TopKMoE`, blocks from `layer_types`, the two-kind cache)
against the plain reference `portbench/reference/lfm2.py`, the file the
benchmark's LFM2 cell is checked with, at a tiny size on the CPU in float32
with seeded weights (`portbench/weights_lfm2.py`).

Tolerances, each with its reason:
- the decoder alone, port against reference on the same embeddings: 2e-5
  of the largest logit (the same f32 products summed in other orders: the
  grouped products, the taps as shifted sums against conv1d). The
  reference with its experts' operands in fp8, and the reference without
  QK-norm, both miss it by orders of magnitude (asserted).
- the whole reader's loss 1e-4 relative and each leaf's gradient 5e-3 of
  its largest entry: the port's preprocess hands the encoder bf16 patch
  tokens whatever the model's dtype, the reference keeps them f32
  (portbench/tests/test_portbench_reference.py holds the repo's reader so).
  The fp8-expert reference's gradients miss it on the expert leaves.
- one AdamW step: the relative L2 gap of each leaf's change, at most 0.03
  for the median leaf and 0.5 for the worst. Adam's first step is about lr
  times the gradient's sign, and an element whose gradient the bf16 patch
  tokens move across zero flips its whole step: the sound readings are 0.009
  and 0.24 (a norm scale with many tiny gradients); the fp8-expert
  reference reads 0.97 at the median.
- prefill then decode against the reference's full forward: 2e-5 of the
  largest logit, as the decoder's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench import harness, traffic, weights_lfm2
from portbench.reference import lfm2 as ref_lfm2
from portbench.reference.optim import AdamW as RefAdamW
from portbench.reference.precision import Precision, exact_float32
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import layers as tlayers
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID, TASK_EXTRACT_ID
from vision_compression_project_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_SEQ
from vision_compression_project_tpu_torch.parallel.sharding import use_mesh

DECODER = {"vocab": 512, "tokenizer": "byte", "dim": 64, "depth": 6, "heads": 4, "kv_heads": 2, "head_dim": 16,
           "mlp_ratio": 2.0, "max_seq": 512, "rope_theta": 1e6, "num_experts": 8, "expert_every": 1,
           "capacity_factor": 1.25, "dtype": "float32",
           "layer_types": ["conv", "conv", "full_attention", "conv", "full_attention", "conv"],
           "num_dense_layers": 2, "moe_dim": 32, "router": "sigmoid", "experts_per_token": 2, "qk_norm": True,
           "conv_kernel": 3, "norm_eps": 1e-5}
TRAFFIC = {"kind": "train_lfm2", "batch": 3, "page_h": 80, "page_w": 62, "lines": 4, "text_len": 40,
           "min_text": 24, "pool": 2, "lr": 8e-4, "checked_steps": 1, "trace_units": 1}
DECODER_TOL = 2e-5


def tiny_cfg() -> dict:
    vision = dataclasses.asdict(tconfigs.get_preset("tiny").vision)
    vision["dtype"] = "float32"
    return {"name": "tiny_lfm2", "vision": vision, "decoder": dict(DECODER)}


def _model(cfg, seed):
    from vision_compression_project_tpu_torch.models.vlm import OpticalVLM

    w = weights_lfm2.make(cfg, seed, "cpu")
    model = OpticalVLM(harness.vlm_config(cfg))
    model.load_state_dict(w)
    return model, w


def _reference(cfg, w, **kw):
    return ref_lfm2.Lfm2Reference(cfg, {k: v.float() for k, v in w.items()}, **kw)


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


def test_the_cells_block_pattern():
    cfg = tiny_cfg()
    dec = harness.vlm_config(cfg).decoder
    assert [dec.block_kind(i) for i in range(6)] == DECODER["layer_types"]
    assert [dec.block_moe(i) for i in range(6)] == [False, False, True, True, True, True]
    assert ref_lfm2.moe_blocks(cfg) == [dec.block_moe(i) for i in range(6)]
    assert dec.expert_dim == 32 and dec.mlp_dim == 128
    model, w = _model(cfg, 0)
    names = set(model.state_dict())
    assert names == set(w)
    assert set(weights_lfm2.buffers(cfg)) == {f"decoder.blocks.{i}.mlp.expert_bias" for i in range(2, 6)}
    assert not any(k.endswith("expert_bias") for k, _ in model.named_parameters())


@pytest.mark.parametrize("bad", [{"layer_types": ["conv"] * 5}, {"layer_types": ["conv"] * 5 + ["mamba"]},
                                 {"router": "softmax"}, {"router": "switch", "experts_per_token": 2}])
def test_decoder_config_refuses(bad):
    with pytest.raises(ValueError):
        tconfigs.DecoderConfig(**{**DECODER, **bad})


def test_decoder_matches_the_reference():
    cfg = tiny_cfg()
    model, w = _model(cfg, 1)
    x = torch.randn(2, 40, DECODER["dim"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), exact_float32():
        got = model.decoder(x)
        want = _reference(cfg, w).logits(_reference(cfg, w).decode(x, []))
        fp8 = _reference(cfg, w, prec=Precision(low=True))
        low = fp8.logits(fp8.decode(x, []))
        plain = _reference(cfg, w)
        plain.norm = lambda t, name, _n=plain.norm: t if name.endswith(("q_norm.scale", "k_norm.scale")) else _n(t, name)
        no_qk = plain.logits(plain.decode(x, []))
    assert _rel(got, want) <= DECODER_TOL
    assert _rel(low, want) > 100 * DECODER_TOL
    assert _rel(no_qk, want) > 100 * DECODER_TOL


def _loss_and_grads(cfg, seed, prec=None):
    from vision_compression_project_tpu_torch.train.data import device_batch
    from vision_compression_project_tpu_torch.train.train_step import vlm_loss

    batch = traffic.host_batches(TRAFFIC, cfg, seed)[0]
    model, w = _model(cfg, seed)
    loss = vlm_loss(model, device_batch(harness.vlm_config(cfg), batch, device="cpu"))
    loss.backward()
    fixed = set(weights_lfm2.buffers(cfg))
    with exact_float32():
        params = {k: v.float().clone().requires_grad_(k not in fixed) for k, v in w.items()}
        ref = ref_lfm2.Lfm2Reference(cfg, params, prec)
        ref_loss = ref.loss(torch.from_numpy(batch["pages_u8"]), torch.from_numpy(batch["token_ids"]).long())
        leaves = [k for k in params if k not in fixed]
        grads = dict(zip(leaves, torch.autograd.grad(ref_loss, [params[k] for k in leaves])))
    return model, float(loss.detach()), float(ref_loss.detach()), grads


def test_loss_and_every_gradient_match_the_reference():
    cfg = tiny_cfg()
    model, loss, ref_loss, grads = _loss_and_grads(cfg, 3)
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for k, g in grads.items():
        assert float((named[k].grad - g).abs().max()) <= 5e-3 * float(g.abs().max()) + 1e-9, k
    # The same bound fails the reference with fp8 expert operands.
    _, _, _, low = _loss_and_grads(cfg, 3, Precision(low=True))
    experts = [k for k in grads if k.endswith(("w_gate", "w_up", "w_down"))]
    assert max(float((low[k] - grads[k]).abs().max()) / float(grads[k].abs().max()) for k in experts) > 5e-3


def test_streamed_reference_steps_equal_optax_adamw():
    """`train_steps`' two passes a step give what one pass with the whole
    gradients and `optim.AdamW` gives."""
    cfg = tiny_cfg()
    batches = traffic.host_batches(TRAFFIC, cfg, 4)
    w = weights_lfm2.make(cfg, 4, "cpu")
    fixed = set(weights_lfm2.buffers(cfg))
    stored = {k: v.dtype for k, v in w.items()}
    with exact_float32():
        every = {k: v.float().clone().requires_grad_(k not in fixed) for k, v in w.items()}
        params = {k: v for k, v in every.items() if k not in fixed}
        found = ref_lfm2.train_steps(ref_lfm2.Lfm2Reference(cfg, every), params, stored, batches, RefAdamW(8e-4),
                                     2, "cpu")
        whole = {k: v.float().clone().requires_grad_(k not in fixed) for k, v in w.items()}
        mine = {k: v for k, v in whole.items() if k not in fixed}
        opt, ref = RefAdamW(8e-4), ref_lfm2.Lfm2Reference(cfg, whole)
        for i in range(2):
            b = batches[i]
            loss = ref.loss(torch.from_numpy(b["pages_u8"]), torch.from_numpy(b["token_ids"]).long())
            grads = RefAdamW.clip(dict(zip(mine, torch.autograd.grad(loss, list(mine.values())))), opt.max_norm)
            if i == 0:
                norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            opt.update(mine, grads, stored)
            assert math.isclose(float(loss.detach()), found["losses"][i], rel_tol=1e-6)
    for k in params:
        assert math.isclose(found["grad_norms"][k], norms[k], rel_tol=1e-5, abs_tol=1e-12), k
        assert torch.allclose(params[k], mine[k], rtol=0, atol=1e-7), k


def test_streamed_steps_hold_bf16_experts_in_bf16():
    """With bf16-stored experts, holding them in bf16 (their exact values,
    computed with in f32) gives the steps of holding them in f32."""
    cfg = tiny_cfg()
    cfg["decoder"]["dtype"] = "bfloat16"
    batches = traffic.host_batches(TRAFFIC, cfg, 8)
    w = weights_lfm2.make(cfg, 8, "cpu")
    fixed = set(weights_lfm2.buffers(cfg))
    stored = {k: v.dtype for k, v in w.items()}
    assert stored["decoder.blocks.2.mlp.w_gate"] == torch.bfloat16
    found = []
    for held in (torch.float32, None):
        with exact_float32():
            every = {k: (v.float() if held else v).clone().requires_grad_(k not in fixed) for k, v in w.items()}
            params = {k: v for k, v in every.items() if k not in fixed}
            out = ref_lfm2.train_steps(ref_lfm2.Lfm2Reference(cfg, every), params, stored, batches, RefAdamW(8e-4),
                                       2, "cpu")
        found.append((out, {k: v.detach().float() for k, v in params.items()}))
    (a, pa), (b, pb) = found
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-6)
    for k in pa:
        assert math.isclose(a["grad_norms"][k], b["grad_norms"][k], rel_tol=1e-5, abs_tol=1e-12), k
        assert torch.allclose(pa[k], pb[k], rtol=0, atol=1e-7), k


def test_one_adamw_step_matches_the_reference():
    from vision_compression_project_tpu_torch.train import data, train_step as ts

    cfg = tiny_cfg()
    batches = traffic.host_batches(TRAFFIC, cfg, 5)
    model, opt, state = ts.make_train_state(harness.vlm_config(cfg), device="cpu", seed=5, lr=TRAFFIC["lr"])
    w = weights_lfm2.make(cfg, 5, "cpu")
    ts.load_whole_params(model, w)
    start = {k: p.detach().clone() for k, p in state.params.items()}
    state, loss = ts.train_step(model, opt, state, data.device_batch(harness.vlm_config(cfg), batches[0],
                                                                     device="cpu"))
    fixed = set(weights_lfm2.buffers(cfg))
    assert not fixed & set(state.params)
    assert all(torch.equal(model.state_dict()[k], w[k]) for k in fixed), "the expert bias moved"
    with exact_float32():
        every = {k: v.float().clone().requires_grad_(k not in fixed) for k, v in w.items()}
        params = {k: v for k, v in every.items() if k not in fixed}
        found = ref_lfm2.train_steps(ref_lfm2.Lfm2Reference(cfg, every), params, {k: v.dtype for k, v in w.items()},
                                     batches, RefAdamW(TRAFFIC["lr"]), 1, "cpu")
    assert abs(float(loss) - found["losses"][0]) <= 1e-4 * abs(found["losses"][0])
    gaps = {}
    for k, p in state.params.items():
        got, want = p.detach() - start[k], params[k].detach() - start[k]
        gaps[k] = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert sorted(gaps.values())[len(gaps) // 2] <= 0.03
    assert max(gaps.values()) <= 0.5, max(gaps, key=gaps.get)


def test_short_conv_is_causal():
    torch.manual_seed(0)
    conv = tlayers.ShortConv(16, 3, dtype="float32")
    tlayers.init_weights_(conv, torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 16)
    for t in (0, 5, 11):
        moved = x.clone()
        moved[:, t] += torch.randn(2, 16)
        with torch.no_grad():
            a, b = conv(x), conv(moved)
        assert torch.equal(a[:, :t], b[:, :t]), t
        assert not torch.allclose(a[:, t], b[:, t]), t


def _moe(seed=0, e=8, k=2, dim=16):
    moe = tlayers.TopKMoE(dim, e, 8, k, dtype="float32")
    tlayers.init_weights_(moe, torch.Generator().manual_seed(seed))
    return moe


def test_the_bias_moves_the_choice_and_not_the_weights():
    moe = _moe()
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        scores = torch.sigmoid(moe.router(x))
        c0, w0 = moe.routing(x)
        moe.expert_bias.copy_(torch.linspace(-0.3, 0.3, 8))
        c1, w1 = moe.routing(x)
    assert (c0 != c1).any()
    same = (c0 == c1).all(dim=1)
    assert same.any() and torch.equal(w0[same], w1[same])
    # Weights are the chosen unbiased scores over their sum (+ 1e-6), whatever the bias.
    picked = scores.gather(1, c1)
    assert torch.allclose(w1, picked / (picked.sum(dim=1, keepdim=True) + 1e-6), rtol=1e-6, atol=0)
    assert torch.allclose(w1.sum(dim=1), torch.ones(64), atol=1e-5)
    # The choice is the top k of the biased scores.
    biased = scores + moe.expert_bias
    assert torch.equal(biased.gather(1, c1).min(dim=1).values >= biased.topk(3).values[:, 2], torch.ones(64, dtype=bool))


def test_ties_go_to_the_lower_index():
    moe = _moe(k=3)
    with torch.no_grad():
        moe.router.weight.zero_()
        choice, w = moe.routing(torch.randn(5, 16))
    assert choice.tolist() == [[0, 1, 2]] * 5
    assert torch.allclose(w, torch.full((5, 3), 1 / 3), atol=1e-6)


def test_no_pair_is_dropped_when_one_expert_takes_every_token():
    cfg = tiny_cfg()
    moe = _moe(seed=2, e=DECODER["num_experts"], k=DECODER["experts_per_token"], dim=DECODER["dim"])
    with torch.no_grad():
        moe.expert_bias[5] = 10.0
    x = torch.randn(3, 20, DECODER["dim"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        choice, _ = moe.routing(x.reshape(60, -1))
        got, aux = moe(x)
    assert aux is None and (choice == 5).any(dim=1).all()
    params = {f"decoder.blocks.2.mlp.{k}": v for k, v in moe.state_dict().items()}
    with exact_float32():
        want = ref_lfm2.Lfm2Reference(cfg, params).topk_moe(x, "decoder.blocks.2.mlp")
    assert _rel(got, want) <= DECODER_TOL


def _runner(cfg, seed):
    from vision_compression_project_tpu_torch.models.vlm import VLMRunner

    return VLMRunner(harness.vlm_config(cfg), params=weights_lfm2.make(cfg, seed, "cpu"), device="cpu")


def test_prefill_then_decode_match_the_full_forward():
    """Rows of three prompt lengths in one prompt bucket: the conv state of
    each row is taken at its own length, and each decode step's logits are
    those of the reference's full forward over the row's real positions."""
    cfg = tiny_cfg()
    runner = _runner(cfg, 6)
    pages = traffic.host_batches({**TRAFFIC, "batch": 3}, cfg, 6)[0]["pages_u8"]
    vis = runner.encode(runner.preprocess_patches(pages))
    prompts = [[BOS_ID, TASK_EXTRACT_ID], [BOS_ID, TASK_EXTRACT_ID, 70, 71, 72], [BOS_ID, 65, 66, 67, 68, 69, 70]]
    ids, lens = runner.pad_prompts(prompts)
    assert ids.shape[1] == 64 and len(set(lens)) == 3
    steps = 6
    with torch.inference_mode():
        logits, caches, kv_len = runner.first_logits(ids, lens, vis, 128)
        assert [set(c) for c in caches] == [{"conv"}, {"conv"}, {"k", "v"}, {"conv"}, {"k", "v"}, {"conv"}]
        served, got = [], [logits]
        tok, pos = logits.argmax(dim=-1), kv_len.long()
        for _ in range(steps):
            served.append(tok)
            step, caches = runner.model.decode_ids(tok, caches, pos)
            got.append(step)
            tok, pos = step.argmax(dim=-1), pos + 1
    got = torch.stack(got, dim=1)                               # (B, steps + 1, vocab)
    served = torch.stack(served, dim=1)
    ref = _reference(cfg, {k: v for k, v in runner.model.state_dict().items()})
    with torch.no_grad(), exact_float32():
        vis_ref = runner.encode(runner.preprocess_patches(pages)).float()
        for r, p in enumerate(prompts):
            row = torch.tensor(p + served[r].tolist())
            x = torch.cat([vis_ref[r:r + 1], ref.embed(row[None])], dim=1)
            want = ref.logits(ref.decode(x, [])[0, vis.shape[1] + len(p) - 1:])
            assert _rel(got[r], want) <= DECODER_TOL, r


def test_the_runner_masks_the_vocabulary_past_the_tokenizer():
    cfg = tiny_cfg()
    cfg["decoder"] = dict(DECODER, tokenizer="bpe", vocab=8192)
    cfg["decoder"]["dim"] = 32
    runner = _runner(cfg, 7)
    mask = runner.logit_mask("extract")
    assert mask.shape == (8192,) and float(mask[4096:].max()) <= -1e29 and float(mask[:4096].max()) == 0.0
    pages = traffic.host_batches({**TRAFFIC, "batch": 2}, cfg, 7)[0]["pages_u8"]
    toks = runner.extract_batch_async(pages, [1, 2], max_new=4)[0]
    assert int(toks.max()) < 4096


class _Mesh:
    """What the port's mesh checks read of a DeviceMesh: dimension names and sizes."""

    mesh_dim_names = (AXIS_DATA, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)

    def __init__(self, **sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes.get(self.mesh_dim_names[i], 1)


@pytest.mark.parametrize("axis", [AXIS_MODEL, AXIS_EXPERT, AXIS_SEQ])
def test_the_new_modules_refuse_a_sharding_mesh(axis):
    conv = tlayers.ShortConv(16, 3, dtype="float32")
    moe = _moe()
    attn = tlayers.Attention(16, 2, 1, 8, causal=True, rope=True, max_seq=32, dtype="float32", qk_norm=True)
    x = torch.randn(1, 4, 16)
    calls = [lambda: conv(x), lambda: conv.prefill(x), lambda: conv.decode(x[:, :1], {"conv": torch.zeros(1, 2, 16)}),
             lambda: moe(x), lambda: attn(x)]
    with use_mesh(_Mesh(**{axis: 2})):
        for call in calls:
            with pytest.raises(NotImplementedError, match=axis):
                call()
    with use_mesh(_Mesh(**{AXIS_DATA: 2})):
        assert conv(x).shape == x.shape and moe(x)[0].shape == x.shape


def test_get_tokenizer_takes_a_wider_vocabulary_only_from_layer_types():
    """A preset's vocabulary equals its BPE's; a decoder built from
    `layer_types` (a published vocabulary) may be wider, never narrower."""
    from vision_compression_project_tpu_torch.models.tokenizer import get_tokenizer

    bpe = {k: v for k, v in DECODER.items() if k not in ("layer_types", "num_dense_layers", "router",
                                                          "experts_per_token", "moe_dim")}
    bpe.update(tokenizer="bpe", num_experts=0)
    assert get_tokenizer(tconfigs.DecoderConfig(**{**bpe, "vocab": 4096})).vocab_size == 4096
    with pytest.raises(ValueError, match="!= model vocab 8192"):
        get_tokenizer(tconfigs.DecoderConfig(**{**bpe, "vocab": 8192}))
    lfm2 = {**DECODER, "tokenizer": "bpe"}
    assert get_tokenizer(tconfigs.DecoderConfig(**{**lfm2, "vocab": 8192})).vocab_size == 4096
    with pytest.raises(ValueError, match="!= model vocab 2048"):
        get_tokenizer(tconfigs.DecoderConfig(**{**lfm2, "vocab": 2048}))


def test_route_loads_are_recorded_after_the_step():
    """A profiled step's `moe.route.load` ranges (one a routing: forward and
    recompute) come after `train.optimizer`, each with the largest expert's
    tokens and the empty experts: no read-back inside forward or backward."""
    from torch.profiler import ProfilerActivity, profile

    from vision_compression_project_tpu_torch.train import data, train_step as ts

    cfg = tiny_cfg()
    model, opt, state = ts.make_train_state(harness.vlm_config(cfg), device="cpu", seed=9, lr=TRAFFIC["lr"])
    ts.load_whole_params(model, weights_lfm2.make(cfg, 9, "cpu"))
    batch = data.device_batch(harness.vlm_config(cfg), traffic.host_batches(TRAFFIC, cfg, 9)[0], device="cpu")
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        ts.train_step(model, opt, state, batch)
    events = [(e.name(), e.start_ns(), e.concrete_inputs()) for e in prof.profiler.kineto_results.events()]
    loads = [e for e in events if e[0] == "moe.route.load"]
    optimizer = max(start for name, start, _ in events if name == "train.optimizer")
    assert len(loads) == 2 * sum(harness.vlm_config(cfg).decoder.block_moe(i) for i in range(6))
    for _, start, (biggest, empty) in loads:
        assert start > optimizer
        assert biggest >= 1 and biggest == int(biggest)
        assert 0 <= empty < DECODER["num_experts"] and empty == int(empty)
    assert not tlayers._ROUTE_LOADS


@pytest.fixture(scope="module")
def check_readings():
    """The LFM2 cell's check (drivers/train_lfm2.py) at the tiny size with a
    bf16 decoder, as the cell runs it: the sound program, the control (the
    reference with fp8 operands in its place) and the planted faults, each
    checked by a reference run that takes its routing."""
    import types

    from portbench import control_lfm2

    cfg = tiny_cfg()
    cfg["decoder"]["dtype"] = "bfloat16"
    cell = types.SimpleNamespace(config=cfg, traffic={**TRAFFIC, "checked_steps": 3})
    return control_lfm2.readings(cell, 1, torch.device("cpu"), ("control",) + control_lfm2.FAULTS)


def test_the_check_tells_the_program_from_the_control_and_the_faults(check_readings):
    """With the routing shared, the sound bf16 program reads 0.030-0.036 on
    the median leaf's first-gradient gap (0.0 on the routing weights, the
    same f32 formula on its own logits), the control 0.41-0.45, half a
    batch 0.71-0.74 and the state left unchanged 0.99; the bias weighing the
    outputs reads 0.009-0.010 on the routing weights, and the bias left out
    of the selection 0.030-0.032 on the routing's choices (0.0 sound; seeds 1
    and 2). The bounds sit between."""
    r = check_readings
    sound = r["program"]
    assert sound["grad_vec_gap_median"] < 0.1 and sound["route_miss"] < 0.1
    assert sound["route_weight_gap"] < 1e-6 and sound["route_choice_gap"] == 0.0
    for name in ("control", "half_batch", "unchanged"):
        assert r[name]["grad_vec_gap_median"] > 0.3, name
    assert r["half_batch"]["route_miss"] == 1.0
    assert r["bias_in_weights"]["route_weight_gap"] > 1e-3
    assert r["bias_ignored"]["route_choice_gap"] > 1e-2
