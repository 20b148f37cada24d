"""The port's ranges on the torch profiler's clock (utils/metrics.py): the
training step's `train.feed`, `train.forward`, `train.backward` and
`train.optimizer`, and Switch-MoE's `moe.forward` and `moe.backward`.

With no profiler they open nothing and change nothing; under a CPU profiler
they appear once a step in the step's order, carry the step, and the MoE's
backward range holds the experts' gradients and nothing of the attention."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vision_compression_project_tpu_torch.models.configs import get_preset
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID
from vision_compression_project_tpu_torch.train import data as tdata
from vision_compression_project_tpu_torch.train import train_step as tts
from vision_compression_project_tpu_torch.utils import metrics as tmetrics

STEP_RANGES = ["train.feed", "train.forward", "train.backward", "train.optimizer"]
NODE = "autograd::engine::evaluate_function: "


def _host_batch(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 200, (2, 48))
    ids[:, 0] = BOS_ID
    return {"pages_u8": rng.integers(0, 256, (2, 80, 62), dtype=np.uint8), "token_ids": ids}


def _step(preset: str, steps_before: int = 0, profiled: bool = False, record_shapes: bool = False):
    """(model, state, loss, events): a fresh train state of `preset` after
    `steps_before` steps, then one step (device_batch and train_step), under
    a CPU profiler if `profiled`; events as (name, start, end, inputs)."""
    cfg = get_preset(preset)
    model, opt, state = tts.make_train_state(cfg, device="cpu", seed=0, lr=1e-3)
    for i in range(steps_before):
        tts.train_step(model, opt, state, tdata.device_batch(cfg, _host_batch(i + 1), device="cpu"))

    def one():
        return tts.train_step(model, opt, state, tdata.device_batch(cfg, _host_batch(), device="cpu"))[1]

    if not profiled:
        return model, state, one(), []
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        loss = one()
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.concrete_inputs())
                     for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])
    return model, state, loss, events


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(events, outer):
    return [e for e in events if outer[1] <= e[1] and e[2] <= outer[2] and e is not outer]


@pytest.mark.parametrize("kind", ["timer", "span"])
def test_no_range_opens_without_a_profiler(kind, monkeypatch):
    """Off, neither opens a profiler range (counted at the call that would
    open one, and at record_function); the timer's wall-clock stat is kept.
    Under a profiler the same call opens one."""
    opened = []
    real = torch._C._autograd._record_function_with_args_enter
    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter",
                        lambda *a: opened.append(a[0]) or real(*a))
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: opened.append(self.name) or self)
    registry = tmetrics.MetricsRegistry()

    def call():
        block = registry.timer("extract.batch") if kind == "timer" else tmetrics.span("moe.forward")
        with block:
            torch.ones(4).sum()

    call()
    assert opened == [] and not tmetrics.profiling()
    assert registry.snapshot()["timers"].get("extract.batch", {}).get("count", 0) == (kind == "timer")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tmetrics.profiling()
        call()
    assert opened == ["extract.batch" if kind == "timer" else "moe.forward"]


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_a_profiled_step_is_bit_equal(preset):
    """The same step with and without a profiler: loss, every gradient and
    every parameter bit for bit (the MoE's identity nodes included)."""
    plain_model, plain, plain_loss, _ = _step(preset)
    traced_model, traced, traced_loss, events = _step(preset, profiled=True)
    assert _named(events, "train.backward")
    assert (preset == "tiny_moe") == bool(_named(events, "moe.backward"))
    assert _bits(plain_loss) == _bits(traced_loss)
    for name, p in plain.params.items():
        q = traced.params[name]
        assert _bits(p.grad) == _bits(q.grad), name
        assert _bits(p) == _bits(q), name


@pytest.fixture(scope="module")
def moe_trace():
    """A profiled tiny_moe step after two earlier steps, with the ranges'
    inputs recorded."""
    return _step("tiny_moe", steps_before=2, profiled=True, record_shapes=True)[3]


def test_step_ranges_in_order_and_carry_the_step(moe_trace):
    ranges = [e for e in moe_trace if e[0] in STEP_RANGES]
    assert [e[0] for e in ranges] == STEP_RANGES
    assert all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))
    # train_step's three ranges carry the step (2 steps before this one); the feed knows none.
    assert [e[3] for e in ranges] == [[], [2], [2], [2]]


def test_moe_backward_holds_the_experts_and_no_attention(moe_trace):
    """Two MoE blocks: two `moe.backward` ranges, each with the experts'
    three batched products' gradients, the router's one softmax, no
    attention node and no `moe.forward` (the remat recompute runs before
    the range opens); `moe.forward` four times (forward and recompute)."""
    backward = _named(moe_trace, "moe.backward")
    assert len(backward) == 2 and len(_named(moe_trace, "moe.forward")) == 4
    train_backward = _named(moe_trace, "train.backward")[0]
    for rng in backward:
        assert train_backward[1] <= rng[1] and rng[2] <= train_backward[2]
        inner = _inside(moe_trace, rng)
        nodes = collections.Counter(e[0][len(NODE):] for e in inner if e[0].startswith(NODE))
        assert nodes["BmmBackward0"] == 3 and nodes["SoftmaxBackward0"] == 1, nodes
        assert not any("Attention" in n for n in nodes), nodes
        assert not [e for e in inner if e[0] == "moe.forward"]


def test_snapshot_serves_extract_and_train_timers(monkeypatch):
    """A fresh registry in the feed and the step: after one step and one
    extraction batch, /metrics' snapshot holds both, and pages_per_sec."""
    registry = tmetrics.MetricsRegistry()
    monkeypatch.setattr(tdata, "METRICS", registry)
    monkeypatch.setattr(tts, "METRICS", registry)
    _step("tiny")
    with registry.timer("extract.batch"):
        registry.count("extract.pages", 4)
    snap = registry.snapshot()
    assert set(snap["timers"]) == {"extract.batch", *STEP_RANGES}
    assert all(snap["timers"][k]["count"] == 1 for k in STEP_RANGES)
    assert snap["counters"] == {"train.pages": 2.0, "extract.pages": 4.0}
    assert snap["pages_per_sec"] > 0
