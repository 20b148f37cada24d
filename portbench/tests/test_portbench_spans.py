"""The readers of the program's ranges (metrics/_spans.py) on hand-built
traces: device idle time inside `train.*` ranges and device time launched
inside Switch-MoE's `moe.*` ranges."""

import types

import pytest
import torch

from portbench import spec
from portbench.tracing import Traced

IDLE = ["feed_idle_ms.train", "forward_idle_ms.train", "backward_idle_ms.train", "optimizer_idle_ms.train"]
MS = 1_000_000  # ns


def _ctx(device_ops, host_ops, window=(0, 100), units=1):
    trace = Traced(torch.device("cpu"))
    trace.device_ops = [(n, s * MS, e * MS, c) for n, s, e, c in device_ops]
    trace.host_ops = [(n, s * MS, e * MS, c) for n, s, e, c in host_ops]
    trace.window = (window[0] * MS, window[1] * MS)
    return types.SimpleNamespace(trace=trace, trace_units=units)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_a_gap_that_straddles_a_range_edge_counts_only_inside():
    # Device busy 0-10, 30-60, 90-100; gaps 10-30 and 60-90. The feed runs
    # 5-20 (10 ms of the first gap), the forward 20-70 (10 + 10), the
    # backward 70-95 (20), the optimizer never.
    ctx = _ctx([("k", 0, 10, 1), ("k", 30, 45, 2), ("k", 40, 60, 3), ("k", 90, 100, 4)],
               [("train.feed", 5, 20, 0), ("train.forward", 20, 70, 0), ("train.backward", 70, 95, 0)])
    got = {n: _read(n, ctx) for n in IDLE}
    assert got == pytest.approx({"feed_idle_ms.train": 10.0, "forward_idle_ms.train": 20.0,
                                 "backward_idle_ms.train": 20.0, "optimizer_idle_ms.train": None})


def test_two_instances_of_a_range_sum_over_the_units():
    # Two steps: the feed at 0-10 and 50-60 against a device busy 5-55.
    ctx = _ctx([("k", 5, 55, 1)], [("train.feed", 0, 10, 0), ("train.feed", 50, 60, 0)], units=2)
    assert _read("feed_idle_ms.train", ctx) == pytest.approx((5 + 5) / 2)


def test_ranges_past_the_window_and_idle_tail():
    # The range runs past the window's end; the device is idle 80-100.
    ctx = _ctx([("k", 0, 80, 1)], [("train.optimizer", 70, 130, 0)])
    assert _read("optimizer_idle_ms.train", ctx) == pytest.approx(20.0)


def test_a_range_that_never_ran_leaves_the_metric_out():
    """A program without the ranges (the parent's) gives no reading, and
    raises nothing."""
    ctx = _ctx([("k", 0, 10, 1)], [("aten::mm", 0, 5, 0), ("cudaLaunchKernel", 1, 2, 1)])
    assert all(_read(n, ctx) is None for n in IDLE + ["moe_ms.train"])


def test_moe_ms_sums_both_ranges_by_launch():
    """Kernels launched inside `moe.forward` (twice: forward and recompute)
    and inside `moe.backward` count, wherever they run; a kernel launched
    outside does not, even while a range is open on the host."""
    host = [("moe.forward", 0, 10, 0), ("cudaLaunchKernel", 1, 2, 1), ("moe.forward", 40, 50, 0),
            ("cudaLaunchKernel", 41, 42, 2), ("moe.backward", 60, 80, 0), ("cudaLaunchKernel", 61, 62, 3),
            ("cudaLaunchKernel", 62, 63, 4), ("cudaLaunchKernel", 85, 86, 5)]
    device = [("bmm", 2, 6, 1), ("bmm", 42, 45, 2), ("bmm_bwd", 63, 70, 3), ("cat", 70, 71, 4),
              ("attn", 86, 99, 5)]
    ctx = _ctx(device, host, units=2)
    assert _read("moe_ms.train", ctx) == pytest.approx((4 + 3 + 7 + 1) / 2)
    only_forward = _ctx(device, host[:4], units=2)
    assert _read("moe_ms.train", only_forward) == pytest.approx((4 + 3) / 2)
