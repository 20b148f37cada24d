"""Readings of the program's own ranges on the profiler's clock
(vision_compression_project_tpu_torch/utils/metrics.py): `train.feed`,
`train.forward`, `train.backward` and `train.optimizer` around the phases
of a training step, `moe.forward` and `moe.backward` around Switch-MoE's
forward and backward. A program without them gives no reading: the readers
return None and the metric is left out."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Spans = List[Tuple[int, int]]


def _merged(spans) -> Spans:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_ns(a: Spans, b: Spans) -> int:
    """Nanoseconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _gaps(trace) -> Spans:
    """The traced window's stretches with no device operation running."""
    w0, w1 = trace.window
    gaps, prev = [], w0
    for s, e in trace._intervals():
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def idle_ms(ctx, name: str) -> Optional[float]:
    """Device idle milliseconds a traced unit while the host was inside the
    range `name`: the window's gaps between merged device intervals,
    intersected with every instance of the range; None where it never ran."""
    trace = ctx.trace
    if trace.window is None:
        return None
    ranges = [(s, e) for n, s, e, _ in trace.host_ops if n == name]
    if not ranges:
        return None
    return 1e-6 * _overlap_ns(_gaps(trace), _merged(ranges)) / ctx.trace_units


def launched_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device milliseconds a traced unit of the operations launched inside
    the ranges `names` (`Traced.span_device_s` of each, summed); None where
    none of them launched anything."""
    seconds = sum(ctx.trace.span_device_s(n) for n in names)
    return None if seconds <= 0 else 1e3 * seconds / ctx.trace_units
