"""The traced stretch of a run: torch.profiler over a few units of work after
the measured window, reduced to what the per-layer metrics read.

`Traced` records the device's operations (kernels, copies, fills) with their
start and length, the host's operations, and the benchmark's own spans
(`span(name)`, a record_function range around a call into one layer). The
traced window is the span `portbench.window`, which starts and ends on a
synchronised device; busy time is the union of device operations inside it."""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
# How many earlier host operations a gap's start looks through for one that still runs.
_LOOKBACK = 256


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named range on the host; device work launched inside it is
    attributed to it."""
    with record_function(name):
        yield


def _on_device(ev) -> bool:
    """A device operation (kernel, copy, fill), not a host event and not the
    device-side shadow of a host range (the benchmark's spans)."""
    if "cuda" not in str(ev.device_type()).lower():
        return False
    if ev.name().startswith(SPAN_PREFIX):
        return False
    return not bool(getattr(ev, "is_user_annotation", lambda: False)())


class Traced:
    """Profile the block; afterwards `device`, `host`, `window` hold the
    reduced trace (times in ns on the profiler's clock)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.device_ops: List[Tuple[str, int, int, int]] = []   # name, start, end, correlation
        self.host_ops: List[Tuple[str, int, int, int]] = []     # name, start, end, correlation
        self.window: Optional[Tuple[int, int]] = None
        self._prof = None

    def __enter__(self):
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._sync()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self) -> None:
        for ev in self._prof.profiler.kineto_results.events():
            start = int(ev.start_ns())
            end = start + int(ev.duration_ns())
            corr = int(getattr(ev, "correlation_id", lambda: 0)())
            name = ev.name()
            if _on_device(ev):
                self.device_ops.append((name, start, end, corr))
            elif "cuda" in str(ev.device_type()).lower():
                continue
            elif name == WINDOW:
                self.window = (start, end)
            else:
                self.host_ops.append((name, start, end, corr))
        self._prof = None

    # -- readings ------------------------------------------------------------
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in self.device_ops if e > w0 and s < w1)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._intervals()) * 1e-9

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e, _ in self.device_ops if rx.search(name)) * 1e-9

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside every instance
        of the benchmark's span `name` (by the launch's correlation id)."""
        ranges = sorted((s, e) for n, s, e, _ in self.host_ops if n == name)
        if not ranges:
            return 0.0
        starts = [s for s, _ in ranges]
        launched = set()
        for n, s, _, corr in self.host_ops:
            if corr and n.startswith("cu"):
                i = bisect.bisect_right(starts, s) - 1
                if i >= 0 and s <= ranges[i][1]:
                    launched.add(corr)
        return sum(e - s for _, s, e, corr in self.device_ops if corr in launched) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.device_ops:
            total[name] += e - s
        return [[name, ns * 1e-9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Device idle time inside the window, summed by the innermost host
        operation running where each gap starts; the n largest."""
        w0, w1 = self.window
        gaps, prev = [], w0
        for s, e in self._intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        host = sorted((s, e, name) for name, s, e, _ in self.host_ops if name != WINDOW)
        starts = [s for s, _, _ in host]
        total: Dict[str, int] = defaultdict(int)
        for g0, g1 in gaps:
            # The latest-started host operation still running at g0 is the innermost.
            best = "host between operations"
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(i - _LOOKBACK, -1), -1):
                if host[j][1] >= g0:
                    best = host[j][2]
                    break
            total[best] += g1 - g0
        return [[name, ns * 1e-9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
