"""Per-stage wall-clock timers and counters: the port's copy of
vision_compression_project_tpu/utils/metrics.py (MetricsRegistry, METRICS),
with ranges on the torch profiler's clock in place of its jax.profiler
helpers.

`METRICS.timer(name)` keeps a wall-clock stat, which `/metrics` serves;
`span(name)` keeps none, for work inside the model, where the host's time
of asynchronous device work means little. While a torch profiler records,
both open a range of that name on the profiler's host clock, which kineto
aligns with the CUDA device's timestamps, so a trace sets device work and
idle gaps against it; otherwise they open none, and the check costs a read
of a module attribute. `args`, a number or a tuple of numbers, is recorded
as the range's inputs (a trace made with `record_shapes=True` shows them):
the training step passes its step count, which the ranges of one step
share; `TopKMoE` passes its routing's load."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler records now, in any thread."""
    return _autograd_profiler._is_profiler_enabled


class Range:
    """One profiler range: `__enter__` opens it and `__exit__` closes it,
    which may happen in two different calls (the Switch-MoE's backward
    range opens in one autograd node and closes in another); closing a
    range that never opened does nothing."""

    __slots__ = ("name", "args", "_handle")

    def __init__(self, name: str, args: Union[None, float, Tuple[float, ...]] = None):
        self.name, self.args, self._handle = name, args, None

    def __enter__(self):
        inputs = () if self.args is None else self.args if isinstance(self.args, tuple) else (self.args,)
        self._handle = torch._C._autograd._record_function_with_args_enter(self.name, *inputs)
        return self

    def __exit__(self, *exc):
        if self._handle is not None:
            torch._C._autograd._record_function_with_args_exit(self._handle)
            self._handle = None
        return False


def span(name: str, args: Optional[float] = None):
    """A profiler range named `name` around the block while a profiler
    records; nothing otherwise."""
    return Range(name, args) if profiling() else _OFF


class _Stat:
    __slots__ = ("count", "total", "minimum", "maximum")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = 0.0

    def add(self, value: float):
        self.count += 1
        self.total += value
        self.minimum = min(self.minimum, value)
        self.maximum = max(self.maximum, value)

    def as_dict(self) -> Dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "total": round(self.total, 6),
            "mean": round(self.total / self.count, 6),
            "min": round(self.minimum, 6),
            "max": round(self.maximum, 6),
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._timers: Dict[str, _Stat] = defaultdict(_Stat)
        self._counters: Dict[str, float] = defaultdict(float)
        self._started = time.time()

    @contextlib.contextmanager
    def timer(self, name: str, args: Optional[float] = None):
        """The block's wall-clock time into the stat `name`, and, while a
        profiler records, a range of that name around it (`span`)."""
        t0 = time.perf_counter()
        try:
            with span(name, args):
                yield
        finally:
            elapsed = time.perf_counter() - t0
            with self._lock:
                self._timers[name].add(elapsed)

    def count(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "uptime_s": round(time.time() - self._started, 1),
                "timers": {k: v.as_dict() for k, v in self._timers.items()},
                "counters": dict(self._counters),
            }
        # Derived throughputs.
        timers, counters = out["timers"], out["counters"]
        extract = timers.get("extract.batch", {})
        if extract.get("total") and counters.get("extract.pages"):
            out["pages_per_sec"] = round(
                counters["extract.pages"] / extract["total"], 3
            )
        return out

    def reset(self):
        with self._lock:
            self._timers.clear()
            self._counters.clear()


METRICS = MetricsRegistry()
