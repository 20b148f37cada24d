"""Per-stage wall-clock timers and counters: the port's copy of
vision_compression_project_tpu/utils/metrics.py (MetricsRegistry, METRICS),
without its profiler helpers."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


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
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
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
