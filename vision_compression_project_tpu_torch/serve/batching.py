"""Request-coalescing batch executor: the port's copy of
vision_compression_project_tpu/serve/batching.py.

The serving-side replacement for the reference's thread-per-page concurrency
(reference: backend/app/pipeline/pdf_extract.py:328,
supermemory_ingest.py:215): concurrent requests are coalesced into one
device batch (up to max_batch, waiting at most max_wait_ms for co-riders),
which is how an accelerator wants its work — few large launches, not many
tiny ones.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional


class _Job:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class BatchingQueue:
    """Calls `fn_batch(list_of_items) -> list_of_results` on coalesced jobs."""

    def __init__(
        self,
        fn_batch: Callable[[List[Any]], List[Any]],
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
        name: str = "batcher",
    ):
        self.fn_batch = fn_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def submit(self, item, timeout: Optional[float] = None):
        job = _Job(item)
        self._queue.put(job)
        if not job.event.wait(timeout):
            raise TimeoutError("batched call timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout=2)

    def _loop(self):
        while not self._stop.is_set():
            first = self._queue.get()
            if first is None:
                continue
            batch = [first]
            # Collect co-riders for up to max_wait.
            t_end = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                results = self.fn_batch([j.item for j in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch fn returned {len(results)} results for {len(batch)} items"
                    )
                for job, res in zip(batch, results):
                    job.result = res
            except BaseException as exc:  # propagate to every waiter
                for job in batch:
                    job.error = exc
            finally:
                for job in batch:
                    job.event.set()
