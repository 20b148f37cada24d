"""Run a function on N ranks, each a fresh process with the default process
group initialised: what torchrun does for a script, for one function call.

    results = spawn(fn, 4, *args, device_type="cpu", timeout_s=120)

Each rank is a `spawn`-started process (no fork: the caller may hold
threads) that sets `torch.set_num_threads(1)`, joins the group through a
`FileStore` in a temporary directory of its own (no port to pick, so two
launches at once cannot clash), calls `fn(*args)` and sends back its
result; `spawn` returns the results in rank order. `fn` and `args` are
pickled, so `fn` is a module-level function of a module that the child can
import (importing it must not pull in anything the rank should not load).
The first exception raised in a rank is raised again in the caller, its
traceback in a note; a rank that exits without a result, or a launch that
outlives `timeout_s`, raises too. Every rank still running then is killed.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List

_POLL_S = 0.5


def _rank_main(fn: Callable, args: tuple, rank: int, world_size: int, store: str, device_type: str,
               results: multiprocessing.Queue) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import initialize_multihost

    torch.set_num_threads(1)
    try:
        initialize_multihost(f"file://{store}", world_size, rank, device_type)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as exc:  # noqa: BLE001 - sent to the caller, which raises it
        text = traceback.format_exc()
        try:
            pickle.dumps(exc)
        except Exception:  # noqa: BLE001 - an exception that does not pickle goes as text
            exc = RuntimeError(f"{type(exc).__name__}: {exc}")
        results.put((rank, False, (exc, text)))


def spawn(fn: Callable, world_size: int, *args: Any, device_type: str = "cuda",
          timeout_s: float = 300.0) -> List[Any]:
    """fn(*args) on `world_size` ranks; the ranks' return values in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="vcp-ranks-") as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world_size, store, device_type, results),
                             name=f"rank{r}", daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=_POLL_S)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"spawn: {world_size - len(got)} of {world_size} ranks still running "
                                           f"after {timeout_s} s; killed") from None
                    lost = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                    if lost:
                        raise RuntimeError(f"spawn: rank {lost[0]} exited with code {procs[lost[0]].exitcode} "
                                           "without a result")
                    continue
                if not ok:
                    exc, text = payload
                    exc.add_note(f"raised in rank {rank} of {world_size}:\n{text}")
                    raise exc
                got[rank] = payload
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(world_size)]
