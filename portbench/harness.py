"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, the device record and the last line.

The window: units of work (a training step, an extraction batch) one after
another until `seconds` have passed, then the device is synchronised; a rate
is all the work over all that time. Set-up is everything from the process's
start to the window's: imports, CUDA, weights, the program's own set-up and
the warm-up units. With `trace`, a few more units run under the profiler
after the window, and the cell's per-layer metrics are read from them.
Then the program's state is freed and the reference runs."""

from __future__ import annotations

import gc
import importlib
import json
import math
import shutil
import subprocess
import sys
import time
import types
from typing import Dict, Optional

import torch

from . import spec as spec_mod
from .tracing import Traced

FORBIDDEN = ("jax", "jaxlib", "flax", "vision_compression_project_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def vlm_config(cfg: dict):
    """The port's VLMConfig for a configuration file."""
    from vision_compression_project_tpu_torch.models.configs import DecoderConfig, VisionConfig, VLMConfig

    return VLMConfig(vision=VisionConfig(**cfg["vision"]), decoder=DecoderConfig(**cfg["decoder"]))


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def power_limit() -> Optional[str]:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": readings.get(k, float("nan")), "limit": limits[k]} for k in limits}


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """Run `cell` once; returns the result's dict (the last line's object)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    mod = driver(cell.traffic["kind"])
    run = mod.Run(cell.config, vlm_config(cell.config), cell.traffic, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        run.unit()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    traced = None
    if trace:
        with Traced(dev) as traced:
            for _ in range(cell.traffic["trace_units"]):
                run.unit(traced=True)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = run.window_stats(window_s)
    run.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = run.check()
    print(f"portbench: the check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = judge(readings, cell.limits)
    correct = window["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **run.end_to_end(window)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(cfg=cell.config, traffic=cell.traffic, window=window, trace=traced,
                                    trace_units=cell.traffic["trace_units"])
        for m in cell.per_layer:
            value = spec_mod.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    record = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if dev.type == "cuda":
        record["power_limit"] = power_limit()
    if traced is not None:
        record["busy_s"] = traced.busy_s()
        record["window_s"] = traced.window_s()
    result = {"correct": bool(correct), "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": record}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.top_device_ops(), "idle_gaps": traced.idle_by_host()}
    result.update(setup_s=setup_s, window_s=window_s, readings=readings)
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec_mod.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value in result.pop("readings").items():
        if name not in result["checks"]:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
