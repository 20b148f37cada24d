"""Vector-index scale measurement: the port of scripts/bench_index.py, with
its arguments and its one JSON line.

Ingests --n synthetic page embeddings in --batch chunks and reports add()
wall-time percentiles (first/p50/max: amortized doubling makes the max a
reallocation, the p50 the steady state), search p50/p95 at checkpoints of
growing corpus size, and sharded-search p50 over the mesh's `data`
dimension with the rebuild counter (the shard copies are kept up to date by
`add`, not re-uploaded after it). Rows live on RUNTIME.device (VCP_DEVICE,
the card unless it says "cpu"); the mesh is `local_mesh()` (VCP_MESH_*).
Rank 0 prints the line. One rank, N ranks through the launcher, or torchrun:

    python -m vision_compression_project_tpu_torch.scripts.bench_index [--n 100000]
    python -m vision_compression_project_tpu_torch.scripts.bench_index --nproc 4
    torchrun --nproc_per_node 4 -m vision_compression_project_tpu_torch.scripts.bench_index
"""

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import config

SEARCH_REPS = 5  # timed calls of each search measurement, after one warm call


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--queries", type=int, default=32)
    parser.add_argument("--topk", type=int, default=8)
    parser.add_argument("--nproc", type=int, default=1, help="ranks to start with the launcher (parallel.spawn)")
    return parser.parse_args(argv)


def bench(args: argparse.Namespace) -> dict:
    """The measurement on this rank, in an initialised process group."""
    from ..index.vector_index import VectorIndex
    from ..parallel import local_mesh

    device = torch.device(config.RUNTIME.device)
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def unit_rows(n):
        rows = rng.standard_normal((n, args.dim)).astype(np.float32)
        return rows / np.linalg.norm(rows, axis=1, keepdims=True)

    queries = unit_rows(args.queries)

    def search_ms(fn):
        fn()  # warm
        times = []
        for _ in range(SEARCH_REPS):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.percentile(times, 50)), float(np.percentile(times, 95))

    index = VectorIndex(dim=args.dim, capacity=args.batch, device=device)
    add_times = []
    checkpoints = {}
    marks = sorted({args.n // 10, args.n // 2, args.n})
    added, doc_i = 0, 0
    t_total = time.perf_counter()
    while added < args.n:
        n = min(args.batch, args.n - added)
        rows = unit_rows(n)
        t = time.perf_counter()
        index.add(rows, [{"doc_id": f"doc{doc_i}", "page": i} for i in range(n)])
        sync()
        add_times.append((time.perf_counter() - t) * 1e3)
        added += n
        doc_i += 1
        if any(m <= added < m + args.batch for m in marks):
            p50, p95 = search_ms(lambda: index.search(queries, top_k=args.topk)[0][0]["score"])
            checkpoints[added] = {"search_p50_ms": p50, "search_p95_ms": p95}
    ingest_s = time.perf_counter() - t_total

    mesh = local_mesh(device.type)  # honors VCP_MESH_*
    sh_p50, sh_p95 = search_ms(lambda: index.search_sharded(mesh, queries, top_k=args.topk))
    rebuilds_before = index.shard_rebuilds
    probe = unit_rows(4)
    ids = index.add(probe, [{"doc_id": "probe", "page": i} for i in range(4)])
    t = time.perf_counter()
    hits = index.search_sharded(mesh, probe[:1], top_k=1)
    post_add_ms = (time.perf_counter() - t) * 1e3
    if hits[0][0]["id"] != ids[0]:
        raise RuntimeError(f"sharded search after add found {hits[0][0]['id']}, not the added row {ids[0]}")
    if index.shard_rebuilds != rebuilds_before:
        raise RuntimeError("add forced a full rebuild of the shard copies")

    return {
        "n_rows": args.n, "dim": args.dim, "batch": args.batch,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "n_devices": dist.get_world_size(),
        "ingest_total_s": round(ingest_s, 2),
        "ingest_rows_per_s": round(args.n / ingest_s),
        "add_ms_first": round(add_times[0], 2),
        "add_ms_p50": round(float(np.percentile(add_times, 50)), 2),
        "add_ms_max": round(max(add_times), 2),
        "search_p50_by_size": checkpoints,
        "sharded_search_p50_ms": round(sh_p50, 2),
        "sharded_search_p95_ms": round(sh_p95, 2),
        "sharded_search_after_add_ms": round(post_add_ms, 2),
        "shard_rebuilds": index.shard_rebuilds,
    }


def main(argv=None) -> int:
    from ..parallel import initialize_multihost, spawn

    args = parse_args(argv)
    device_type = torch.device(config.RUNTIME.device).type
    if args.nproc > 1:
        out = spawn(bench, args.nproc, args, device_type=device_type)[0]
    else:
        started = not dist.is_initialized()
        initialize_multihost(device_type=device_type)
        rank = dist.get_rank()
        try:
            out = bench(args)
        finally:
            if started:
                dist.destroy_process_group()
        if rank != 0:
            return 0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
