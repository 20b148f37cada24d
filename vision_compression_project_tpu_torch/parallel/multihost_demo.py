"""Multi-process launch recipe: one process per host, one global mesh. The
port of vision_compression_project_tpu/parallel/multihost_demo.py over
torch.distributed.

Every process runs the same command apart from --process_id and starts
--local_ranks ranks of its own (one per device of its host), so the world
is num_processes x local_ranks ranks in one process group, joined through
a TCP store at the coordinator (`tcp://<coordinator>`). The mesh puts
--model ranks of each process on `model` and the rest on `data`, so the
`data` dimension spans the processes: the gradient all-reduce, once a step,
is the collective that crosses hosts. Each rank runs the sharded train step
of the `tiny` preset (train/train_step.py) on the same batch, drawn from
numpy's default_rng(0) on every process, and takes its own `data` rows.

    python -m vision_compression_project_tpu_torch.parallel.multihost_demo \\
        --coordinator <host0>:9876 --num_processes 2 --process_id $I \\
        --model 2 --local_ranks 2 --steps 3

On one machine, for a check without cards: `--device cpu` (gloo) and the
processes started side by side with coordinator localhost:<free port>
(tests/test_torch_multihost.py does that).
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys


def _rank(args, local_rank: int) -> None:
    """One rank: join the group, build the mesh, check that `data` spans the
    processes, and run the train steps; local rank 0 prints the process's
    lines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models import get_preset
    from ..models.tokenizer import PAD_ID
    from ..train.train_step import make_train_state, train_step
    from .mesh import MeshConfig, build_mesh, initialize_multihost
    from .sharding import shard_batch

    torch.set_num_threads(1)
    world = args.num_processes * args.local_ranks
    rank = args.process_id * args.local_ranks + local_rank
    if args.device == "cuda":
        torch.cuda.set_device(local_rank)
    initialize_multihost(f"tcp://{args.coordinator}", world, rank, args.device)
    try:
        say = print if local_rank == 0 else (lambda *a, **k: None)
        mesh = build_mesh(MeshConfig(model=args.model), args.device)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        say(f"proc {args.process_id}: mesh {shape} over {world} devices "
            f"({args.num_processes} processes x {args.local_ranks} local)", flush=True)
        # The data dimension must span processes: that is the cross-host claim under test.
        data_procs = {int(r) // args.local_ranks for r in mesh.mesh[:, 0, 0, 0].flatten()}
        assert len(data_procs) == args.num_processes, (
            f"data axis stays inside processes {data_procs}; the cross-host path is never exercised")

        cfg = get_preset("tiny")
        model, opt, state = make_train_state(cfg, args.device, lr=1e-2, mesh=mesh)
        rng = np.random.default_rng(0)
        grid, patch_dim = cfg.vision.grid, cfg.vision.patch ** 2 * 3
        ids = rng.integers(0, 255, size=(args.batch, 16)).astype(np.int64)
        ids[:, -3:] = PAD_ID
        host_batch = {
            "patch_tokens": torch.from_numpy(rng.standard_normal((args.batch, grid * grid, patch_dim))
                                             .astype(np.float32)),
            "token_ids": torch.from_numpy(ids),
        }
        batch = {k: v.to(args.device) for k, v in shard_batch(host_batch, mesh).items()}
        for step in range(1, args.steps + 1):
            state, loss = train_step(model, opt, state, batch, mesh=mesh)
            # The loss is the whole batch's on every rank.
            say(f"proc {args.process_id}: step {step} loss {float(loss):.6f}", flush=True)
        say(f"proc {args.process_id}: MULTIHOST_OK", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--coordinator", required=True, help="host:port of the TCP store (process 0 hosts it)")
    parser.add_argument("--num_processes", type=int, required=True)
    parser.add_argument("--process_id", type=int, required=True)
    parser.add_argument("--model", type=int, default=1, help="TP axis size (must divide the local ranks)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--local_ranks", type=int, default=1, help="ranks this process starts, one per device")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="the ranks' device (default: VCP_DEVICE, the card unless it says cpu)")
    args = parser.parse_args(argv)
    if args.device is None:
        from .. import config

        args.device = "cpu" if config.RUNTIME.device == "cpu" else "cuda"
    if args.local_ranks % args.model:
        parser.error(f"--model {args.model} does not divide --local_ranks {args.local_ranks}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(args, r), name=f"local{r}") for r in range(args.local_ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
