"""Train the OpticalVLM on synthetic rendered-page extraction data: the port
of scripts/train_vlm.py, with its arguments, defaults and output lines.

Runs on RUNTIME.device (VCP_DEVICE, the card unless it says "cpu") and
writes the port's checkpoints (train/checkpoint.py), which load_runner and
VCP_CHECKPOINT_DIR read. Run alone it trains on one device; under a
launcher (torchrun, or `parallel.spawn` of `main`) every rank runs it on the
mesh `local_mesh()` builds from VCP_MESH_* (the sharded train step,
train/train_step.py), rank 0 logs and saves the gathered parameters, a
checkpoint equal to one device's. --pp_microbatches M > 0 pipelines the
decoder blocks over the mesh `model` dimension (GPipe, train/pp_train.py)
with M microbatches a step: one stage run alone, VCP_MESH_MODEL stages under
a launcher; rank 0 saves the whole state, gathered from the stages.

    python -m vision_compression_project_tpu_torch.scripts.train_vlm --preset tiny --steps 2
    VCP_MESH_MODEL=2 torchrun --nproc_per_node 4 -m vision_compression_project_tpu_torch.scripts.train_vlm
    VCP_MESH_MODEL=2 torchrun --nproc_per_node 2 -m vision_compression_project_tpu_torch.scripts.train_vlm \
        --batch 8 --pp_microbatches 4
"""

import argparse
import time

# The training step's timers (utils/metrics.py), as the log line names them.
PHASES = ("feed", "forward", "backward", "optimizer")


def _host_totals() -> dict:
    """{phase: (seconds, calls)} of the `train.<phase>` timers so far."""
    from ..utils.metrics import METRICS

    timers = METRICS.snapshot()["timers"]
    return {p: (timers.get(f"train.{p}", {}).get("total", 0.0), timers.get(f"train.{p}", {}).get("count", 0))
            for p in PHASES}


def _host_ms(now: dict, last: dict) -> str:
    """Each phase's host milliseconds a call between two `_host_totals()`: the
    time the host took to enqueue its work, not the device's; '-' where it
    did not run (the pipelined step times no forward or backward)."""
    parts = []
    for p in PHASES:
        calls = now[p][1] - last[p][1]
        parts.append(f"{p} {1e3 * (now[p][0] - last[p][0]) / calls:.2f}" if calls else f"{p} -")
    return " ".join(parts)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the OpticalVLM.")
    parser.add_argument("--preset", default="tiny", help="model preset")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--text_len", type=int, default=384)
    parser.add_argument("--dpi", type=int, default=72)
    parser.add_argument("--font_size", type=int, default=12)
    parser.add_argument("--lines", type=int, default=18)
    parser.add_argument(
        "--data", choices=["words", "words_easy", "codes", "codes_easy", "real", "jumble"], default="words",
        help="codes: random digit pages, so a loss below ln(10)/digit proves reading; jumble: independently "
        "random corpus words (real-language glyphs, no language prior to shortcut through)",
    )
    parser.add_argument(
        "--jumble_frac", type=float, default=0.0,
        help="with --data real: fraction of pages drawn from the jumble generator instead",
    )
    parser.add_argument(
        "--fonts", default="builtin",
        help="comma list of page fonts to rotate per page: 'builtin' (engine atlas) and/or make_pdf "
        "aliases (dejavu_sans, dejavu_serif, dejavu_mono, ...) or .ttf paths",
    )
    parser.add_argument("--vocab_cap", type=int, default=0,
                        help="jumble word-inventory cap (0 = the full corpus vocabulary)")
    parser.add_argument("--jumble_plain", type=int, default=0,
                        help="1: strip structural extras (value templates, bullets, blank lines) from jumble pages")
    parser.add_argument("--code_groups", type=int, default=3)
    parser.add_argument("--code_digits", type=int, default=5)
    parser.add_argument("--ckpt_dir", default="checkpoints/vlm")
    parser.add_argument("--ckpt_every", type=int, default=100)
    parser.add_argument("--log_every", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init_from", default=None,
                        help="checkpoint dir to warm-start params from (curriculum transfer)")
    parser.add_argument(
        "--pp_microbatches", type=int, default=0,
        help="if > 0, pipeline the decoder blocks over the mesh `model` axis (GPipe) with this many microbatches "
        "per step; needs a uniform decoder (dense or expert_every=1) and batch %% microbatches == 0",
    )
    args = parser.parse_args(argv)
    if args.pp_microbatches > 0 and args.batch % args.pp_microbatches:
        parser.error("--batch must be divisible by --pp_microbatches")

    import torch

    from ..models import get_preset
    from ..train.checkpoint import load_params, save_checkpoint
    from ..train.data import device_batch, prefetch_batches, synthetic_batches
    from ..parallel import AXIS_MODEL, MESH_AXES, shard_batch
    from ..parallel.mesh import axis_size
    from ..train.pp_train import gather_pp_state, make_pp_train_state, make_pp_vlm_train_step
    from ..train.train_step import (cosine_lr, gather_state, load_whole_params, make_train_state, resolve_device,
                                    train_step, training_mesh)
    from ..weights import params_from_jax

    cfg = get_preset(args.preset)
    # Warmup-cosine to 10% of peak, as the reference's command line runs it.
    schedule = cosine_lr(args.lr, args.steps)
    device = resolve_device()
    mesh = training_mesh(device)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    pp = args.pp_microbatches > 0
    warm = None
    if args.init_from:
        tree = load_params(args.init_from)
        if tree is None:
            parser.error(f"--init_from {args.init_from}: no complete checkpoint there")
        warm = params_from_jax(tree)
    if pp:
        # Every rank loads the whole warm start, then keeps its stage's part.
        model, opt, state = make_pp_train_state(cfg, device, seed=args.seed, lr=schedule, mesh=mesh, params=warm)
        step_fn, local_rows = make_pp_vlm_train_step(model, opt, mesh, n_micro=args.pp_microbatches)
    else:
        model, opt, state = make_train_state(cfg, device, seed=args.seed, lr=schedule, mesh=mesh)
        if warm is not None:
            load_whole_params(model, warm, mesh)
    device = next(model.parameters()).device
    log = print if rank0 else (lambda *a, **k: None)
    log(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")
    if mesh is not None:
        log(f"mesh: {dict(zip(MESH_AXES, mesh.shape))} devices={torch.distributed.get_world_size()}")
    if warm is not None:
        log(f"warm-started params from {args.init_from}")
    if pp:
        stages = 1 if mesh is None else axis_size(mesh, AXIS_MODEL)
        log(f"PP training: {args.pp_microbatches} microbatches over {stages} pipeline stage(s)")

    def save():
        whole = gather_pp_state(state, cfg.decoder.depth, mesh) if pp else gather_state(state, mesh)
        return save_checkpoint(args.ckpt_dir, whole) if rank0 else None

    data = prefetch_batches(
        synthetic_batches(
            cfg, args.batch, text_len=args.text_len, dpi=args.dpi, seed=args.seed, font_size=args.font_size,
            lines=args.lines, kind=args.data, code_groups=args.code_groups, code_digits=args.code_digits,
            jumble_frac=args.jumble_frac, fonts=[f.strip() for f in args.fonts.split(",") if f.strip()],
            vocab_cap=args.vocab_cap, jumble_plain=bool(args.jumble_plain),
        )
    )
    t_start = time.time()
    t_last, step_last = t_start, 0
    host_last = _host_totals()
    for step in range(1, args.steps + 1):
        batch = device_batch(cfg, next(data), device=device)
        if pp:
            state, loss = step_fn(state, local_rows(batch))
        else:
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            state, loss = train_step(model, opt, state, batch, mesh=mesh)
        if step % args.log_every == 0 or step == 1:
            loss_v = float(loss)
            now = time.time()
            rate = step * args.batch / (now - t_start)
            # The rate since the last log line: the steady-state number.
            inst = (step - step_last) * args.batch / max(now - t_last, 1e-9)
            host = _host_totals()
            log(f"step {step:5d}  loss {loss_v:.4f}  pages/s {rate:.1f}  (inst {inst:.1f})  "
                f"host enqueue ms/step {_host_ms(host, host_last)}", flush=True)
            t_last, step_last, host_last = now, step, host
        if args.ckpt_every and step % args.ckpt_every == 0:
            path = save()
            log(f"checkpoint: {path}")
    path = save()
    log(f"final checkpoint: {path}")


if __name__ == "__main__":
    main()
