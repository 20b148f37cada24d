"""Multi-task fine-tune, page extraction + evidence-pack answering: the port
of scripts/train_answer.py, with its arguments, defaults and output lines.

Warm-starts from an OCR checkpoint (--init_from) and alternates extraction
batches (rendered pages -> structured fields) with answer batches (question
+ evidence -> cited markdown, train/data.py::qa_batches), so one checkpoint
serves both the /ingest VLM engine and the /chat answer engine.

Runs on RUNTIME.device (VCP_DEVICE, the card unless it says "cpu") and writes
the port's checkpoints (train/checkpoint.py). Run alone it trains on one
device; under a launcher (torchrun, or `parallel.spawn` of `main`) on the
mesh of VCP_MESH_*, as scripts/train_vlm.py does, the answer task's
loss_mask counted over the whole batch.

    python -m vision_compression_project_tpu_torch.scripts.train_answer --preset tiny --steps 2
"""

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="ocr_bpe")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--text_len", type=int, default=320)
    parser.add_argument("--dpi", type=int, default=46)
    parser.add_argument("--font_size", type=int, default=24)
    parser.add_argument("--lines", type=int, default=6)
    parser.add_argument("--answer_every", type=int, default=2,
                        help="every Nth step trains the answer task (others: extraction)")
    parser.add_argument("--agg_frac", type=float, default=0.0,
                        help="fraction of answer examples from the cross-page aggregation generator "
                        "(counts/totals/superlatives the extractive engine cannot produce)")
    parser.add_argument("--qa_data", choices=["words", "real", "mixed"], default="words",
                        help="evidence-sentence distribution of the answer task: 'real' uses the real-language "
                        "corpus (what /chat sees at serve time), 'mixed' alternates 50/50")
    parser.add_argument("--init_from", default=None)
    parser.add_argument("--ckpt_dir", default="checkpoints/vlm_qa")
    parser.add_argument("--ckpt_every", type=int, default=500)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from ..models import get_preset
    from ..train.checkpoint import load_params, save_checkpoint
    from ..train.data import device_batch, prefetch_batches, qa_batches, synthetic_batches
    from ..parallel import MESH_AXES, shard_batch
    from ..train.train_step import (cosine_lr, gather_state, load_whole_params, make_train_state, resolve_device,
                                    train_step, training_mesh)
    from ..weights import params_from_jax

    cfg = get_preset(args.preset)
    schedule = cosine_lr(args.lr, args.steps)
    device = resolve_device()
    mesh = training_mesh(device)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    model, opt, state = make_train_state(cfg, device, seed=args.seed, lr=schedule, mesh=mesh)
    device = next(model.parameters()).device
    log = print if rank0 else (lambda *a, **k: None)
    log(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")
    if mesh is not None:
        log(f"mesh: {dict(zip(MESH_AXES, mesh.shape))} devices={torch.distributed.get_world_size()}")
    if args.init_from:
        tree = load_params(args.init_from)
        if tree is None:
            parser.error(f"--init_from {args.init_from}: no complete checkpoint there")
        load_whole_params(model, params_from_jax(tree), mesh)
        log(f"warm-started params from {args.init_from}")

    def save():
        whole = gather_state(state, mesh)
        return save_checkpoint(args.ckpt_dir, whole) if rank0 else None

    extract_data = prefetch_batches(
        synthetic_batches(cfg, args.batch, text_len=args.text_len, dpi=args.dpi, seed=args.seed,
                          font_size=args.font_size, lines=args.lines)
    )
    answer_data = prefetch_batches(
        qa_batches(cfg, args.batch, text_len=args.text_len, seed=args.seed + 7, agg_frac=args.agg_frac,
                   data_kind=args.qa_data)
    )
    t_start = time.time()
    ex_loss = ans_loss = float("nan")
    for step in range(1, args.steps + 1):
        is_answer = args.answer_every and step % args.answer_every == 0
        batch = device_batch(cfg, next(answer_data if is_answer else extract_data), device=device)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, loss = train_step(model, opt, state, batch, mesh=mesh)
        if is_answer:
            ans_loss = loss
        else:
            ex_loss = loss
        if step % args.log_every == 0 or step == 1:
            ex_v, ans_v = float(ex_loss), float(ans_loss)  # waits for the step
            rate = step * args.batch / (time.time() - t_start)
            log(f"step {step:5d}  extract {ex_v:.4f}  answer {ans_v:.4f}  ex/s {rate:.1f}", flush=True)
        if args.ckpt_every and step % args.ckpt_every == 0:
            path = save()
            log(f"checkpoint: {path}")
    path = save()
    log(f"final checkpoint: {path}")


if __name__ == "__main__":
    main()
