"""Contrastive training of the neural embedder (InfoNCE on query/page
pairs): the port of scripts/train_embedder.py, with its arguments, defaults
and output lines. Runs on RUNTIME.device (VCP_DEVICE, the card unless it says
"cpu") and writes a `step_NNNNNNNN/` checkpoint of the params in the port's
format (train/checkpoint.py).

    python -m vision_compression_project_tpu_torch.scripts.train_embedder --steps 2
"""

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the neural embedder.")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--ckpt_dir", default="checkpoints/embedder")
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..models.configs import EmbedderConfig
    from ..train.checkpoint import save_checkpoint
    from ..train.embedder_train import (
        embedder_train_step, make_embedder_train_state, pair_batch, synthetic_pair_batches,
    )
    from ..train.train_step import TrainState

    cfg = EmbedderConfig(dim=args.dim, depth=args.depth)
    model, opt, params, opt_state = make_embedder_train_state(cfg, lr=args.lr, seed=args.seed)
    device = next(model.parameters()).device
    data = synthetic_pair_batches(args.batch, seed=args.seed)
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = pair_batch(next(data), device)
        params, opt_state, loss = embedder_train_step(model, opt, params, opt_state, batch)
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  pairs/s {step * args.batch / (time.time() - t0):.0f}")
    # Params only, as the reference saves {"params": params}.
    state = TrainState(params=params, opt_state=None, step=args.steps, cfg=cfg)
    print(f"checkpoint: {save_checkpoint(args.ckpt_dir, state)}")


if __name__ == "__main__":
    main()
