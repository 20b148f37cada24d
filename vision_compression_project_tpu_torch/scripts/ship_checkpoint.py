"""Publish a training checkpoint as serving weights: the port of
scripts/ship_checkpoint.py, with its arguments, meta.json and gate files.

Converts the newest checkpoint of a training run into a params-only
checkpoint, <root>/<preset>/params_NNNNNNNN/checkpoint.pt (the port's
format), plus a meta.json recording the training render (font size, DPI,
lines), data, fonts and tasks, and copies the gate's evidence files into
<root>/<preset>/gate/. Exactly one params directory remains after a ship:
older ones are removed, since the loader picks the highest step.

The one difference from the reference's command line: --root, by default
checkpoints/torch/. The reference ships into checkpoints/default/, whose
orbax weights the JAX package serves; a checkpoint.pt there would be one it
cannot read, so this script refuses that root. Point VCP_CHECKPOINT_DIR at
<root>/<preset> to serve a port ship.

    python -m vision_compression_project_tpu_torch.scripts.ship_checkpoint --preset ocr_bpe \\
        --ckpt_dir checkpoints/vlm_qa --font_size 24 --dpi 46 --lines 6 --tasks extract,answer
"""

import argparse
import json
import shutil
from pathlib import Path

from .. import config


def _is_within(path: Path, root: Path) -> bool:
    return path == root or root in path.parents


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", required=True)
    parser.add_argument("--ckpt_dir", required=True, help="training run dir")
    parser.add_argument("--font_size", type=int, required=True)
    parser.add_argument("--dpi", type=int, required=True)
    parser.add_argument("--lines", type=int, required=True)
    parser.add_argument("--data", default="words", choices=["words", "real"],
                        help="training text distribution ('real': the bench renders held-out real-language prose)")
    parser.add_argument("--steps", type=int, default=0, help="trained steps (for meta)")
    parser.add_argument("--tasks", default="extract",
                        help="comma-separated tasks the checkpoint was trained for ('extract', 'answer'); 'answer' "
                        "makes the QA engine 'auto' resolve to generation (pipeline/qa.py::lm_answer_available)")
    parser.add_argument("--fonts", default="builtin", help="comma list of page fonts the checkpoint was trained on")
    parser.add_argument("--note", default="")
    parser.add_argument("--evidence", nargs="*", default=[],
                        help="gate/eval JSON files to copy into the shipped dir as gate/<name>; missing files are "
                        "skipped with a warning")
    parser.add_argument("--root", default=str(config.PORT_SHIP_ROOT),
                        help="ship root (default checkpoints/torch/); checkpoints/default/ holds the JAX package's "
                        "orbax weights and is refused: it cannot read the port's checkpoint.pt")
    args = parser.parse_args(argv)

    root = Path(args.root).resolve()
    if _is_within(root, config.SHIPPED_CHECKPOINT_ROOT.resolve()):
        parser.error(f"--root {args.root}: checkpoints/default/ holds the JAX package's shipped weights, which "
                     "cannot read the port's checkpoint.pt; ship under another root")

    from ..models import get_preset
    from ..train.checkpoint import load_runner, save_params
    from ..weights import params_to_jax

    cfg = get_preset(args.preset)
    runner = load_runner(cfg, str(Path(args.ckpt_dir).resolve()), device="cpu")
    out = root / args.preset
    stale = [p for p in out.glob("params_*") if p.is_dir()]
    path = save_params(out, params_to_jax(runner.model.state_dict(), cfg), step=args.steps)
    for p in stale:
        if p != path:
            shutil.rmtree(p)
            print(f"removed stale ship: {p}")
    meta = {
        "preset": args.preset,
        "font_size": args.font_size,
        "dpi": args.dpi,
        "lines": args.lines,
        "data": args.data,
        "fonts": [f.strip() for f in args.fonts.split(",") if f.strip()],
        "tasks": [t.strip() for t in args.tasks.split(",") if t.strip()],
        "trained_steps": args.steps,
        "note": args.note,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    if args.evidence:
        gate_dir = out / "gate"
        gate_dir.mkdir(exist_ok=True)
        for src in args.evidence:
            src = Path(src)
            if not src.exists():
                print(f"WARNING: evidence file missing, skipped: {src}")
                continue
            shutil.copy2(src, gate_dir / src.name)
            print(f"evidence: {gate_dir / src.name}")
    print(f"shipped: {path}")
    print(f"meta:    {out / 'meta.json'}")


if __name__ == "__main__":
    main()
