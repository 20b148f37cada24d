"""Unattended OCR training curriculum driver: the port of
scripts/run_curriculum.py, with its stages, arguments, state file and
decisions.

Each stage trains (train_vlm in a subprocess, so crashes are isolated),
evaluates extraction similarity at the stage's own render (eval_extract),
and then advances (eval >= the stage's advance_at, else --advance_at),
extends the stage (budget left), or stops with a clear status. Every prose
stage that clears its bar is shipped (ship_checkpoint, under its default
root checkpoints/torch/); the final stage ships again when it clears
--ship_at. Each step is `python -m vision_compression_project_tpu_torch.scripts.<name>`
on RUNTIME.device.

State lives in <out>/curriculum.json after every step, so an interrupted run
resumes where it stopped (--resume): a stage that left complete checkpoints
warm-starts from its own newest one, and a train.done marker sends a
relaunch straight to the stage's eval. --dry_run prints the command plan.

    python -m vision_compression_project_tpu_torch.scripts.run_curriculum --out checkpoints/curriculum \
        --init_from checkpoints/default/ocr_real --dry_run

The stages implement the read-first curriculum: jumble pages (independently
random corpus words, train/corpus.py::jumble_page_text) first, so a loss
below the vocabulary's entropy is reachable only by reading pixels; prose
stages then mix jumble pages in; the font shrinks at most about 2x a stage.
  readA0 jumble 100% font 48 / lines 6  / dpi 93, vocab cap 128
  readA1 jumble 100% font 48 / lines 6  / dpi 93, vocab cap 1024
  readA  jumble 100% font 48 / lines 6  / dpi 93, full vocabulary
  readB  jumble 100% font 24 / lines 14 / dpi 93
  mixC   real+jumble 50% font 24 / lines 14 / dpi 93
  denseD real+jumble 25% font 12 / lines 30 / dpi 150
"""

import argparse
import json
import time
from pathlib import Path

from . import run_step as _run

DEFAULT_STAGES = [
    # kind/jumble_frac: training distribution; eval_data: what similarity
    # gates the stage (jumble stages gate on reading, prose on real text);
    # ship: only prose-capable stages publish a serving default;
    # vocab_cap: jumble word-inventory ramp (measured need: at the full
    # ~14.4k inventory, 7500 steps left loss stuck ~1.19 with generation
    # at 0.23 similarity — word-identity entropy ~9.6 nats starves the
    # reading gradient; the round-2 dive happened on a tiny vocabulary);
    # plain: strip Value templates/bullets/blank lines so every token of
    # the dive carries reading signal (round-5 readA0 measurement: with
    # templates on, teacher-forced loss converged to ~0.54 while greedy
    # generation collapsed into template loops at similarity 0.21);
    # advance_at: per-stage gate override (global --advance_at otherwise).
    {"name": "readA00", "font_size": 48, "lines": 6, "dpi": 93,
     "steps": 1500, "max_steps": 6000, "lr": 7e-4, "text_len": 255,
     "kind": "jumble", "jumble_frac": 0.0, "eval_data": "jumble",
     "vocab_cap": 32, "plain": True, "advance_at": 0.8, "ship": False},
    {"name": "readA0", "font_size": 48, "lines": 6, "dpi": 93,
     "steps": 2000, "max_steps": 8000, "lr": 7e-4, "text_len": 255,
     "kind": "jumble", "jumble_frac": 0.0, "eval_data": "jumble",
     "vocab_cap": 128, "plain": True, "advance_at": 0.75, "ship": False},
    {"name": "readA1", "font_size": 48, "lines": 6, "dpi": 93,
     "steps": 2000, "max_steps": 8000, "lr": 6e-4, "text_len": 255,
     "kind": "jumble", "jumble_frac": 0.0, "eval_data": "jumble",
     "vocab_cap": 1024, "plain": True, "advance_at": 0.7, "ship": False},
    {"name": "readA", "font_size": 48, "lines": 6, "dpi": 93,
     "steps": 2500, "max_steps": 12500, "lr": 8e-4, "text_len": 255,
     "kind": "jumble", "jumble_frac": 0.0, "eval_data": "jumble",
     "advance_at": 0.7, "ship": False},
    {"name": "readB", "font_size": 24, "lines": 14, "dpi": 93,
     "steps": 2500, "max_steps": 10000, "lr": 8e-4, "text_len": 511,
     "kind": "jumble", "jumble_frac": 0.0, "eval_data": "jumble",
     "advance_at": 0.7, "ship": False},
    {"name": "mixC", "font_size": 24, "lines": 14, "dpi": 93,
     "steps": 2500, "max_steps": 10000, "lr": 8e-4, "text_len": 511,
     "kind": "real", "jumble_frac": 0.5, "eval_data": "real",
     "ship": True},
    # Dense stages run SHORT per-process chunks: a host-side leak
    # proportional to bytes transferred (dmesg-confirmed 130 GB OOM kill
    # at ~1900 dense-render steps) bounds how long one trainer process
    # may live; 800-step extensions keep RSS well under the box.
    # lr_decay 0.9 softens the per-extension anneal accordingly.
    {"name": "denseD", "font_size": 12, "lines": 30, "dpi": 150,
     "steps": 800, "max_steps": 12000, "lr": 6e-4, "lr_decay": 0.9,
     "text_len": 1023, "kind": "real", "jumble_frac": 0.25,
     "eval_data": "real", "ship": True},
    # Font diversity: the preceding stages read the builtin atlas font;
    # real documents use real typefaces.  Rotating embedded DejaVu faces
    # (serif/sans/mono/bold — pdfgen FontFile2 embedding) per page pushes
    # the reader toward font-invariant glyph recognition at the VERDICT
    # render; ships with its font list in meta so bench.py rotates the
    # same mix.
    {"name": "fontsE", "font_size": 12, "lines": 30, "dpi": 150,
     "steps": 800, "max_steps": 12000, "lr": 5e-4, "lr_decay": 0.9,
     "text_len": 1023, "kind": "real", "jumble_frac": 0.25,
     "eval_data": "real",
     "fonts": "builtin,dejavu_sans,dejavu_serif,dejavu_mono,"
              "dejavu_sans_bold",
     "ship": True},
]


def _eval_similarity(preset, ckpt_dir, stage, pages, dry):
    if dry:
        return 1.0
    out = Path(ckpt_dir) / "eval.json"
    rc = _run(
        ["eval_extract", "--preset", preset, "--ckpt_dir",
         ckpt_dir, "--data", stage.get("eval_data", "real"),
         "--pages", pages,
         "--font_size", stage["font_size"], "--lines", stage["lines"],
         "--fonts", stage.get("fonts", "builtin"),
         "--vocab_cap", stage.get("vocab_cap", 0),
         "--jumble_plain", int(stage.get("plain", False)),
         # The decode budget covers the stage's whole target: 30 lines of
         # prose are about 1000 BPE tokens, so eval_extract's default 256
         # would cut every output and cap the similarity near 0.3.
         "--dpi", stage["dpi"], "--max_new", 1024, "--json_out", out],
        Path(ckpt_dir) / "eval.log", dry,
    )
    if rc != 0 or not out.exists():
        return -1.0
    return json.loads(out.read_text()).get("markdown_similarity_mean", -1.0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="ocr_real")
    parser.add_argument("--out", default="checkpoints/curriculum")
    parser.add_argument("--init_from", default=None, help="warm-start for the FIRST stage")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--advance_at", type=float, default=0.8, help="stage eval similarity needed to advance")
    parser.add_argument("--ship_at", type=float, default=0.8, help="final-stage similarity needed to ship")
    parser.add_argument("--eval_pages", type=int, default=12)
    parser.add_argument("--budget_hours", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=12)
    parser.add_argument("--resume", action="store_true", help="continue from <out>/curriculum.json")
    parser.add_argument("--dry_run", action="store_true", help="print the command plan without training")
    args = parser.parse_args(argv)

    from ..train.checkpoint import complete_steps

    out_root = Path(args.out).resolve()
    out_root.mkdir(parents=True, exist_ok=True)
    state_file = out_root / "curriculum.json"
    state = {"stage": 0, "extension": 0, "init_from": args.init_from, "history": []}
    if args.resume and state_file.exists():
        state = json.loads(state_file.read_text())
        print(f"resuming: stage {state['stage']} ext {state['extension']}")

    deadline = time.time() + args.budget_hours * 3600

    def save():
        state_file.write_text(json.dumps(state, indent=1))

    while state["stage"] < len(DEFAULT_STAGES):
        stage = DEFAULT_STAGES[state["stage"]]
        ext = state["extension"]
        ckpt_dir = out_root / f"{stage['name']}_e{ext}"
        steps = stage["steps"]
        if time.time() > deadline:
            state["status"] = "out_of_budget"
            save()
            print("BUDGET EXHAUSTED before", stage["name"])
            return
        # Crash recovery within a stage: a stage run that left complete
        # checkpoints warm-starts from its own newest one, not the stage's
        # original init. A train.done marker means training finished and
        # only the eval was interrupted: go straight to the eval.
        train_done = ckpt_dir / "train.done"
        init_from = state["init_from"]
        if ckpt_dir.exists() and complete_steps(ckpt_dir, "step"):
            init_from = str(ckpt_dir)
            print(f"stage {stage['name']}_e{ext}: warm-starting from its own partial checkpoint")
        if train_done.exists():
            print(f"stage {stage['name']}_e{ext}: training already complete; re-running eval only")
        else:
            # Extensions anneal the peak lr (lr_decay ** ext, 0.7 unless the
            # stage says): a rerun at full peak would raise the noise floor
            # the previous run's cosine worked down.
            ext_lr = round(stage["lr"] * (stage.get("lr_decay", 0.7) ** ext), 8)
            cmd = [
                "train_vlm", "--preset", args.preset,
                "--data", stage.get("kind", "real"),
                "--jumble_frac", stage.get("jumble_frac", 0.0),
                "--steps", steps, "--batch", args.batch,
                "--lr", ext_lr, "--font_size", stage["font_size"],
                "--lines", stage["lines"], "--dpi", stage["dpi"],
                "--fonts", stage.get("fonts", "builtin"),
                "--vocab_cap", stage.get("vocab_cap", 0),
                "--jumble_plain", int(stage.get("plain", False)),
                "--text_len", stage["text_len"],
                "--seed", args.seed + state["stage"] * 101 + ext,
                "--ckpt_dir", ckpt_dir, "--ckpt_every", 500,
                "--log_every", 50,
            ]
            if init_from:
                cmd += ["--init_from", init_from]
            rc = _run(cmd, out_root / f"{stage['name']}_e{ext}.log", args.dry_run)
            if rc != 0:
                state["status"] = f"train_failed:{stage['name']}_e{ext}"
                save()
                print("TRAIN FAILED", stage["name"], "rc", rc)
                return
            if not args.dry_run:
                ckpt_dir.mkdir(parents=True, exist_ok=True)
                train_done.touch()
            save()  # progress persists before the (killable) eval
        sim = _eval_similarity(args.preset, str(ckpt_dir), stage, args.eval_pages, args.dry_run)
        if sim < 0:
            # The eval itself failed (crash, kill, missing JSON), not the
            # model: exit so a supervisor relaunches; train.done routes the
            # relaunch straight back to this eval.
            state["status"] = f"eval_failed:{stage['name']}_e{ext}"
            save()
            print("EVAL FAILED", stage["name"], "- supervisor should retry")
            return
        state.pop("status", None)  # clear an earlier eval_failed
        state["history"].append({"stage": stage["name"], "ext": ext, "similarity": sim, "ckpt": str(ckpt_dir)})
        print(f"{stage['name']}_e{ext}: similarity {sim:.3f}")
        state["init_from"] = str(ckpt_dir)  # the next run warm-starts here
        if sim >= stage.get("advance_at", args.advance_at):
            # Every prose stage that clears the bar ships with its own render
            # in meta.json, so the shipped model is the best verified one if
            # the budget ends mid-curriculum; jumble (reading-skill) stages
            # never ship.
            if stage.get("ship", True):
                _run(
                    ["ship_checkpoint", "--preset", args.preset,
                     "--ckpt_dir", ckpt_dir,
                     "--font_size", stage["font_size"],
                     "--lines", stage["lines"], "--dpi", stage["dpi"],
                     "--fonts", stage.get("fonts", "builtin"),
                     "--data", "real", "--tasks", "extract", "--steps", 0,
                     "--note",
                     f"curriculum {stage['name']}_e{ext} sim={sim:.3f}",
                     "--evidence", ckpt_dir / "eval.json"],
                    out_root / "ship.log", args.dry_run,
                )
                print(f"shipped {stage['name']}_e{ext} (sim {sim:.3f})")
            else:
                print(f"advanced {stage['name']}_e{ext} (sim {sim:.3f}, no ship: read-skill stage)")
            state["stage"] += 1
            state["extension"] = 0
        else:
            total = steps * (ext + 1)
            if total + steps > stage["max_steps"]:
                state["status"] = f"stalled:{stage['name']} sim={sim:.3f}"
                save()
                print("STAGE STALLED", stage["name"], "sim", sim)
                return
            state["extension"] += 1  # keep training the same stage
        save()

    final = state["history"][-1]
    state["status"] = "complete"
    save()
    if final["similarity"] >= args.ship_at and not args.dry_run:
        last_stage = DEFAULT_STAGES[-1]
        _run(
            ["ship_checkpoint", "--preset", args.preset,
             "--ckpt_dir", final["ckpt"],
             "--font_size", last_stage["font_size"],
             "--lines", last_stage["lines"], "--dpi", last_stage["dpi"],
             "--fonts", last_stage.get("fonts", "builtin"),
             "--data", "real", "--tasks", "extract",
             "--steps", 0,
             "--note", f"curriculum auto-ship sim={final['similarity']:.3f}",
             "--evidence", Path(final["ckpt"]) / "eval.json"],
            out_root / "ship.log", args.dry_run,
        )
        print("SHIPPED", final["ckpt"])
    else:
        print("NOT shipped (similarity below --ship_at or dry run)")


if __name__ == "__main__":
    main()
