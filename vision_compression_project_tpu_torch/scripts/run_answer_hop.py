"""Unattended real-language answer hop: the port of scripts/run_answer_hop.py,
with its arguments, states and gate.

Waits for the device to free (--wait_pid_file: another driver's PID), then:
  1. trains the multi-task answer hop (train_answer) warm-started from
     --init_from, with aggregation supervision (--agg_frac) and real-language
     evidence (--qa_data mixed);
  2. evaluates head to head with the extractive engine on held-out
     real-language aggregation questions (eval_answer --task agg --data
     real), the imitate task on real and word evidence, and extraction at the
     checkpoint's own render (eval_extract: the hop must not break reading);
  3. ships the checkpoint with tasks extract,answer (ship_checkpoint) only
     if the model beats the extractive baseline on aggregation and holds the
     imitate and extract floors.

Each step is `python -m vision_compression_project_tpu_torch.scripts.<name>`
in a subprocess, on RUNTIME.device. State and results land in
<out>/answer_hop.json; after a ship its final state is copied next to the
weights, into <ship_root>/<preset>/gate/. The ship goes under --ship_root
(default checkpoints/torch/), never into checkpoints/default/, whose orbax
weights the JAX package serves (scripts/ship_checkpoint.py says why).

    python -m vision_compression_project_tpu_torch.scripts.run_answer_hop \\
        --init_from checkpoints/default/ocr_bpe --out checkpoints/torch_hop
"""

import argparse
import json
import os
import shutil
import time
from pathlib import Path

from .. import config
from . import run_step as _run


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    return True


def _load(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="ocr_bpe")
    parser.add_argument("--out", default="checkpoints/r4/answer")
    parser.add_argument("--init_from", default="checkpoints/default/ocr_bpe")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=4e-4)
    parser.add_argument("--agg_frac", type=float, default=0.5)
    parser.add_argument("--answer_every", type=int, default=2)
    parser.add_argument("--qa_data", default="mixed")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--eval_examples", type=int, default=16)
    parser.add_argument("--wait_pid_file", default=None,
                        help="poll until the PID in this file exits (another driver holds the device); starts "
                        "immediately if the file is absent or stale")
    parser.add_argument("--wait_timeout_hours", type=float, default=8.0)
    parser.add_argument("--min_imitate", type=float, default=0.5,
                        help="imitate-task similarity floor on real-language evidence")
    parser.add_argument("--min_extract", type=float, default=0.3,
                        help="extraction-similarity floor at the checkpoint's own render (the answer hop must not "
                        "destroy page reading)")
    parser.add_argument("--ship_root", default=str(config.PORT_SHIP_ROOT),
                        help="ship_checkpoint's --root (default checkpoints/torch/; checkpoints/default/ is refused)")
    args = parser.parse_args(argv)

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    status_path = out / "answer_hop.json"
    status = {"status": "waiting"}

    def save():
        status_path.write_text(json.dumps(status, indent=1))

    save()

    if args.wait_pid_file and Path(args.wait_pid_file).exists():
        try:
            pid = int(Path(args.wait_pid_file).read_text().strip())
        except ValueError:
            pid = None
        deadline = time.time() + args.wait_timeout_hours * 3600
        while pid and _pid_alive(pid):
            if time.time() > deadline:
                status["status"] = "wait_timeout"
                save()
                print("TIMEOUT waiting for pid", pid)
                return
            time.sleep(60)
        print(f"pid {pid} exited; chip is free")

    # --- 1. train -------------------------------------------------------
    status["status"] = "training"
    save()
    init = Path(args.init_from).resolve()
    meta = _load(init / "meta.json")
    render = {"font_size": meta.get("font_size", 24), "dpi": meta.get("dpi", 46), "lines": meta.get("lines", 6)}
    ckpt_dir = out / "ckpt"
    rc = _run(
        ["train_answer", "--preset", args.preset,
         "--steps", args.steps, "--batch", args.batch, "--lr", args.lr,
         "--agg_frac", args.agg_frac, "--answer_every", args.answer_every,
         "--qa_data", args.qa_data, "--seed", args.seed,
         "--font_size", render["font_size"], "--dpi", render["dpi"],
         "--lines", render["lines"],
         "--init_from", init, "--ckpt_dir", ckpt_dir,
         "--ckpt_every", 500, "--log_every", 50],
        out / "train.log",
    )
    if rc != 0:
        status["status"] = f"train_failed:{rc}"
        save()
        return

    # --- 2. eval --------------------------------------------------------
    status["status"] = "evaluating"
    save()
    evals = {}
    for name, extra in (
        ("agg_real", ["--task", "agg", "--data", "real"]),
        ("imitate_real", ["--task", "imitate", "--data", "real"]),
        ("imitate_words", ["--task", "imitate", "--data", "words"]),
    ):
        jout = out / f"eval_{name}.json"
        rc = _run(
            ["eval_answer", "--preset", args.preset,
             "--ckpt_dir", ckpt_dir, "--examples", args.eval_examples,
             "--json_out", jout, *extra],
            out / "eval.log",
        )
        evals[name] = _load(jout) if rc == 0 else {"error": rc}
    ext_json = out / "eval_extract.json"
    rc = _run(
        ["eval_extract", "--preset", args.preset,
         "--ckpt_dir", ckpt_dir, "--data", meta.get("data", "words"),
         "--pages", 8, "--font_size", render["font_size"],
         "--lines", render["lines"], "--dpi", render["dpi"],
         "--json_out", ext_json],
        out / "eval.log",
    )
    evals["extract"] = _load(ext_json) if rc == 0 else {"error": rc}
    status["evals"] = evals
    save()

    # --- 3. gate + ship ------------------------------------------------
    agg = evals.get("agg_real", {})
    imit = evals.get("imitate_real", {})
    ext = evals.get("extract", {})
    lm_acc = agg.get("lm_keyfact_accuracy", -1.0)
    ex_acc = agg.get("extractive_keyfact_accuracy", 2.0)
    imit_sim = imit.get("similarity_mean", -1.0)
    ext_sim = ext.get("markdown_similarity_mean", -1.0)
    gate = {
        "agg_beats_extractive": lm_acc > ex_acc,
        "imitate_floor": imit_sim >= args.min_imitate,
        "extract_floor": ext_sim >= args.min_extract,
    }
    status["gate"] = gate
    if all(gate.values()):
        rc = _run(
            ["ship_checkpoint", "--preset", args.preset,
             "--ckpt_dir", ckpt_dir,
             "--font_size", render["font_size"], "--dpi", render["dpi"],
             "--lines", render["lines"], "--data", meta.get("data", "words"),
             "--tasks", "extract,answer", "--steps", args.steps,
             "--note",
             f"real-language answer hop: agg lm={lm_acc:.2f} vs "
             f"extractive={ex_acc:.2f}, imitate_real={imit_sim:.3f}, "
             f"extract={ext_sim:.3f}",
             "--root", Path(args.ship_root).resolve(),
             "--evidence",
             *[out / f"eval_{n}.json" for n in ("agg_real", "imitate_real", "imitate_words")],
             ext_json],
            out / "ship.log",
        )
        status["status"] = "shipped" if rc == 0 else f"ship_failed:{rc}"
    else:
        status["status"] = "not_shipped_gate_failed"
    save()
    # The gate decision lives next to the weights it gated, copied after the
    # final save so the record carries the terminal state.
    if status["status"] == "shipped":
        gate_dir = Path(args.ship_root).resolve() / args.preset / "gate"
        gate_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy2(status_path, gate_dir / status_path.name)
        print(f"gate record: {gate_dir / status_path.name}")
    print(json.dumps(status, indent=1))


if __name__ == "__main__":
    main()
