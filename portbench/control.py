"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed, the program's numbers against the reference (the
lower readings), the control's (the reference a precision step below the
configuration's, in the program's place; the upper readings) and the faults
a cell can have (training: half of each batch left out, the loss the mean
over the rest; extraction: one served token altered where it is produced).
A state left unchanged reads 1 on update_gap by its measure and is not run.
Not run by the benchmark's own runs.

    python3 portbench/control.py --cells <cell>[,<cell>...] --seeds <n>[,<n>...] [--out FILE]

prints one JSON line a cell and seed (and appends it to FILE)."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT]

import torch  # noqa: E402

from portbench import spec, traffic as traffic_mod  # noqa: E402
from portbench.harness import driver, vlm_config  # noqa: E402


def _faulty_program(cell, seed: int, device, fault: str) -> dict:
    """The program's checked steps on a fresh run with `fault` planted:
    "half_batch" (device_batch keeps the first half of the rows, so the loss
    is the mean over them) or "unchanged" (AdamW.update leaves the state and
    the parameters as they were)."""
    from vision_compression_project_tpu_torch.train import data, train_step

    mod = driver("train")
    run = mod.Run(cell.config, vlm_config(cell.config), cell.traffic, seed, device)
    real_batch, real_update = data.device_batch, train_step.AdamW.update

    def half_batch(*a, **k):
        full = real_batch(*a, **k)
        n = full["token_ids"].shape[0] // 2
        return {key: v[:n] for key, v in full.items()}

    if fault == "half_batch":
        data.device_batch = half_batch
    else:
        train_step.AdamW.update = lambda self, params, state, reduce_sq=None: state
    try:
        run.setup()
    finally:
        data.device_batch, train_step.AdamW.update = real_batch, real_update
    got = run.program()
    run.release()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def train_readings(cell, seed: int, device, parts=("control", "half_batch")) -> dict:
    mod = driver("train")
    run = mod.Run(cell.config, vlm_config(cell.config), cell.traffic, seed, device)
    run.setup()
    got = run.program()
    run.release()
    gc.collect()
    faults = {f: _faulty_program(cell, seed, device, f) for f in ("half_batch", "unchanged") if f in parts}
    ref = run.reference()
    out = {"program": mod.Run.compare(got, ref)}
    if "control" in parts:
        out["control"] = mod.Run.compare(run.reference(low=True), ref)
    for f, readings in faults.items():
        out[f] = mod.Run.compare(readings, ref)
    return out


def extract_readings(cell, seed: int, device, with_control: bool = True) -> dict:
    mod = driver("extract")
    run = mod.Run(cell.config, vlm_config(cell.config), cell.traffic, seed, device)
    run.setup()
    run.unit()
    run.window_stats(0.0)
    run.release()
    gc.collect()
    picks = run.sample()
    exact = run.reference_logits(picks)
    tokens = [t for _, _, t in picks]
    if not with_control:
        return {"program": {"logit_gap": mod.Run.gap(exact, tokens)}, "served_tokens": sum(len(t) for t in tokens)}
    low = run.reference_logits(picks, low=True)
    rng = traffic_mod.rng_for(seed, 3)
    altered = [list(t) for t in tokens]
    allowed = torch.nonzero(exact[0][0] > -1e29)[:, 0].tolist()
    pos = int(rng.integers(0, len(altered[0])))
    choices = [a for a in allowed if a != altered[0][pos]]
    altered[0][pos] = choices[int(rng.integers(0, len(choices)))]
    return {"program": {"logit_gap": mod.Run.gap(exact, tokens)},
            "control": {"logit_gap": mod.Run.gap(exact, [lg.argmax(dim=-1).tolist() for lg in low])},
            "altered_token": {"logit_gap": mod.Run.gap(exact, altered)},
            "served_tokens": sum(len(t) for t in tokens)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="control,half_batch",
                    help="besides the program: control, half_batch, unchanged (training), or none")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for name in args.cells.split(","):
        cell = spec.find_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            parts = tuple(p for p in args.parts.split(",") if p != "none")
            if cell.traffic["kind"] == "train":
                found = train_readings(cell, seed, device, parts)
            else:
                found = extract_readings(cell, seed, device, "control" in parts)
            rec = {"cell": name, "seed": seed, **found, "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
