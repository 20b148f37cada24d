"""control.py's readings for the LFM2 cells (traffic kind `train_lfm2`): for
each seed the program's numbers against the reference (the lower
readings), the control's (the reference a precision step below the
configuration's, in the program's place) and the program with a fault
planted: "half_batch" (the loss over the first half of each batch's rows),
"unchanged" (AdamW leaves the state as it was) and "bias_in_weights"
(`TopKMoE` weighs the chosen experts by the biased scores, not by the
sigmoid scores alone) and "bias_ignored" (`TopKMoE` chooses by the sigmoid
scores alone, the bias left out of the selection). Each is checked as the benchmark checks the
program: the reference runs again against it, taking its routing
(drivers/train_lfm2.py). Not run by the benchmark's own runs.

    python3 portbench/control_lfm2.py --cells <cell> --seeds <n>[,<n>...] [--parts control,half_batch,...] [--out FILE]

prints one JSON line a cell and seed (and appends it to FILE). The
program's model is built without `init_params`' draws, which the
benchmark's weights replace whole, to save a minute a run."""

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

from portbench import spec  # noqa: E402
from portbench.harness import driver, vlm_config  # noqa: E402

FAULTS = ("half_batch", "unchanged", "bias_in_weights", "bias_ignored")


def _program(cell, seed: int, device, fault: str = "") -> dict:
    """The program's checked steps on a fresh run, with `fault` planted."""
    from vision_compression_project_tpu_torch.models import layers
    from vision_compression_project_tpu_torch.train import data, train_step

    run = driver("train_lfm2").Run(cell.config, vlm_config(cell.config), cell.traffic, seed, device)
    saved = (data.device_batch, train_step.AdamW.update, layers.TopKMoE.routing, train_step.init_params)
    real_batch, _, real_routing, _ = saved

    def half_batch(*a, **k):
        full = real_batch(*a, **k)
        n = full["token_ids"].shape[0] // 2
        return {key: v[:n] for key, v in full.items()}

    def biased_routing(self, x32):
        choice, _ = real_routing(self, x32)
        w = (torch.sigmoid(self.router(x32)) + self.expert_bias).gather(1, choice)
        return choice, w / (w.sum(dim=-1, keepdim=True) + 1e-6)

    def unbiased_routing(self, x32):
        scores = torch.sigmoid(self.router(x32))
        choice = torch.sort(scores.detach(), dim=-1, descending=True, stable=True).indices[:, : self.k]
        w = scores.gather(1, choice)
        return choice, w / (w.sum(dim=-1, keepdim=True) + 1e-6)

    train_step.init_params = lambda model, seed: None
    if fault == "half_batch":
        data.device_batch = half_batch
    elif fault == "unchanged":
        train_step.AdamW.update = lambda self, params, state, reduce_sq=None: state
    elif fault == "bias_in_weights":
        layers.TopKMoE.routing = biased_routing
    elif fault == "bias_ignored":
        layers.TopKMoE.routing = unbiased_routing
    try:
        run.setup()
    finally:
        data.device_batch, train_step.AdamW.update, layers.TopKMoE.routing, train_step.init_params = saved
    got = run.program()
    run.release()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def readings(cell, seed: int, device, parts) -> dict:
    from portbench import traffic as traffic_mod

    mod = driver("train_lfm2")
    run = mod.Run(cell.config, vlm_config(cell.config), cell.traffic, seed, device)
    run.batches = traffic_mod.host_batches(cell.traffic, cell.config, seed)

    def judged(got: dict) -> dict:
        found = mod.Run.compare(got, run.reference(against=got))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return {k: v for k, v in found.items() if not k.startswith("_")}

    out = {"program": judged(_program(cell, seed, device))}
    if "control" in parts:
        out["control"] = judged(run.reference(low=True, keep=True))
    for f in FAULTS:
        if f in parts:
            out[f] = judged(_program(cell, seed, device, f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="control," + ",".join(FAULTS),
                    help="besides the program: control, " + ", ".join(FAULTS) + ", or none")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    parts = tuple(p for p in args.parts.split(",") if p != "none")
    for name in args.cells.split(","):
        cell = spec.find_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            rec = {"cell": name, "seed": seed, **readings(cell, seed, device, parts),
                   "seconds": time.perf_counter() - t0}
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
