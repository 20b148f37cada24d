"""Export the curriculum's current resume point as a params-only checkpoint:
the port of scripts/export_stage_params.py.

Exports the newest stage checkpoint of <curr> (the stage directory holding
the newest complete step, else curriculum.json's init_from) to
<out>/<stage>_e<ext>/params_NNNNNNNN/ in the port's format (no optimizer
moments, about a third of the size), so `run_curriculum --init_from` can
warm-start on another machine. Older stage exports under <out> are removed.
It exports only when the resume point changed (the marker <out>/exported.json),
so repeated supervisor loops write nothing new.

    python -m vision_compression_project_tpu_torch.scripts.export_stage_params \\
        --curr checkpoints/curriculum --out checkpoints/stage_export
"""

import argparse
import json
import re
import shutil
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--curr", required=True, help="curriculum out dir")
    parser.add_argument("--out", required=True, help="export root")
    parser.add_argument("--preset", default="ocr_real")
    args = parser.parse_args(argv)

    curr = Path(args.curr)
    state_file = curr / "curriculum.json"
    if not state_file.exists():
        print("no curriculum state; nothing to export")
        return 0
    from ..train.checkpoint import complete_steps

    state = json.loads(state_file.read_text())
    src = state.get("init_from")
    # Prefer the newest stage dir holding complete checkpoints: after a
    # crash mid-stage, the stage's own checkpoint is newer than the last
    # completed run in init_from. complete_steps skips partial saves.
    candidates = [p for p in curr.glob("*_e*") if complete_steps(p, "step")]
    if candidates:
        newest = max(candidates, key=lambda p: max(q.stat().st_mtime for q in complete_steps(p, "step")))
        src = str(newest)
    if not src or not Path(src).exists():
        print(f"resume point missing: {src}")
        return 0
    src = Path(src)
    steps = complete_steps(src, "step")
    tag = src.name
    step_n = int(steps[-1].name.split("_")[1]) if steps else 0

    out = Path(args.out)
    marker = out / "exported.json"
    prev = json.loads(marker.read_text()) if marker.exists() else {}
    if prev.get("tag") == tag and prev.get("step") == step_n:
        print(f"already exported: {tag} step {step_n}")
        return 0

    from ..models import get_preset
    from ..train.checkpoint import load_runner, save_params
    from ..weights import params_to_jax

    cfg = get_preset(args.preset)
    runner = load_runner(cfg, str(src.resolve()), device="cpu")
    dest = out / tag
    path = save_params(dest, params_to_jax(runner.model.state_dict(), cfg), step=step_n)
    # Drop older curriculum exports (stage_eN dirs): one resume seed is
    # enough. Exports of other names are not this script's to prune.
    for p in out.iterdir():
        if p.is_dir() and p != dest and re.fullmatch(r".+_e\d+", p.name):
            shutil.rmtree(p)
    marker.write_text(json.dumps(
        {"tag": tag, "step": step_n, "preset": args.preset, "src": str(src),
         "state": {k: state.get(k) for k in ("stage", "extension", "status")}},
        indent=1,
    ))
    print(f"exported: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
