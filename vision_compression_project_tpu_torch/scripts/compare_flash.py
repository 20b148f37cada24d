"""Time K1's forward and backward kernels of several checkouts on one card, in turns.

    python -m vision_compression_project_tpu_torch.scripts.compare_flash \\
        --roots OLD,NEW,NEW,OLD [--seed N] [--json PATH]

Each root is a directory holding a `vision_compression_project_tpu_torch`
package (a checkout, or `git archive` of a commit unpacked). For each root in
the order given, a fresh process puts that root first on the import path,
builds its K1 forward and backward kernels, and runs this checkout's
`chip_smoke.py` phases with them:

* `train_kernel_phase` at the training shapes `[train]` uses (ocr_real at
  mixC, the embedder, ocr_bpe's answer step, prod_train) and at the pipeline's
  microbatch call: every check of that phase holds (output and gradients
  against autograd and the plain backward, the log-sum-exp, bit-identical
  reruns), and in bf16 the lse-writing forward and the backward are timed
  eager and from CUDA graphs beside SDPA's forward and backward and the
  bounds;
* `kernel_phase` at the serving shapes (an ocr_real page batch, the first
  `/chat` question, a neural embed call, a prod page batch): K1 against
  mha_reference, timed eager and from graphs beside SDPA;
* at the bf16 shapes of ocr_real's mixC step and prod_train's step, the
  device time of one forward call (lse-writing) and of each of the
  backward's launches (its Delta, dK/dV and dQ passes) from `torch.profiler`.

One `[compare]` line per root and training step, per root and shape, and per
root and serving unit, then, with --json, every record in one file. Running
the roots in turns (old, new, new, old) in one process tree keeps them on one
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
STEP_KEYS = ("launches_per_step", "ms", "graph_ms", "library_ms", "library_graph_ms", "bound_ms",
             "bwd_launches_per_step", "bwd_ms", "bwd_graph_ms", "library_bwd_ms", "library_bwd_graph_ms",
             "bwd_bound_ms", "bwd_bound_by")
SERVING_KEYS = ("ms", "graph_ms", "library_ms", "library_graph_ms", "bound_ms")
PASSES = (("forward", "flash_fwd"), ("delta", "delta_kernel"), ("dkdv", "dkdv"), ("dq", "dq_"))


def child(root: str, seed: int) -> dict:
    """Measure the kernels of `root` with this checkout's chip_smoke."""
    sys.path[:] = [str(Path(root).resolve())] + [p for p in sys.path if p not in ("", str(REPO), os.getcwd())]
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    if not Path(smoke.kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"kernels imported from {smoke.kernels.__file__}, not from {root}")
    for name in ("flash_attention", "flash_attention_bwd"):
        smoke.kernels.build(name)
    cfg, chat_cfg, prod_cfg = (smoke.get_preset(p) for p in (smoke.PRESET, smoke.CHAT_PRESET, smoke.PROD_PRESET))
    pair = next(smoke.synthetic_pair_batches(smoke.EMBED_BATCH, seed=seed))
    shapes = smoke.train_shapes(cfg, [int(n) for n in pair["d_len"]], chat_cfg, smoke.prod_train_config(prod_cfg))
    shapes.append(smoke.pp_microbatch_shape(cfg))
    rec = smoke.train_kernel_phase(shapes, seed)
    rec["device_ms"] = {sh.name: device_times(smoke, sh, seed) for sh in shapes if sh.path in ("train", "prod_train")}
    serving = smoke.kernel_phase(smoke.path_shapes(cfg, chat_cfg, smoke.embed_texts(seed)) + smoke.prod_shapes(prod_cfg),
                                 seed)
    rec["serving"] = {"extract_batch": {k: serving[k] for k in SERVING_KEYS},
                      **{unit: {k: serving[unit][k] for k in SERVING_KEYS}
                         for unit in ("chat_first_question", "embed_call", "prod_batch")}}
    return rec


def device_times(smoke, sh, seed: int, calls: int = 5) -> dict:
    """Device ms of one bf16 forward call (writing lse) at `sh` and of each
    pass of one backward call, from the profiler's kernel records (averaged
    over `calls` calls of each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def rnd(heads):
        return torch.randn((sh.b, heads, sh.s, sh.d), generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, g = rnd(sh.h), rnd(sh.hkv), rnd(sh.hkv), rnd(sh.h)
    kv_len = torch.tensor(sh.kv_len, dtype=torch.int32, device="cuda")
    scale = sh.d ** -0.5
    lse = torch.empty((sh.b, sh.h, sh.s), dtype=torch.float32, device="cuda")
    o = smoke.kernels.flash_attention_fwd(q, k, v, kv_len, sh.causal, scale, lse=lse)
    smoke.kernels.flash_attention_bwd(q, k, v, o, g, lse, kv_len, sh.causal, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            smoke.kernels.flash_attention_fwd(q, k, v, kv_len, sh.causal, scale, lse=lse)
            smoke.kernels.flash_attention_bwd(q, k, v, o, g, lse, kv_len, sh.causal, scale)
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in PASSES}
    for ev in prof.key_averages():
        for name, key in PASSES:
            if key in ev.key:
                out[name] += ev.device_time_total / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", required=True, help="comma-separated checkout directories, timed in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write every run's records here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        rec = child(args.child, args.seed)
        print("RESULT " + json.dumps(rec), flush=True)
        return 0
    runs = []
    for i, root in enumerate(args.roots.split(",")):
        proc = subprocess.run([sys.executable, __file__, "--roots", root, "--seed", str(args.seed), "--child", root],
                              capture_output=True, text=True, cwd=REPO)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-8000:], flush=True)
            print(f"FAILED: run {i} ({root}) exited {proc.returncode}", flush=True)
            return 1
        rec = json.loads(lines[-1][len("RESULT "):])
        runs.append({"run": i, "root": root, "rec": rec})
        for path in ("train", "train_embedder", "train_answer", "prod_train"):
            step = {k: rec[path][k] for k in STEP_KEYS}
            print(f"[compare] run={i} root={root} path={path} " + json.dumps(step), flush=True)
        for shape, call in rec["per_shape"].items():
            if shape in rec["device_ms"]:
                call = dict(call, device_ms=rec["device_ms"][shape])
            print(f"[compare] run={i} root={root} shape={shape} " + json.dumps(call), flush=True)
        for unit, times in rec["serving"].items():
            print(f"[compare] run={i} root={root} serving={unit} " + json.dumps(times), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
