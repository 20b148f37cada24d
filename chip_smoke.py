#!/usr/bin/env python3
"""Drive the PyTorch port's page-extraction path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the repository root, on a machine with a CUDA card and nvcc. It
needs torch, numpy and the standard library; it reads no checkpoint (weights
are random, made from the seed). One flushed line per phase, with seconds:

  device   the card's name and power limit;
  build    compile the hand-written kernels from the sources in the repo;
  kernel   hold each kernel against its plain PyTorch version on the card at
           every shape the ocr_real path gives it (and a ragged key length),
           and time the kernel, the plain version, a one-call PyTorch
           yardstick and the card's bound for the same work;
  slice    VLMRunner(ocr_real, seed).extract_batch on 4 gray 1023x791 pages
           (US Letter at dpi 93) with max_new=256, launch counts zeroed just
           before and read just after; then the same path timed by stage,
           five times, printing each stage's median, min and max;
  logits   first-step logits of the kernel path on the card against the
           plain path on the CPU, in f32, on one page.

The last three lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}. Any
failed check exits non-zero before them. Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.models import VLMRunner, get_preset
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID, EOS_ID, TASK_EXTRACT_ID
from vision_compression_project_tpu_torch.models.vlm import CACHE_BUCKET, PROMPT_BUCKET
from vision_compression_project_tpu_torch.ops.attention import flash_attention, mha_reference

PRESET = "ocr_real"
N_PAGES = 4
PAGE_HW = (1023, 791)  # US Letter at dpi 93, the reader's bench render
MAX_NEW = 256
TIMED_REPEATS = 5  # warm runs of the path timed by stage; median and range printed

# Kernel against plain version, max abs error of the output. With randn
# q/k/v a typical output value is about sqrt(e/S), 0.05 to 0.1 at these
# shapes; the bf16 limit stays well under that.
TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}
# First-step logits (scale ~1), kernel path on the card vs plain path on the
# CPU, both f32 with TF32 off: the same arithmetic summed in another order.
LOGITS_ATOL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(phase: str, seconds: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {seconds:.3f}s {extra}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@dataclasses.dataclass
class AttnShape:
    name: str
    b: int
    h: int
    hkv: int
    s: int
    d: int
    causal: bool
    kv_len: list           # per batch row
    launches: int          # launches per page batch on the main path (0: extra check)


def path_shapes(cfg) -> list:
    """Every flash-attention call of one ocr_real page batch, from the config."""
    v, dec = cfg.vision, cfg.decoder
    win = min(v.window, v.grid)
    nwin = (v.grid // win) ** 2
    vis = v.tokens_out
    s_dec = vis + PROMPT_BUCKET  # the 2-token prompt pads to one bucket
    return [
        AttnShape("encoder_local", N_PAGES * nwin, v.heads_local, v.heads_local, win * win,
                  v.dim_local // v.heads_local, False, [win * win] * (N_PAGES * nwin), v.depth_local),
        AttnShape("encoder_global", N_PAGES, v.heads_global, v.heads_global, vis,
                  v.dim_global // v.heads_global, False, [vis] * N_PAGES, v.depth_global),
        AttnShape("decoder_prefill", N_PAGES, dec.heads, dec.kv_heads, s_dec, dec.head_dim, True,
                  [vis + 2] * N_PAGES, dec.depth),
        AttnShape("decoder_prefill_ragged", 2, dec.heads, dec.kv_heads, s_dec, dec.head_dim, True,
                  [vis + 2, s_dec - 1], 0),
    ]


def bound_ms(sh: AttnShape, dtype: torch.dtype):
    """(least time in ms, "bytes" or "operations") for one call: q, k, v and
    kv_len read once, o written once; 4*D operations per (query, key) pair
    that the masks leave, counted from this call's key lengths."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * sh.b * sh.h + 2 * sh.b * sh.hkv) * sh.s * sh.d * item + 4 * sh.b
    rows = np.arange(sh.s)
    pairs = 0
    for n in sh.kv_len:
        pairs += int(np.minimum(rows + 1, n).sum()) if sh.causal else n * sh.s
    ops = 4 * sh.d * pairs * sh.h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(q, k, v, sh: AttnShape):
    """One PyTorch call computing the same attention, as a yardstick only."""
    mask = None
    if sh.causal or any(n < sh.s for n in sh.kv_len):
        idx = torch.arange(sh.s, device=q.device)
        kv = torch.tensor(sh.kv_len, device=q.device)
        mask = (idx[None, None, None, :] < kv[:, None, None, None])
        if sh.causal:
            mask = mask & (idx[None, None, None, :] <= idx[None, None, :, None])
    gqa = sh.h != sh.hkv
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=gqa)


def kernel_phase(cfg, seed: int):
    rows, record = [], {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for sh in path_shapes(cfg):
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(heads):
                return torch.randn((sh.b, heads, sh.s, sh.d), generator=gen, device="cuda").to(dtype)
            q, k, v = rnd(sh.h), rnd(sh.hkv), rnd(sh.hkv)
            kv_len = torch.tensor(sh.kv_len, dtype=torch.int32, device="cuda")
            out = flash_attention(q, k, v, kv_len=kv_len, causal=sh.causal)
            torch.cuda.synchronize()
            want = mha_reference(q, k, v, kv_len=kv_len, causal=sh.causal)
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            row = dict(shape=sh.name, dtype=str(dtype).replace("torch.", ""),
                       q=[sh.b, sh.h, sh.s, sh.d], kv=[sh.b, sh.hkv, sh.s, sh.d],
                       causal=sh.causal, max_abs_err=err, tol=TOL[dtype], ok=ok)
            if dtype == torch.bfloat16:
                row["ms"] = cuda_ms(lambda: flash_attention(q, k, v, kv_len=kv_len, causal=sh.causal), 20)
                row["plain_ms"] = cuda_ms(
                    lambda: mha_reference(q, k, v, kv_len=kv_len, causal=sh.causal), 5, warmup=1)
                row["library_ms"] = cuda_ms(library_call(q, k, v, sh), 20)
                row["bound_ms"], row["bound_by"] = bound_ms(sh, dtype)
                row["launches_per_batch"] = sh.launches
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok:
                fail(f"flash_attention {sh.name} {dtype}: max abs err {err} > {TOL[dtype]}")
            del q, k, v, out, want
    torch.cuda.empty_cache()
    # One page batch's worth of K1 on the main path: per-shape numbers
    # weighted by that shape's launches per batch.
    main = [r for r in rows if r.get("launches_per_batch")]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        record[key] = sum(r[key] * r["launches_per_batch"] for r in main)
    ops_ms = sum(r["bound_ms"] * r["launches_per_batch"] for r in main if r["bound_by"] == "operations")
    record["bound_by"] = "operations" if ops_ms >= record["bound_ms"] / 2 else "bytes"
    record["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")
    return record


def make_pages(seed: int) -> np.ndarray:
    """Gray uint8 pages: white paper with 14 lines of dark glyph-like marks."""
    rng = np.random.default_rng(seed)
    h, w = PAGE_HW
    pages = np.full((N_PAGES, h, w), 255, np.uint8)
    for p in range(N_PAGES):
        for line in range(14):
            top = 60 + line * 66
            x = 50
            while x < w - 80:
                gw = int(rng.integers(8, 22))
                pages[p, top : top + 24, x : x + gw] = rng.integers(0, 90, (24, gw), dtype=np.uint8)
                x += gw + int(rng.integers(2, 14))
    return pages


def sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def slice_phase(cfg, seed: int, expected_launches: int):
    t0 = time.perf_counter()
    runner = VLMRunner(cfg, seed=seed)
    pages = make_pages(seed)
    log("slice.init", sync_s(t0), preset=PRESET, pages=list(pages.shape))

    page_numbers = list(range(1, N_PAGES + 1))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = runner.extract_batch(pages, page_numbers, max_new=MAX_NEW)
    first_s = sync_s(t0)
    launches = dict(kernels.launches)
    log("slice.extract_batch", first_s, launches=launches["flash_attention"])
    if launches["flash_attention"] != expected_launches:
        fail(f"flash_attention launched {launches['flash_attention']} times, expected {expected_launches}")
    if len(result) != N_PAGES or [r["page_number"] for r in result] != page_numbers:
        fail(f"bad page list: {[r.get('page_number') for r in result]}")
    for r in result:
        if set(r) != {"page_number", "markdown", "entities", "summary"}:
            fail(f"bad page keys {sorted(r)}")
        if not isinstance(r["markdown"], str) or not isinstance(r["summary"], str) or not all(
            isinstance(e, str) for e in r["entities"]
        ):
            fail("bad page field types")
    print("pages " + json.dumps([{k: (v[:60] if isinstance(v, str) else v) for k, v in r.items()}
                                  for r in result]), flush=True)

    # The same path again, warm, timed by stage TIMED_REPEATS times.
    prompts = [[BOS_ID, TASK_EXTRACT_ID]] * N_PAGES
    samples = {"encode_s": [], "prefill_s": [], "decode_s": []}
    t_all = time.perf_counter()
    for _ in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        vis = runner.encode(runner.preprocess_patches(pages))
        samples["encode_s"].append(sync_s(t0))
        ids, lens = runner.pad_prompts(prompts)
        cache_len = -(-(vis.shape[1] + ids.shape[1] + MAX_NEW) // CACHE_BUCKET) * CACHE_BUCKET
        t0 = time.perf_counter()
        logits, _, _ = runner.first_logits(ids, lens, vis, cache_len)
        prefill_s = sync_s(t0)
        samples["prefill_s"].append(prefill_s)
        if not bool(torch.isfinite(logits).all()):
            fail("non-finite first-step logits")
        t0 = time.perf_counter()
        toks = runner.generate(prompts, vis, MAX_NEW)
        samples["decode_s"].append(max(sync_s(t0) - prefill_s, 1e-9))
    toks = toks.cpu().numpy()
    ends = [int(np.argmax(row == EOS_ID)) if (row == EOS_ID).any() else MAX_NEW - 1 for row in toks]
    steps = max(ends)  # decode steps after the first token, which prefill gives
    timing = {"repeats": TIMED_REPEATS, "decode_steps": steps, "first_extract_batch_s": first_s}
    for key, vals in samples.items():
        timing[key] = float(np.median(vals))
        timing[f"{key[:-2]}_min_s"] = min(vals)
        timing[f"{key[:-2]}_max_s"] = max(vals)
    timing["decode_tokens_per_s"] = N_PAGES * steps / timing["decode_s"]
    log("slice.timed", time.perf_counter() - t_all, **timing)
    return launches, timing


def logits_phase(cfg, seed: int):
    """Kernel path (card) against plain path (CPU) in f32 on one page."""
    cfg32 = dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, dtype="float32"),
        decoder=dataclasses.replace(cfg.decoder, dtype="float32"),
    )
    page = make_pages(seed)[:1]
    out = {}
    for device in ("cuda", "cpu"):
        runner = VLMRunner(cfg32, seed=seed, device=device)
        vis = runner.encode(runner.preprocess_patches(page))
        ids, lens = runner.pad_prompts([[BOS_ID, TASK_EXTRACT_ID]])
        logits, _, _ = runner.first_logits(ids, lens, vis, vis.shape[1] + ids.shape[1])
        out[device] = logits.float().cpu()
        del runner
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    return err, float(out["cpu"].abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    # A reference in f32 means f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_preset(PRESET)

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", time.perf_counter() - t0, name=json.dumps(kind), smi=json.dumps(smi),
        torch=torch.__version__, cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = kernels.build("flash_attention")
    log("build", time.perf_counter() - t0, flash_attention=lib.name)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    t0 = time.perf_counter()
    record = kernel_phase(cfg, args.seed)
    log("kernel", sync_s(t0), **{k: record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})

    expected = cfg.vision.depth_local + cfg.vision.depth_global + cfg.decoder.depth
    t0 = time.perf_counter()
    launches, _ = slice_phase(cfg, args.seed, expected)
    log("slice", sync_s(t0))

    t0 = time.perf_counter()
    err, scale = logits_phase(cfg, args.seed)
    log("logits", time.perf_counter() - t0, max_abs_err=err, logits_absmax=scale, atol=LOGITS_ATOL)
    if not err <= LOGITS_ATOL:
        fail(f"first-step logits differ by {err} > {LOGITS_ATOL}")

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "vision_compression_project_tpu_torch/kernels/flash_attention.cu",
        "replaces": "vision_compression_project_tpu/ops/attention.py:30",
        "launches": launches["flash_attention"],
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": record["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
