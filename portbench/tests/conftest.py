"""Shared pieces of the benchmark's CPU tests: cells of BENCHMARK.json cut to
the port's tiny presets and small traffic, run on the CPU."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TRAFFIC = {
    "train": {"kind": "train", "batch": 4, "page_h": 80, "page_w": 62, "lines": 4, "text_len": 48, "min_text": 30,
              "pool": 4, "lr": 8e-4, "checked_steps": 3, "trace_units": 2},
    "extract": {"kind": "extract", "batch": 4, "page_h": 80, "page_w": 62, "lines": 4, "max_new": 24, "pool": 2,
                "sample_rows": 3, "trace_units": 1},
}
CELLS = {"train": "ocr_real.train_mixc_b32", "train_moe": "prod_train.train_mixc_b32"}
# The extraction cell is built and checked but not in BENCHMARK.json (its
# spread needs a bound past the contract's; PERF.md): its metrics are here.
EXTRACT_E2E = [{"name": "extract_pages_per_s", "unit": "pages/s"}, {"name": "setup_s", "unit": "s"}]
EXTRACT_PER_LAYER = [{"name": n, "unit": u, "moves": "extract_pages_per_s"} for n, u in (
    ("mfu.extract", "%"), ("k1_fwd_roofline.extract", "%"), ("ms_per_decode_step.extract", "ms"),
    ("device_idle.extract", "%"))]
# Limits at the tiny presets, set from their own readings on the CPU (sound
# runs, the control and the faults, as the cells' limits are set from the
# card's): tiny reads loss 4e-4, grad 0.8%, update 0.35% at most, its
# control 5e-3 / 4.6% / 1.8% at least; tiny_moe's routing flips (4 experts,
# 192 tokens) read up to 9e-3 / 5% / 1.5% sound, and half a batch 2% / 14% /
# 8% at least; extraction 0.023 sound, 0.14 the control.
TINY_LIMITS = {
    "train": {"loss_gap": 2e-3, "grad_gap": 0.03, "update_gap": 0.01},
    "train_moe": {"loss_gap": 0.015, "grad_gap": 0.1, "update_gap": 0.05},
    "extract": {"logit_gap": 0.1},
}


def tiny_config(preset: str, dtype: str = None) -> dict:
    from vision_compression_project_tpu_torch.models.configs import get_preset

    c = get_preset(preset)
    cfg = {"name": preset, "vision": dataclasses.asdict(c.vision), "decoder": dataclasses.asdict(c.decoder)}
    if dtype:
        cfg["vision"]["dtype"] = cfg["decoder"]["dtype"] = dtype
    return cfg


def tiny_cell(which: str, preset: str = "tiny"):
    """The BENCHMARK.json cell `CELLS[which]` (or the extraction cell) with
    the tiny preset, small traffic of its kind and the tiny limits."""
    from portbench import spec

    if which == "extract":
        return spec.Cell("ocr_real.extract_b32", preset, "extract_b32", 1, tiny_config(preset),
                         dict(TINY_TRAFFIC["extract"]), dict(TINY_LIMITS["extract"]), EXTRACT_E2E, EXTRACT_PER_LAYER)
    cell = spec.find_cell(CELLS[which])
    return dataclasses.replace(cell, config=tiny_config(preset), traffic=dict(TINY_TRAFFIC["train"]),
                               limits=dict(TINY_LIMITS[which]))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
