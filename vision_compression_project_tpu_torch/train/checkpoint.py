"""Trained weights from the JAX package's orbax checkpoints: the port of the
restore side of vision_compression_project_tpu/train/checkpoint.py.

`load_runner(cfg, ckpt_dir)` builds a VLMRunner from the newest complete
checkpoint in `ckpt_dir`: a params-only serving checkpoint (`params_NNN`, the
shipped format) or a TrainState one (`step_NNN`, of which only the params are
read), through the port's own reader (train/ocdbt.py). With neither present
it returns a runner with fresh seeded weights, as the reference does. Saving
is not ported: the port never writes a checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np

from ..weights import params_from_jax
from .ocdbt import read_checkpoint

# A TrainState saves as the sequence (params, opt_state, step); params is child "0".
TRAIN_STATE_PARAMS = ("0",)
# SHA-256 of every shipped tensor's bytes, {preset: {dotted name: hex}}:
# `param_digests` of the shipped checkpoints, held equal to orbax's restore by
# tests/test_torch_checkpoint.py and to what the card decodes by chip_smoke.py.
SHIPPED_DIGESTS = Path(__file__).resolve().parent / "shipped_digests.json"


def complete_steps(ckpt_dir, prefix: str = "step") -> List[Path]:
    """COMPLETE `<prefix>_NNN` checkpoint dirs, sorted by step. A save killed
    midway leaves `<prefix>_NNN.orbax-checkpoint-tmp-<ts>` partials; only
    exact `<prefix>_<digits>` names count."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    pat = re.compile(rf"{prefix}_\d+")
    return sorted(p for p in ckpt_dir.iterdir() if p.is_dir() and pat.fullmatch(p.name))


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    steps = complete_steps(Path(ckpt_dir).resolve(), "step")
    return steps[-1] if steps else None


def latest_params(ckpt_dir) -> Optional[Path]:
    steps = complete_steps(Path(ckpt_dir).resolve(), "params")
    return steps[-1] if steps else None


def load_params(ckpt_dir) -> Optional[dict]:
    """The newest checkpoint's params as nested dicts of numpy arrays, or
    None when `ckpt_dir` holds no complete checkpoint."""
    params_path = latest_params(ckpt_dir)
    if params_path is not None:
        return read_checkpoint(params_path)
    step_path = latest_checkpoint(ckpt_dir)
    if step_path is not None:
        return read_checkpoint(step_path, subtree=TRAIN_STATE_PARAMS)
    return None


def param_digests(tree: Mapping, prefix: str = "") -> Dict[str, str]:
    """{dotted name: SHA-256 hex of the array's C-order bytes} of a params tree."""
    out: Dict[str, str] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(param_digests(value, name + "."))
        else:
            out[name] = hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest()
    return out


def shipped_digests() -> Dict[str, Dict[str, str]]:
    return json.loads(SHIPPED_DIGESTS.read_text())


def load_runner(cfg, ckpt_dir, **runner_kwargs):
    """A VLMRunner with the newest checkpoint's params, or fresh seeded
    weights when there is none. `runner_kwargs` go to VLMRunner (device,
    seed, max_new_default). Loading is strict: a checkpoint whose tree does
    not fit `cfg` raises."""
    from ..models.vlm import VLMRunner

    tree = load_params(ckpt_dir)
    if tree is None:
        return VLMRunner(cfg, **runner_kwargs)
    return VLMRunner(cfg, params=params_from_jax(tree), **runner_kwargs)
