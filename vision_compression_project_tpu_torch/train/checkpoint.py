"""Checkpoints: the port of vision_compression_project_tpu/train/checkpoint.py.

Directory names are the reference's: `step_NNNNNNNN/` for a training state,
`params_NNNNNNNN/` for params only. The port writes its own format, not
orbax's: one `checkpoint.pt` in the directory, a `torch.save` of plain dicts
(the params under the reference's dotted flax names and layouts,
`weights.params_to_jax`; the optimizer's moments under the same names; the
counts), read back with `torch.load(weights_only=True)`. A save writes under
a temporary name and moves the directory into place with `os.replace`, so
`complete_steps` never sees a partial one.

Reading takes either format: `load_params(ckpt_dir)` and
`load_runner(cfg, ckpt_dir)` read the newest complete checkpoint, the port's
through `torch.load`, the JAX package's orbax ones (the shipped weights,
`step_NNN` TrainStates) through the port's own reader (train/ocdbt.py). With
neither present `load_runner` returns a runner with fresh seeded weights, as
the reference does.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..weights import leaf_tensor, params_from_jax, params_to_jax
from .ocdbt import read_checkpoint

# A TrainState saves as the sequence (params, opt_state, step); params is child "0".
TRAIN_STATE_PARAMS = ("0",)
# SHA-256 of every shipped tensor's bytes, {preset: {dotted name: hex}}:
# `param_digests` of the shipped checkpoints, held equal to orbax's restore by
# tests/test_torch_checkpoint.py and to what the card decodes by chip_smoke.py.
SHIPPED_DIGESTS = Path(__file__).resolve().parent / "shipped_digests.json"
# The file of a checkpoint the port wrote.
PORT_FILE = "checkpoint.pt"


def complete_steps(ckpt_dir, prefix: str = "step") -> List[Path]:
    """COMPLETE `<prefix>_NNN` checkpoint dirs, sorted by step. A save killed
    midway leaves a partial under another name (orbax's
    `<prefix>_NNN.orbax-checkpoint-tmp-<ts>`, the port's
    `.<prefix>_NNN.tmp-<pid>`); only exact `<prefix>_<digits>` names count."""
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


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = leaf_tensor(value)
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *parts, leaf = name.split(".")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        # numpy has no bfloat16 of its own: such leaves stay tensors (weights.py).
        node[leaf] = value if value.dtype == torch.bfloat16 else value.numpy()
    return tree


def _write(ckpt_dir, name: str, payload: dict) -> Path:
    """torch.save `payload` as `<ckpt_dir>/<name>/checkpoint.pt`, written
    under a temporary directory name and moved into place (a checkpoint of
    the same name is replaced, as orbax's force=True does)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / name
    tmp = ckpt_dir / f".{name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(payload, tmp / PORT_FILE)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir, state, step: Optional[int] = None) -> Path:
    """Write `step_NNNNNNNN/` (NNN = `step`, else state.step) with the
    TrainState's params, its optimizer moments and counts (when it has an
    optimizer state) and its step."""
    step = int(state.step if step is None else step)
    opt = state.opt_state
    payload = {
        "params": _flatten(params_to_jax(state.params, state.cfg)),
        "opt_state": None if opt is None else {
            "mu": _flatten(params_to_jax(opt.mu, state.cfg)),
            "nu": _flatten(params_to_jax(opt.nu, state.cfg)),
            "count": int(opt.count),
        },
        "step": int(state.step),
    }
    return _write(ckpt_dir, f"step_{step:08d}", payload)


def save_params(ckpt_dir, params: Mapping, step: int = 0) -> Path:
    """A params-only checkpoint `params_NNNNNNNN/`, the format for serving
    weights, of a flax-named params tree of numpy arrays (what load_params
    returns; `weights.params_to_jax(state_dict, cfg)` of a model)."""
    return _write(ckpt_dir, f"params_{step:08d}", {"params": _flatten(params)})


def _load_port(path: Path) -> dict:
    return torch.load(path / PORT_FILE, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir, state):
    """Restore the newest complete `step_NNN` checkpoint the port wrote into
    `state` (a TrainState of the same model) in place, params, moments and
    counts, and return it; None when there is none. An orbax TrainState (the
    JAX package's) raises: load_params reads its params."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    if not (path / PORT_FILE).exists():
        raise ValueError(f"{path} is an orbax checkpoint: load_params reads its params, not its optimizer state")
    saved = _load_port(path)

    def copy_into(dst: Mapping[str, torch.Tensor], flat: Mapping[str, torch.Tensor]) -> None:
        src = params_from_jax(_unflatten(flat))
        if set(src) != set(dst):
            raise ValueError(f"{path}: the checkpoint's tensors do not fit the state's")
        with torch.no_grad():
            for name, tensor in dst.items():
                tensor.copy_(src[name])

    copy_into(state.params, saved["params"])
    opt = saved["opt_state"]
    if opt is not None and state.opt_state is not None:
        copy_into(state.opt_state.mu, opt["mu"])
        copy_into(state.opt_state.nu, opt["nu"])
        state.opt_state.count = int(opt["count"])
    state.step = int(saved["step"])
    return state


def _read_params(path: Path, subtree=()) -> dict:
    if (path / PORT_FILE).exists():
        return _unflatten(_load_port(path)["params"])
    return read_checkpoint(path, subtree=subtree)


def load_params(ckpt_dir) -> Optional[dict]:
    """The newest checkpoint's params as nested dicts of numpy arrays, or
    None when `ckpt_dir` holds no complete checkpoint: a params-only one
    first, else a training state, in the port's format or orbax's."""
    params_path = latest_params(ckpt_dir)
    if params_path is not None:
        return _read_params(params_path)
    step_path = latest_checkpoint(ckpt_dir)
    if step_path is not None:
        return _read_params(step_path, TRAIN_STATE_PARAMS)
    return None


def _leaf_bytes(value) -> bytes:
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(value).tobytes()


def param_digests(tree: Mapping, prefix: str = "") -> Dict[str, str]:
    """{dotted name: SHA-256 hex of the array's C-order bytes} of a params tree."""
    out: Dict[str, str] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(param_digests(value, name + "."))
        else:
            out[name] = hashlib.sha256(_leaf_bytes(value)).hexdigest()
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
