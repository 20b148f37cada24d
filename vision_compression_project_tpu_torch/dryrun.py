"""The multi-device dry run of the port: the counterpart of the repository's
`__graft_entry__.py` (`entry`, `dryrun_multichip`).

entry(device=None): the forward of the `base` model (OpticalVLM) with the
reference's example arguments, as (fn, args) with fn(*args) the logits.

dryrun_multichip(n): the whole training step (train/train_step.py: DP over
`data`, TP over `model`, EP over `expert`, SP over `seq`) on n ranks, over
a matrix of mesh factorings chosen so that every axis is more than one rank
in at least one of them, and the losses checked to agree across factorings
(the parallelisation must not change the math); for an even n also the
pipelined step (train/pp_train.py: GPipe over `model`, with DP) at data
n / 2 x model 2. It prints the reference's lines. With n cards it runs over
NCCL, one rank a card; otherwise it spawns n gloo ranks on the CPU
(`parallel.spawn`), the counterpart of the reference re-executing itself on
n virtual CPU devices.

    python -m vision_compression_project_tpu_torch.dryrun 8
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from .models import get_preset
from .models.tokenizer import PAD_ID
from .parallel import MESH_AXES, MeshConfig, build_mesh, shard_batch, spawn
from .train.pp_train import make_pp_train_state, make_pp_vlm_train_step
from .train.train_step import make_train_state, resolve_device, train_step

PRESET = "tiny_moe"  # MoE, so the expert axis carries real EP sharding
TEXT_LEN = 16
LR = 1e-3
PP_MICROBATCHES = 2
LOSS_RTOL = 5e-2  # losses of different factorings within 5e-2 x max(1, |loss|), as the reference asserts
SPAWN_TIMEOUT_S = 600


def entry(device=None):
    """(forward, example_args): forward(params, patch_tokens, token_ids) ->
    logits of OpticalVLM(base) with the seed-0 weights, params its
    state_dict, on `device` (the card unless the caller asks for the CPU)."""
    from .models.vlm import OpticalVLM, init_params

    cfg = get_preset("base")
    dev = resolve_device(device)
    with torch.device(dev):
        model = OpticalVLM(cfg)
    init_params(model, 0)
    model.to(dev).eval()
    grid, patch_dim = cfg.vision.grid, cfg.vision.patch ** 2 * 3
    batch, text_len = 2, 128

    def forward(params, patch_tokens, token_ids):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (patch_tokens, token_ids))

    example_args = (
        dict(model.state_dict()),
        torch.zeros((batch, grid * grid, patch_dim), dtype=torch.bfloat16, device=dev),
        torch.zeros((batch, text_len), dtype=torch.long, device=dev),
    )
    return forward, example_args


def _mesh_matrix(n: int) -> List[MeshConfig]:
    """Mesh factorings whose union puts every axis above one rank, n allowing:
    for n % 8 == 0, (data, 1, 2, 2) and (data, 2, 1, 2)."""
    if n % 8 == 0:
        return [MeshConfig(data=n // 4, seq=1, expert=2, model=2), MeshConfig(data=n // 4, seq=2, expert=1, model=2)]
    if n % 4 == 0:
        return [MeshConfig(data=n // 4, seq=1, expert=2, model=2), MeshConfig(data=n // 4, seq=2, expert=2, model=1)]
    if n % 2 == 0:
        return [MeshConfig(data=n // 2, seq=1, expert=1, model=2), MeshConfig(data=n // 2, seq=2, expert=1, model=1)]
    return [MeshConfig(data=n, seq=1, expert=1, model=1)]


def _batch(cfg, batch: int, seed: int, device) -> dict:
    """The reference's dry-run batch: seeded ids with two PAD columns and
    normal bf16 patch tokens."""
    rng = np.random.default_rng(seed)
    grid, patch_dim = cfg.vision.grid, cfg.vision.patch ** 2 * 3
    ids = rng.integers(0, 255, size=(batch, TEXT_LEN)).astype(np.int64)
    ids[:, -2:] = PAD_ID
    pages = rng.standard_normal((batch, grid * grid, patch_dim))
    return {"patch_tokens": torch.tensor(pages, dtype=torch.float32).to(torch.bfloat16).to(device),
            "token_ids": torch.from_numpy(ids).to(device)}


def _shape(mesh) -> dict:
    return dict(zip(MESH_AXES, mesh.shape))


def _dryrun_rank(n_devices: int, device_type: str) -> Optional[List[str]]:
    """One rank of the dry run; rank 0 returns the lines to print."""
    device = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    cfg = get_preset(PRESET)
    lines, losses = [], []
    for cfg_mesh in _mesh_matrix(n_devices):
        mesh = build_mesh(cfg_mesh, device_type)
        shape = _shape(mesh)
        model, opt, state = make_train_state(cfg, device, lr=LR, mesh=mesh)
        batch = shard_batch(_batch(cfg, 2 * shape["data"], 0, device), mesh)
        state, loss = train_step(model, opt, state, batch, mesh=mesh)
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} on {cfg_mesh}")
        if shape["expert"] > 1:  # the experts really sharded over `expert`
            w = model.decoder.blocks[0].mlp.w_gate
            assert w.shape[0] == cfg.decoder.num_experts // shape["expert"], tuple(w.shape)
        if shape["model"] > 1:  # and the query heads over `model`
            w = model.decoder.blocks[0].attn.wq.weight
            assert w.shape[0] == cfg.decoder.heads * cfg.decoder.head_dim // shape["model"], tuple(w.shape)
        losses.append((shape, loss))
        lines.append(f"dryrun mesh={shape} loss={loss:.4f} step={state.step}")
        del model, opt, state

    base = losses[0][1]
    for _, loss in losses[1:]:
        assert abs(loss - base) <= LOSS_RTOL * max(1.0, abs(base)), f"loss mismatch across meshes: {losses}"

    if n_devices % 2 == 0:
        mesh = build_mesh(MeshConfig(data=n_devices // 2, model=2), device_type)
        shape = _shape(mesh)
        model, opt, state = make_pp_train_state(cfg, device, lr=LR, mesh=mesh)
        step, rows = make_pp_vlm_train_step(model, opt, mesh, n_micro=PP_MICROBATCHES)
        state, pp_loss = step(state, rows(_batch(cfg, 2 * shape["data"], 1, device)))
        pp_loss = float(pp_loss)
        if not np.isfinite(pp_loss):
            raise AssertionError(f"non-finite PP loss {pp_loss}")
        lines.append(f"dryrun PP mesh={shape} loss={pp_loss:.4f}")

    covered = {ax for shape, _ in losses for ax, size in shape.items() if size > 1}
    if n_devices % 2 == 0:
        covered.add("pipeline(model)")
    lines.append(f"dryrun_multichip OK: n={n_devices} meshes={len(losses)} axes>1={sorted(covered)}")
    return lines if torch.distributed.get_rank() == 0 else None


def dryrun_multichip(n_devices: int, device_type: Optional[str] = None) -> List[str]:
    """Run the dry run on n ranks (the module docstring) and print its lines;
    returns them. device_type: "cuda" (n cards needed), "cpu" (gloo), or
    None for the card when n are present, else the CPU."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and torch.cuda.device_count() >= n_devices else "cpu"
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} cards asked for, {torch.cuda.device_count()} present")
    lines = spawn(_dryrun_rank, n_devices, n_devices, device_type, device_type=device_type,
                  timeout_s=SPAWN_TIMEOUT_S)[0]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    # The rank function pickled under the package's name, not __main__'s.
    from vision_compression_project_tpu_torch.dryrun import dryrun_multichip as _dryrun

    _dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
