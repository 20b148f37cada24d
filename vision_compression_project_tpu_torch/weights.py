"""The one bridge from the JAX package's parameters to this package's
modules: `params_from_jax` maps a flax parameter tree (nested dicts of numpy
arrays) to a state_dict. It reads no file and writes none.

Layouts:
  Dense kernel (in, out)                      -> Linear weight (out, in)
  wq/wk/wv kernel (embed, heads, head_dim)    -> Linear weight (heads*head_dim, embed)
  wo kernel (heads, head_dim, embed)          -> Linear weight (embed, heads*head_dim)
  Conv kernel HWIO                            -> Conv2d weight OIHW
  bias, RMSNorm scale, pos_embed              -> unchanged
  Embed embedding (vocab, dim)                -> Embedding weight (vocab, dim)
Names: local_<i> -> local_blocks.<i>, global_<i> -> global_blocks.<i>,
block_<i> -> blocks.<i>, Embed_0 (the neural embedder's unnamed nn.Embed)
-> embed.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_RENAMES = [
    (re.compile(r"^local_(\d+)$"), r"local_blocks.\1"),
    (re.compile(r"^global_(\d+)$"), r"global_blocks.\1"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^Embed_0$"), "embed"),
]


def _module_name(part: str) -> str:
    for pattern, repl in _RENAMES:
        if pattern.match(part):
            return pattern.sub(repl, part)
    return part


def _leaf(parent: str, name: str, value: np.ndarray):
    """(torch leaf name, array in torch layout) for one flax leaf."""
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3 and parent == "wo":
            return "weight", value.reshape(-1, value.shape[-1]).T
        if value.ndim == 3:
            return "weight", value.reshape(value.shape[0], -1).T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim} under {parent!r}")
    if name == "embedding":
        return "weight", value
    if name in ("bias", "scale", "pos_embed"):
        return name, value
    raise ValueError(f"unknown parameter {name!r} under {parent!r}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of arrays) -> state_dict of contiguous
    CPU tensors in the arrays' dtype, for OpticalVLM or any of its
    submodules, or for NeuralEmbedderModule."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
                continue
            name, arr = _leaf(path[-1] if path else "", key, np.asarray(value))
            prefix = [_module_name(p) for p in path]
            out[".".join(prefix + [name])] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, [])
    return out
