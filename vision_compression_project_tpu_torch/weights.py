"""The one bridge between the JAX package's parameters and this package's
modules: `params_from_jax` maps a flax parameter tree (nested dicts of numpy
arrays) to a state_dict, and `params_to_jax` maps a state_dict (or any tree
of tensors named like one: gradients, optimizer moments) back. They read no
file and write none.

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
from typing import Dict, List, Mapping, Tuple

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


def _head_dims(cfg) -> List[Tuple[str, int]]:
    """(state_dict prefix, head_dim) of every attention module of a model
    built from `cfg`: a VLMConfig (OpticalVLM) or an EmbedderConfig
    (NeuralEmbedderModule)."""
    if hasattr(cfg, "vision"):
        v, d = cfg.vision, cfg.decoder
        return [("vision.local_blocks.", v.dim_local // v.heads_local),
                ("vision.global_blocks.", v.dim_global // v.heads_global),
                ("decoder.blocks.", d.head_dim)]
    return [("blocks.", cfg.dim // cfg.heads)]


# state_dict module names -> flax names, on the dotted path.
_TO_JAX = [
    (re.compile(r"(^|\.)local_blocks\.(\d+)(?=\.)"), r"\1local_\2"),
    (re.compile(r"(^|\.)global_blocks\.(\d+)(?=\.)"), r"\1global_\2"),
    (re.compile(r"(^|\.)blocks\.(\d+)(?=\.)"), r"\1block_\2"),
]


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg) -> Dict:
    """A state_dict of OpticalVLM(cfg) or NeuralEmbedderModule(cfg) (or a
    tree of gradients or moments under the same names) -> the flax parameter
    tree of the JAX package's model, nested dicts of f32 numpy arrays: the
    inverse of `params_from_jax`. `cfg` gives each attention module's
    head_dim, which the (heads * head_dim, embed) weights do not show."""
    heads = _head_dims(cfg)
    embedder = not hasattr(cfg, "vision")
    out: Dict = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().to("cpu", torch.float32).numpy()
        flax_name = name
        for pattern, repl in _TO_JAX:
            flax_name = pattern.sub(repl, flax_name)
        *parts, leaf = flax_name.split(".")
        if embedder and parts == ["embed"]:
            parts = ["Embed_0"]
        if leaf == "weight":
            parent = parts[-1]
            if parent in ("embed", "Embed_0"):
                leaf = "embedding"
            elif value.ndim == 4:
                leaf, value = "kernel", value.transpose(2, 3, 1, 0)
            elif parent in ("wq", "wk", "wv", "wo"):
                head_dim = next(hd for prefix, hd in heads if name.startswith(prefix))
                if parent == "wo":
                    leaf, value = "kernel", value.T.reshape(-1, head_dim, value.shape[0])
                else:
                    leaf, value = "kernel", value.T.reshape(value.shape[1], -1, head_dim)
            else:
                leaf, value = "kernel", value.T
        node = out
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return out
