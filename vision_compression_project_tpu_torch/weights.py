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
  SwitchMoE w_gate/w_up (E, dim, hidden), w_down (E, hidden, dim) -> unchanged
  (the router is a Dense kernel (dim, E))
Names: local_<i> -> local_blocks.<i>, global_<i> -> global_blocks.<i>,
block_<i> -> blocks.<i>, Embed_0 (the neural embedder's unnamed nn.Embed)
-> embed.

Dtypes: every leaf keeps its own. The JAX package stores the experts'
weights in the config's dtype, so a bf16 model has bf16 leaves. numpy has no
bfloat16 of its own (JAX's comes from ml_dtypes, which the port does not
import), so a bf16 leaf is read from any array whose dtype is named
"bfloat16" through its 16-bit pattern, and `params_to_jax` returns it as a
CPU torch.bfloat16 tensor; `leaf_tensor` reads either kind.
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


def leaf_tensor(value) -> torch.Tensor:
    """A params-tree leaf as a CPU tensor of its own dtype, sharing nothing
    with `value`: a torch tensor, or anything np.array takes (a JAX array, a
    numpy array, a bfloat16 one included)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").clone()
    arr = np.array(value, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def _leaf(parent: str, name: str, value: torch.Tensor):
    """(torch leaf name, tensor in torch layout) for one flax leaf."""
    if name == "kernel":
        if value.dim() == 2:
            return "weight", value.t()
        if value.dim() == 3 and parent == "wo":
            return "weight", value.reshape(-1, value.shape[-1]).t()
        if value.dim() == 3:
            return "weight", value.reshape(value.shape[0], -1).t()
        if value.dim() == 4:
            return "weight", value.permute(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.dim()} under {parent!r}")
    if name == "embedding":
        return "weight", value
    if name in ("bias", "scale", "pos_embed") + _EXPERT_WEIGHTS:
        return name, value
    raise ValueError(f"unknown parameter {name!r} under {parent!r}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of arrays, or of tensors as
    `params_to_jax` and train/ocdbt.py give bf16 leaves) -> state_dict of
    contiguous CPU tensors in the leaves' dtype, for OpticalVLM or any of
    its submodules, or for NeuralEmbedderModule."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
                continue
            name, t = _leaf(path[-1] if path else "", key, leaf_tensor(value))
            prefix = [_module_name(p) for p in path]
            out[".".join(prefix + [name])] = t.contiguous()

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
    tree of the JAX package's model, nested dicts of f32 numpy arrays and,
    for bf16 tensors (a bf16 model's expert weights), CPU torch.bfloat16
    tensors: the inverse of `params_from_jax`. `cfg` gives each attention
    module's head_dim, which the (heads * head_dim, embed) weights do not
    show."""
    heads = _head_dims(cfg)
    embedder = not hasattr(cfg, "vision")
    out: Dict = {}
    for name, tensor in state_dict.items():
        if tensor.dtype == torch.bfloat16:
            value = leaf_tensor(tensor)
        else:
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
        node[leaf] = value.contiguous() if isinstance(value, torch.Tensor) else np.ascontiguousarray(value)
    return out
