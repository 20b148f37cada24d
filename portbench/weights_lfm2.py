"""Seeded weights of an LFM2 configuration (`lfm2_moe`, portbench/configs/
lfm2_24b_a2b.json), in the port's state_dict names and served types, made
as `weights.make` makes the repo's: one normal_ over one flat buffer per
dtype, each leaf scaled (lecun, std = 1/sqrt(fan_in); embeddings 0.02), norm
scales 1. The vision encoder, projector, embedding and unembed are
`weights.leaves`'; the decoder layers are LFM2's: a short conv (in_proj,
`taps` of fan-in `conv_kernel`, out_proj) or attention with QK-norm, then
SwiGLU or the top-k mixture (router f32, experts in the configuration's
dtype, `expert_bias` f32 of std EXPERT_BIAS_STD, held fixed). Imports
nothing of the port."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import weights
from .weights import Leaf, _linear

# The seeded selection bias: at this std the top-4 choices of about a
# quarter of the tokens move and the busiest expert takes about 1.25x the
# mean (64 experts, sigmoid scores of unit-variance logits), the balance a
# trained router's bias keeps.
EXPERT_BIAS_STD = 0.01


def block_leaves(cfg: dict, i: int, kind: str, moe: bool) -> List[Leaf]:
    d = cfg["decoder"]
    dim, hd = d["dim"], d["head_dim"]
    p = f"decoder.blocks.{i}"
    out = [Leaf(f"{p}.norm1.scale", (dim,), "scale", 0.0, "float32")]
    if kind == "conv":
        out += [_linear(f"{p}.conv.in_proj.weight", 3 * dim, dim),
                Leaf(f"{p}.conv.taps", (dim, d["conv_kernel"]), "random", d["conv_kernel"] ** -0.5, "float32"),
                _linear(f"{p}.conv.out_proj.weight", dim, dim)]
    else:
        out += [_linear(f"{p}.attn.wq.weight", d["heads"] * hd, dim),
                _linear(f"{p}.attn.wk.weight", d["kv_heads"] * hd, dim),
                _linear(f"{p}.attn.wv.weight", d["kv_heads"] * hd, dim),
                _linear(f"{p}.attn.wo.weight", dim, d["heads"] * hd),
                Leaf(f"{p}.attn.q_norm.scale", (hd,), "scale", 0.0, "float32"),
                Leaf(f"{p}.attn.k_norm.scale", (hd,), "scale", 0.0, "float32")]
    out.append(Leaf(f"{p}.norm2.scale", (dim,), "scale", 0.0, "float32"))
    if moe:
        e, h = d["num_experts"], d["moe_dim"]
        out += [_linear(f"{p}.mlp.router.weight", e, dim),
                Leaf(f"{p}.mlp.expert_bias", (e,), "random", EXPERT_BIAS_STD, "float32"),
                Leaf(f"{p}.mlp.w_gate", (e, dim, h), "random", dim ** -0.5, d["dtype"]),
                Leaf(f"{p}.mlp.w_up", (e, dim, h), "random", dim ** -0.5, d["dtype"]),
                Leaf(f"{p}.mlp.w_down", (e, h, dim), "random", h ** -0.5, d["dtype"])]
    else:
        hidden = int(dim * d["mlp_ratio"])
        out += [_linear(f"{p}.mlp.gate.weight", hidden, dim),
                _linear(f"{p}.mlp.up.weight", hidden, dim),
                _linear(f"{p}.mlp.down.weight", dim, hidden)]
    return out


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter and persistent buffer of the configuration."""
    from .reference.lfm2 import block_kinds, moe_blocks

    d = cfg["decoder"]
    outer = weights.leaves({**cfg, "decoder": {**d, "depth": 0, "num_experts": 0}})
    cut = next(i for i, leaf in enumerate(outer) if leaf.name == "decoder.norm_f.scale")
    blocks = [leaf for i, (kind, moe) in enumerate(zip(block_kinds(cfg), moe_blocks(cfg)))
              for leaf in block_leaves(cfg, i, kind, moe)]
    return outer[:cut] + blocks + outer[cut:]


def buffers(cfg: dict) -> List[str]:
    """The names of the persistent buffers among `leaves`: no optimizer leaf."""
    return [leaf.name for leaf in leaves(cfg) if leaf.name.endswith(".expert_bias")]


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights on `device`: name -> tensor (views of one flat
    buffer per dtype), drawn as `weights.make` draws them."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = leaves(cfg)
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(s.dtype for s in specs):
        group = [s for s in specs if s.dtype == dtype]
        sizes = [int(torch.Size(s.shape).numel()) for s in group]
        flat = torch.empty(sum(sizes), dtype=weights._DTYPES[dtype], device=device)
        flat.normal_(0.0, 1.0, generator=gen)
        views = [part.view(s.shape) for part, s in zip(flat.split(sizes), group)]
        rand = [(v, s.std) for v, s in zip(views, group) if s.kind == "random"]
        torch._foreach_mul_([v for v, _ in rand], [std for _, std in rand])
        for v, s in zip(views, group):
            if s.kind == "scale":
                v.fill_(1.0)
            elif s.kind == "bias":
                v.zero_()
            out[s.name] = v
    return {s.name: out[s.name] for s in specs}
