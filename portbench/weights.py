"""Seeded weights for a configuration, made on the device in a few large
calls and in the types they are served in: every parameter f32, except the
Switch-MoE experts, which the configuration stores in its dtype. Names and
shapes are the port's state_dict names (the reference uses the same), worked
out here from the configuration alone; this module imports nothing of the
port.

Draws: one normal_ over one flat buffer per dtype, then each leaf scaled
(lecun: std = 1/sqrt(fan_in) for products, 0.02 for embeddings); norm
scales 1, biases 0. The same seed gives the same weights on one device."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    kind: str          # "random", "scale" (ones) or "bias" (zeros)
    std: float
    dtype: str


def _linear(name: str, out_f: int, in_f: int) -> Leaf:
    return Leaf(name, (out_f, in_f), "random", in_f ** -0.5, "float32")


def _block(prefix: str, dim: int, heads: int, kv_heads: int, head_dim: int, hidden: int,
           moe: bool = False, experts: int = 0, expert_dtype: str = "float32") -> List[Leaf]:
    leaves = [
        Leaf(f"{prefix}.norm1.scale", (dim,), "scale", 0.0, "float32"),
        _linear(f"{prefix}.attn.wq.weight", heads * head_dim, dim),
        _linear(f"{prefix}.attn.wk.weight", kv_heads * head_dim, dim),
        _linear(f"{prefix}.attn.wv.weight", kv_heads * head_dim, dim),
        _linear(f"{prefix}.attn.wo.weight", dim, heads * head_dim),
        Leaf(f"{prefix}.norm2.scale", (dim,), "scale", 0.0, "float32"),
    ]
    if moe:
        leaves += [
            _linear(f"{prefix}.mlp.router.weight", experts, dim),
            Leaf(f"{prefix}.mlp.w_gate", (experts, dim, hidden), "random", dim ** -0.5, expert_dtype),
            Leaf(f"{prefix}.mlp.w_up", (experts, dim, hidden), "random", dim ** -0.5, expert_dtype),
            Leaf(f"{prefix}.mlp.w_down", (experts, hidden, dim), "random", hidden ** -0.5, expert_dtype),
        ]
    else:
        leaves += [
            _linear(f"{prefix}.mlp.gate.weight", hidden, dim),
            _linear(f"{prefix}.mlp.up.weight", hidden, dim),
            _linear(f"{prefix}.mlp.down.weight", dim, hidden),
        ]
    return leaves


def moe_blocks(cfg: dict) -> List[bool]:
    """Which decoder blocks hold a Switch-MoE: every expert_every-th, block 0 first."""
    d = cfg["decoder"]
    every = max(d["expert_every"], 1)
    return [d["num_experts"] > 0 and i % every == 0 for i in range(d["depth"])]


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter of the configuration, in the port's state_dict names."""
    v, d = cfg["vision"], cfg["decoder"]
    grid = v["image_size"] // v["patch"]
    dl, dg, ds = v["dim_local"], v["dim_global"], v["downsample"]
    patch_dim = v["patch"] * v["patch"] * 3
    out = [
        _linear("vision.patch_embed.weight", dl, patch_dim),
        Leaf("vision.patch_embed.bias", (dl,), "bias", 0.0, "float32"),
        Leaf("vision.pos_embed", (grid * grid, dl), "random", 0.02, "float32"),
    ]
    for i in range(v["depth_local"]):
        out += _block(f"vision.local_blocks.{i}", dl, v["heads_local"], v["heads_local"], dl // v["heads_local"],
                      4 * dl)
    out += [
        Leaf("vision.downsample.weight", (dg, dl, ds, ds), "random", (dl * ds * ds) ** -0.5, "float32"),
        Leaf("vision.downsample.bias", (dg,), "bias", 0.0, "float32"),
    ]
    for i in range(v["depth_global"]):
        out += _block(f"vision.global_blocks.{i}", dg, v["heads_global"], v["heads_global"], dg // v["heads_global"],
                      4 * dg)
    out += [
        Leaf("vision.norm_out.scale", (dg,), "scale", 0.0, "float32"),
        _linear("proj.weight", d["dim"], dg),
        Leaf("decoder.embed.weight", (d["vocab"], d["dim"]), "random", 0.02, "float32"),
    ]
    hidden = int(d["dim"] * d["mlp_ratio"])
    for i, moe in enumerate(moe_blocks(cfg)):
        out += _block(f"decoder.blocks.{i}", d["dim"], d["heads"], d["kv_heads"], d["head_dim"], hidden,
                      moe=moe, experts=d["num_experts"], expert_dtype=d["dtype"])
    out += [
        Leaf("decoder.norm_f.scale", (d["dim"],), "scale", 0.0, "float32"),
        _linear("decoder.unembed.weight", d["vocab"], d["dim"]),
    ]
    return out


def count(cfg: dict) -> int:
    n = 0
    for leaf in leaves(cfg):
        size = 1
        for x in leaf.shape:
            size *= x
        n += size
    return n


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights on `device`: name -> tensor (views of one flat
    buffer per dtype)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = leaves(cfg)
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(s.dtype for s in specs):
        group = [s for s in specs if s.dtype == dtype]
        sizes = [int(torch.Size(s.shape).numel()) for s in group]
        flat = torch.empty(sum(sizes), dtype=_DTYPES[dtype], device=device)
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
