"""Model FLOPs of an LFM2 configuration's training step (portbench/configs/
lfm2_24b_a2b.json), counted as flops.py counts the repo's: every product
2*m*n*k, attention 4*D operations per (query, key) pair that the causal
mask leaves, no norm, sigmoid, softmax or elementwise work beside the
depthwise taps, no recompute; a step 3x its forward.

A decoder token's forward: in a conv layer in_proj (d -> 3d), the taps
(2 * kernel * d) and out_proj (d -> d); in an attention layer the q, k, v
and out projections, and attention only there; in a dense layer SwiGLU's
three products at the dense width; in a MoE layer the router (d -> E) and
k experts' three products at the expert width. Logits at the text positions
over the configuration's vocabulary. Imports nothing of the port."""

from __future__ import annotations

from .flops import causal_pairs, encode_flops, vision_tokens


def _kinds(cfg: dict):
    d = cfg["decoder"]
    every = max(d.get("expert_every", 1), 1)
    for i, kind in enumerate(d["layer_types"]):
        yield kind, d["num_experts"] > 0 and i >= d["num_dense_layers"] and i % every == 0


def layer_token_flops(cfg: dict, kind: str, moe: bool) -> float:
    """One decoder layer's products for one token, attention's pairs aside."""
    d = cfg["decoder"]
    dim = d["dim"]
    if kind == "conv":
        op = 2.0 * dim * 3 * dim + 2.0 * d["conv_kernel"] * dim + 2.0 * dim * dim
    else:
        op = 2.0 * dim * d["head_dim"] * (2 * d["heads"] + 2 * d["kv_heads"])
    if moe:
        ffn = 2.0 * dim * d["num_experts"] + d["experts_per_token"] * 2.0 * 3 * dim * d["moe_dim"]
    else:
        ffn = 2.0 * 3 * dim * int(dim * d["mlp_ratio"])
    return op + ffn


def decoder_token_flops(cfg: dict) -> float:
    return sum(layer_token_flops(cfg, kind, moe) for kind, moe in _kinds(cfg))


def attention_layers(cfg: dict) -> int:
    return sum(kind == "full_attention" for kind, _ in _kinds(cfg))


def moe_layers(cfg: dict) -> int:
    return sum(moe for _, moe in _kinds(cfg))


def train_step_flops(cfg: dict, batch: int, text_len: int) -> float:
    """One training step on `batch` pages with `text_len` target ids a row:
    the decoder over the vision tokens and text_len - 1 ids, logits at the
    text positions; 3x the forward."""
    d = cfg["decoder"]
    s = vision_tokens(cfg) + text_len - 1
    per_row = encode_flops(cfg) + s * decoder_token_flops(cfg)
    per_row += 4.0 * d["head_dim"] * d["heads"] * attention_layers(cfg) * causal_pairs(s)
    per_row += 2.0 * d["dim"] * d["vocab"] * (text_len - 1)
    return 3.0 * batch * per_row


def routed_pairs(cfg: dict, batch: int, text_len: int) -> int:
    """(token, expert) pairs of one MoE layer in one training step."""
    return batch * (vision_tokens(cfg) + text_len - 1) * cfg["decoder"]["experts_per_token"]


def expert_flops(cfg: dict, batch: int, text_len: int) -> float:
    """The expert products' FLOPs of one training step, forward and
    backward (3x the forward), over every MoE layer."""
    d = cfg["decoder"]
    return 3.0 * moe_layers(cfg) * routed_pairs(cfg, batch, text_len) * 3 * 2.0 * d["dim"] * d["moe_dim"]
