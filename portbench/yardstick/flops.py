"""Model FLOPs that a cell's inputs need, counted from the configuration and
the shapes: every matrix product 2*m*n*k, attention 4*D operations per
(query, key) pair that the masks leave, no norm, softmax or elementwise
work. Work that the program does and the inputs do not need is not counted:
the recompute of rematerialised blocks, logits at the vision positions in
training, padded prompt positions and rows that already emitted EOS in
decoding. A training step is taken as 3x its forward."""

from __future__ import annotations

from typing import Iterable

from .attention import decoder_call, encoder_calls

# VLMRunner's prompt bucket (models/vlm.py PROMPT_BUCKET) and the extraction
# prompt [BOS, TASK_EXTRACT].
PROMPT_BUCKET = 64
EXTRACT_PROMPT = 2


def vision_tokens(cfg: dict) -> int:
    v = cfg["vision"]
    side = v["image_size"] // v["patch"] // v["downsample"]
    return side * side


def prompt_bucket(n: int) -> int:
    """The padded prompt length VLMRunner.pad_prompts gives n ids."""
    return max(8, -(-n // PROMPT_BUCKET) * PROMPT_BUCKET)


def encode_flops(cfg: dict) -> float:
    """One page through the vision encoder and the projector."""
    v, dd = cfg["vision"], cfg["decoder"]["dim"]
    grid = v["image_size"] // v["patch"]
    g2 = grid * grid
    win = min(v["window"], grid)
    dl, dg, ds = v["dim_local"], v["dim_global"], v["downsample"]
    t = vision_tokens(cfg)
    fl = 2.0 * g2 * (v["patch"] ** 2 * 3) * dl                      # patch embedding
    fl += v["depth_local"] * (32.0 * g2 * dl * dl + 4.0 * dl * g2 * win * win)
    fl += 2.0 * t * (dl * ds * ds) * dg                              # strided-conv downsample
    fl += v["depth_global"] * (32.0 * t * dg * dg + 4.0 * dg * t * t)
    fl += 2.0 * t * dg * dd                                          # projector
    return fl


def _block_matmul_flops(cfg: dict, moe: bool) -> float:
    """One decoder block's products for one token (top-1 MoE: one expert)."""
    d = cfg["decoder"]
    dim, h, hkv, hd = d["dim"], d["heads"], d["kv_heads"], d["head_dim"]
    mlp = int(dim * d["mlp_ratio"])
    attn = 2.0 * dim * hd * (2 * h + 2 * hkv)
    ffn = 2.0 * 3 * dim * mlp + (2.0 * dim * d["num_experts"] if moe else 0.0)
    return attn + ffn


def _moe_blocks(cfg: dict) -> list:
    d = cfg["decoder"]
    every = max(d["expert_every"], 1)
    return [d["num_experts"] > 0 and i % every == 0 for i in range(d["depth"])]


def decoder_token_flops(cfg: dict) -> float:
    """Every decoder block's products for one token."""
    return sum(_block_matmul_flops(cfg, moe) for moe in _moe_blocks(cfg))


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_flops(cfg: dict, pairs: float) -> float:
    """Attention of every decoder block over `pairs` (query, key) pairs."""
    d = cfg["decoder"]
    return 4.0 * d["head_dim"] * d["heads"] * d["depth"] * pairs


def unembed_flops(cfg: dict, positions: float) -> float:
    d = cfg["decoder"]
    return 2.0 * d["dim"] * d["vocab"] * positions


def train_step_flops(cfg: dict, batch: int, text_len: int) -> float:
    """One training step on `batch` pages with `text_len` target ids a row:
    the decoder runs over the vision tokens and text_len - 1 ids, the loss
    needs the text positions' logits; 3x the forward."""
    s = vision_tokens(cfg) + text_len - 1
    per_row = encode_flops(cfg) + s * decoder_token_flops(cfg) + attention_flops(cfg, causal_pairs(s))
    per_row += unembed_flops(cfg, text_len - 1)
    return 3.0 * batch * per_row


def extract_batch_flops(cfg: dict, tokens_per_row: Iterable[int]) -> float:
    """One extraction batch: each row's page encoded, the prompt prefilled
    (its real positions), the first token's logits, then one decode step per
    further token the row emitted up to and with its EOS, attending to every
    earlier position."""
    t = vision_tokens(cfg)
    p = t + EXTRACT_PROMPT
    total = 0.0
    for n in tokens_per_row:
        total += encode_flops(cfg) + p * decoder_token_flops(cfg) + attention_flops(cfg, causal_pairs(p))
        total += unembed_flops(cfg, 1)
        steps = max(n - 1, 0)
        # Step k (1-based) feeds the token at position p + k - 1 and attends to p + k keys.
        keys = steps * p + steps * (steps + 1) // 2
        total += steps * (decoder_token_flops(cfg) + unembed_flops(cfg, 1)) + attention_flops(cfg, keys)
    return total


def train_attention_calls(cfg: dict, batch: int, text_len: int) -> list:
    """The attention calls of one training step's forward, each once: the
    work the inputs need (the recompute's second forward is not counted)."""
    s = vision_tokens(cfg) + text_len - 1
    return encoder_calls(cfg, batch) + [decoder_call(cfg, batch, s, s, "decoder")]


def extract_attention_calls(cfg: dict, batch: int) -> list:
    """The whole-sequence attention calls of one extraction batch: the
    encoder's, then the decoder's prefill over the vision tokens and the
    padded prompt, EXTRACT_PROMPT + vision tokens of it real."""
    t = vision_tokens(cfg)
    return encoder_calls(cfg, batch) + [
        decoder_call(cfg, batch, t + prompt_bucket(EXTRACT_PROMPT), t + EXTRACT_PROMPT, "prefill")]

