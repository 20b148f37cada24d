"""Model configuration presets, the same as the JAX package's
(vision_compression_project_tpu/models/configs.py); tests hold every field
equal.

`tiny` runs the full stack on the CPU in seconds; `ocr_real` is the shipped
real-document reader (1024px pages, 1024 vision tokens, BPE vocab 4096).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .tokenizer import VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """DeepEncoder-style two-stage vision encoder (window -> downsample ->
    global), after the optical-compression idea the reference app is built
    around: a page becomes few vision tokens, not thousands of text tokens."""

    image_size: int = 1024
    patch: int = 16
    dim_local: int = 384          # stage-1 (windowed) width
    dim_global: int = 768         # stage-2 (global) width
    depth_local: int = 4
    depth_global: int = 4
    heads_local: int = 6
    heads_global: int = 12
    window: int = 16              # window side, in patches, for stage 1
    downsample: int = 4           # token-grid reduction between stages (per side)
    dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def tokens_out(self) -> int:
        side = self.grid // self.downsample
        return side * side


LAYER_KINDS = ("full_attention", "conv")
ROUTERS = ("switch", "sigmoid")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Causal LM decoder: RMSNorm + RoPE + GQA + SwiGLU, optional MoE.

    The fields after `dtype` are the port's own (the JAX package's config
    has none of them); their defaults give the block above, so every preset
    is the JAX package's. They describe hybrid decoders such as LFM2's
    (`lfm2_moe`): per-block kinds, gated short-conv blocks beside attention,
    QK-norm, leading dense blocks, experts of their own width and a top-k
    sigmoid router with a selection bias and no capacity."""

    vocab: int = VOCAB_SIZE
    tokenizer: str = "byte"       # "byte" | "bpe" (models/bpe_merges.json)
    dim: int = 768
    depth: int = 8
    heads: int = 12
    kv_heads: int = 4
    head_dim: int = 64
    mlp_ratio: float = 4.0
    max_seq: int = 4096
    rope_theta: float = 10000.0
    num_experts: int = 0          # 0 = dense MLP everywhere
    expert_every: int = 2         # MoE every Nth block (when num_experts > 0)
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"
    layer_types: Tuple[str, ...] = ()  # a kind of LAYER_KINDS per block; () = attention everywhere
    num_dense_layers: int = 0     # leading blocks that keep the dense MLP
    moe_dim: int = 0              # an expert's hidden width; 0 = mlp_dim
    router: str = "switch"        # "switch": softmax top-1 with capacity; "sigmoid": top-k, bias, dropless
    experts_per_token: int = 1    # k of the "sigmoid" router
    qk_norm: bool = False         # RMSNorm over head_dim on q and k before RoPE
    conv_kernel: int = 3          # taps of a "conv" block's causal depthwise filter
    norm_eps: float = 1e-6        # the decoder's RMSNorms

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.layer_types and len(self.layer_types) != self.depth:
            raise ValueError(f"layer_types has {len(self.layer_types)} kinds for depth {self.depth}")
        unknown = set(self.layer_types) - set(LAYER_KINDS)
        if unknown:
            raise ValueError(f"unknown layer kinds {sorted(unknown)}; have {LAYER_KINDS}")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; have {ROUTERS}")
        if self.router == "switch" and self.experts_per_token != 1:
            raise ValueError("the switch router routes each token to one expert")

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def expert_dim(self) -> int:
        return self.moe_dim or self.mlp_dim

    def block_kind(self, i: int) -> str:
        return self.layer_types[i] if self.layer_types else "full_attention"

    def block_moe(self, i: int) -> bool:
        """Whether block i takes experts for its MLP: every `expert_every`-th
        block (block 0 first) from `num_dense_layers` on."""
        return self.num_experts > 0 and i >= self.num_dense_layers and i % max(self.expert_every, 1) == 0


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: VisionConfig = VisionConfig()
    decoder: DecoderConfig = DecoderConfig()

    @property
    def dtype(self):
        return self.decoder.dtype


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    dim: int = 512
    # hash backend
    ngram_buckets: int = 32768
    ngrams: Tuple[int, ...] = (1, 2, 3)   # word n-gram orders
    # neural backend
    depth: int = 4
    heads: int = 8
    max_seq: int = 1024
    dtype: str = "bfloat16"


_TINY = VLMConfig(
    vision=VisionConfig(
        image_size=64, patch=16, dim_local=64, dim_global=128,
        depth_local=1, depth_global=1, heads_local=2, heads_global=2,
        window=2, downsample=2,
    ),
    decoder=DecoderConfig(
        dim=128, depth=2, heads=4, kv_heads=2, head_dim=32, max_seq=512,
    ),
)

_TINY_MOE = VLMConfig(
    vision=_TINY.vision,
    decoder=dataclasses.replace(
        _TINY.decoder, num_experts=4, expert_every=1
    ),
)

_BASE = VLMConfig(
    vision=VisionConfig(),
    # Learned BPE (~4k): a page's markdown is hundreds of decode steps, not
    # thousands — the byte vocab was an architecture-level throughput
    # ceiling (VERDICT r1).
    decoder=DecoderConfig(vocab=4096, tokenizer="bpe"),
)

_PROD = VLMConfig(
    vision=VisionConfig(
        dim_local=768, dim_global=1536, depth_local=12, depth_global=12,
        heads_local=12, heads_global=16,
    ),
    decoder=DecoderConfig(
        vocab=4096, tokenizer="bpe",
        dim=2048, depth=24, heads=16, kv_heads=4, head_dim=128,
        max_seq=8192, num_experts=16, expert_every=2,
    ),
)

# Small-but-legible config for the synthetic-OCR learning demo: 512px input
# resolves large-font rendered text; the decoder is big enough to copy bytes.
_OCR_DEMO = VLMConfig(
    vision=VisionConfig(
        image_size=512, patch=16, dim_local=128, dim_global=256,
        depth_local=2, depth_global=2, heads_local=4, heads_global=4,
        window=8, downsample=2,
    ),
    decoder=DecoderConfig(
        dim=256, depth=4, heads=8, kv_heads=4, head_dim=32, max_seq=1024,
    ),
)

# ocr_demo with the learned BPE vocab: the same model budget reads whole
# words per step instead of bytes.
_OCR_BPE = VLMConfig(
    vision=_OCR_DEMO.vision,
    decoder=dataclasses.replace(_OCR_DEMO.decoder, vocab=4096, tokenizer="bpe"),
)

# Real-document OCR (round 3): 1024px input so a 12pt glyph lands at
# ~15.5px after the on-device resize (legible; 512px leaves it at 7.8px),
# windowed stage over 4096 patches, 2x token downsample -> 1024 vision
# tokens per page, and a decoder sized to transcribe ~30 wrapped lines of
# open-vocabulary prose (text budget 1024 BPE tokens -> max_seq 2048).
_OCR_REAL = VLMConfig(
    vision=VisionConfig(
        image_size=1024, patch=16, dim_local=192, dim_global=384,
        depth_local=4, depth_global=4, heads_local=6, heads_global=6,
        window=16, downsample=2,
    ),
    decoder=DecoderConfig(
        vocab=4096, tokenizer="bpe:bpe_merges_real.json",
        dim=384, depth=6, heads=6, kv_heads=2, head_dim=64, max_seq=2048,
    ),
)

PRESETS = {
    "tiny": _TINY,
    "tiny_moe": _TINY_MOE,
    "ocr_demo": _OCR_DEMO,
    "ocr_bpe": _OCR_BPE,
    "ocr_real": _OCR_REAL,
    "base": _BASE,
    "prod": _PROD,
}


def get_preset(name: str) -> VLMConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
