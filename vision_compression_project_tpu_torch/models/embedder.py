"""The text embedders, the port of
vision_compression_project_tpu/models/embedder.py. Both share one
interface, `embed(texts)` -> (B, dim) f32 numpy rows:

* HashNGramEmbedder (the default): hashed word n-gram counts (host
  featurize, stable blake2 hashes) -> log1p -> a seeded random-sign
  projection -> L2 norm. The projection is the JAX package's own +-1 matrix,
  `jax.random.rademacher(PRNGKey(seed), (buckets, dim), bfloat16)`,
  reproduced here bit for bit with numpy: an index saved by one package lies
  in the same space as the other package's queries.
* NeuralEmbedder: a byte-level transformer encoder (the vision encoder's
  EncoderBlock, non-causal, each text's length as the attention's kv_len)
  with a masked mean pool. Its attention takes the flash-attention kernel
  (kernels/flash_attention.cu) on the card, as the reference takes Pallas:
  the sequence is padded to a multiple of 128.

Both emit unit-norm vectors (or zero ones), so the index's dot product
(ops/topk.py) is cosine similarity.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.topk import full_f32_matmul
from .configs import EmbedderConfig
from .layers import RMSNorm, init_weights_, torch_dtype
from .tokenizer import VOCAB_SIZE, ByteTokenizer
from .vit import EncoderBlock

_WORD_RE = re.compile(r"[a-z0-9]+")

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ROWS_PER_CHUNK = 2048  # rows of the sign matrix generated at a time (bounds host memory)


def _stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), JAX's counter-based
    generator, on uint32 arrays; key is a pair of uint32 words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def rademacher_signs(seed: int, shape) -> np.ndarray:
    """`jax.random.rademacher(jax.random.PRNGKey(seed), shape, dtype)` as an
    int8 array of +-1 (the values are exact in any dtype).

    JAX's partitionable threefry (the default since jax 0.5) draws element i
    of the row-major flattening as threefry2x32(key, (i >> 32, i & 0xffffffff))
    and keeps x0 ^ x1; rademacher is `uniform < 0.5`, so a sign is -1 exactly
    where bit 31 of those bits is set. PRNGKey(seed) is the key (0, seed)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    rows, cols = shape
    key = (0, seed)
    out = np.empty((rows, cols), np.int8)
    with np.errstate(over="ignore"):
        for r0 in range(0, rows, _ROWS_PER_CHUNK):
            r1 = min(rows, r0 + _ROWS_PER_CHUNK)
            flat = np.arange(r0 * cols, r1 * cols, dtype=np.uint64)
            x0, x1 = threefry2x32(
                key, (flat >> np.uint64(32)).astype(np.uint32), flat.astype(np.uint32)
            )
            bits = x0 ^ x1
            out[r0:r1] = np.where(bits >> np.uint32(31), -1, 1).reshape(r1 - r0, cols)
    return out


class HashNGramEmbedder:
    """Deterministic, training-free text embedder on `device` ("cuda" unless
    the caller asks for "cpu"); `embed(texts)` -> (B, dim) f32 numpy rows of
    unit norm (or zero for a text with no words)."""

    def __init__(
        self,
        cfg: Optional[EmbedderConfig] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = cfg or EmbedderConfig()
        self.dim = self.cfg.dim
        self.seed = seed
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HashNGramEmbedder: device 'cuda' asked for, but no CUDA device is available")
        self._proj: Optional[torch.Tensor] = None

    def _featurize(self, text: str) -> np.ndarray:
        counts = np.zeros((self.cfg.ngram_buckets,), np.float32)
        words = _WORD_RE.findall(text.lower())
        for n in self.cfg.ngrams:
            for i in range(len(words) - n + 1):
                gram = " ".join(words[i : i + n])
                counts[_stable_hash(gram) % self.cfg.ngram_buckets] += 1.0
        return counts

    def projection(self) -> torch.Tensor:
        """The (buckets, dim) +-1 matrix as f32 on the device, built once."""
        if self._proj is None:
            signs = rademacher_signs(self.seed, (self.cfg.ngram_buckets, self.dim))
            self._proj = torch.from_numpy(signs).to(self.device, torch.float32)
        return self._proj

    @torch.inference_mode()
    def embed(self, texts: List[str]) -> np.ndarray:
        counts = torch.from_numpy(np.stack([self._featurize(t) for t in texts])).to(self.device)
        # The reference rounds log1p(counts) to bf16 and multiplies bf16 by
        # bf16 with f32 accumulation. bf16 values and +-1 are exact in f32,
        # so an f32 product of the upcast operands is the same arithmetic;
        # on the card it must be true f32, so TF32 is off for the call.
        x = torch.log1p(counts).to(torch.bfloat16).to(torch.float32)
        with full_f32_matmul():
            emb = x @ self.projection()
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return (emb / torch.clamp(norm, min=1e-6)).cpu().numpy()


class NeuralEmbedderModule(nn.Module):
    """Byte ids (B, S) and lengths (B,) -> (B, dim) f32 unit vectors (zero
    for a text of no bytes). Parameters are f32; the embedding, position
    embedding and blocks compute in cfg.dtype, the norm, the pool and the
    output projection in f32, as in the reference."""

    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        self.cfg = cfg
        self.dt = torch_dtype(cfg.dtype)
        self.embed = nn.Embedding(VOCAB_SIZE, cfg.dim)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_seq, cfg.dim))
        self.blocks = nn.ModuleList(EncoderBlock(cfg.dim, cfg.heads, cfg.dtype) for _ in range(cfg.depth))
        self.norm = RMSNorm(cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.dim, bias=False)

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        s = ids.shape[1]
        x = F.embedding(ids, self.embed.weight.to(self.dt))
        x = x + self.pos_embed[:s].to(self.dt)[None]
        for block in self.blocks:
            x = block(x, kv_len=lengths)
        x = self.norm(x)
        mask = (torch.arange(s, device=ids.device)[None, :] < lengths[:, None]).to(torch.float32)[..., None]
        # Rows past a text's length are multiplied by 0 here: they must be
        # finite, which both attention routes keep them.
        pooled = (x.to(torch.float32) * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
        emb = F.linear(pooled, self.out.weight)
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-6)


@torch.no_grad()
def init_params(model: NeuralEmbedderModule, seed: int) -> None:
    """Seeded random weights for `model` from one torch.Generator, with the
    JAX package's initializers (models/layers.py::init_weights_), N(0, 0.02)
    position embeddings."""
    g = torch.Generator().manual_seed(seed)
    init_weights_(model, g)
    model.pos_embed.normal_(0.0, 0.02, generator=g)


class NeuralEmbedder:
    """The byte-level transformer embedder on `device` ("cuda" unless the
    caller asks for "cpu"). Weights are seeded random unless `params` (a
    state_dict, e.g. `weights.params_from_jax` of the JAX embedder's flax
    params) is given: no trained embedder weights are shipped, in the
    reference either."""

    def __init__(
        self,
        cfg: Optional[EmbedderConfig] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = cfg or EmbedderConfig()
        self.dim = self.cfg.dim
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("NeuralEmbedder: device 'cuda' asked for, but no CUDA device is available")
        self.tok = ByteTokenizer()
        model = NeuralEmbedderModule(self.cfg)
        if params is None:
            init_params(model, seed)
        else:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()

    def padded_length(self, texts: List[str]) -> int:
        """The sequence length a batch pads to: the longest text's bytes
        rounded up to a multiple of 128, at least 8, at most max_seq."""
        return min(self.cfg.max_seq, max(8, -(-max(len(t.encode()) for t in texts) // 128) * 128))

    @torch.inference_mode()
    def embed(self, texts: List[str]) -> np.ndarray:
        ids, lens = self.tok.encode_batch(texts, self.padded_length(texts))
        ids = torch.from_numpy(ids).to(self.device, torch.long)
        lens = torch.from_numpy(lens).to(self.device)
        with full_f32_matmul():
            return self.model(ids, lens).cpu().numpy()


def get_embedder(
    backend: str = "hash",
    cfg: Optional[EmbedderConfig] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
):
    if backend == "hash":
        return HashNGramEmbedder(cfg, seed=seed, device=device)
    if backend == "neural":
        return NeuralEmbedder(cfg, seed=seed, device=device)
    raise ValueError(f"unknown embedder backend {backend!r}")
