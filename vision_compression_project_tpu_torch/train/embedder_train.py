"""Contrastive training of the neural embedder: the port of
vision_compression_project_tpu/train/embedder_train.py.

In-batch InfoNCE over (query, page) pairs: a query is one of the page's
distinctive terms and a couple of its content words, its positive is the
page itself, and every other page of the batch is a negative. The loss is
symmetric (query -> page and page -> query) at temperature 0.05. The
optimizer is optax.adamw(lr) with optax's defaults (b2 0.999, weight decay
1e-4, no clip), written out in train_step.AdamW.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..models.configs import EmbedderConfig
from ..models.embedder import NeuralEmbedderModule, init_params
from ..models.tokenizer import ByteTokenizer
from .data import synthetic_page_text
from .train_step import AdamW, OptState, resolve_device


def info_nce_loss(model: NeuralEmbedderModule, batch: Dict[str, torch.Tensor],
                  temperature: float = 0.05) -> torch.Tensor:
    q = model(batch["q_ids"], batch["q_len"])
    d = model(batch["d_ids"], batch["d_len"])
    logits = (q @ d.T) / temperature  # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qd = F.cross_entropy(logits, labels, reduction="none")
    loss_dq = F.cross_entropy(logits.T, labels, reduction="none")
    return (loss_qd + loss_dq).mean() / 2.0


def _distinctive_terms(rng: np.random.Generator, n: int = 3):
    """Rare identifier-like terms that separate pages (the shared synthetic
    vocabulary does not), drawn from a wide character pool."""
    pool = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789#@$%&+=_")
    return ["".join(rng.choice(pool, size=6)) for _ in range(n)]


def make_query(text: str, terms, rng: np.random.Generator) -> str:
    """A lexical query for a page: one of its distinctive terms plus a couple
    of its content words."""
    words = text.split()
    picks = [str(rng.choice(terms))]
    if len(words) > 6:
        start = int(rng.integers(0, len(words) - 3))
        picks += words[start : start + 2]
    return " ".join(picks)


def synthetic_pair_batches(batch_size: int, max_len: int = 256, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {q_ids (B, 64), q_len, d_ids (B, max_len), d_len} int32 byte
    ids and lengths forever."""
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    while True:
        docs, queries = [], []
        for _ in range(batch_size):
            terms = _distinctive_terms(rng)
            body = synthetic_page_text(rng, lines=6)
            docs.append(body + "\nKey terms: " + " ".join(terms) + ".")
            queries.append(make_query(body, terms, rng))
        d_ids, d_len = tok.encode_batch(docs, max_len)
        q_ids, q_len = tok.encode_batch(queries, 64)
        yield {"q_ids": q_ids, "q_len": q_len, "d_ids": d_ids, "d_len": d_len}


def pair_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host pair batch on `device`: int64 ids, int32 lengths."""
    return {k: torch.from_numpy(v).to(device, torch.long if k.endswith("ids") else torch.int32)
            for k, v in batch.items()}


def make_embedder_train_state(cfg: EmbedderConfig, lr: float = 1e-3, seed: int = 0, device=None):
    """(model, optimizer, params, opt_state): NeuralEmbedderModule(cfg) with
    seeded f32 weights (models/embedder.py::init_params) on `device`
    (RUNTIME.device unless given), and optax.adamw(lr)'s defaults."""
    model = NeuralEmbedderModule(cfg)
    init_params(model, seed)
    model.to(resolve_device(device)).train()
    opt = AdamW(lr)
    params = dict(model.named_parameters())
    return model, opt, params, opt.init(params)


def embedder_train_step(model: NeuralEmbedderModule, opt: AdamW, params, opt_state: OptState,
                        batch: Dict[str, torch.Tensor]):
    """One step on a pair batch (pair_batch's dict): (params, opt_state,
    loss), the parameters updated in place."""
    for p in params.values():
        p.grad = None
    loss = info_nce_loss(model, batch)
    loss.backward()
    return params, opt.update(params, opt_state), loss.detach()
