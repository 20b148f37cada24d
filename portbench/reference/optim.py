"""optax's chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
weight_decay)) in float32, written from optax's formulas: the clip scales
by max_norm / norm only when norm >= max_norm; bias corrections 1 - b**t;
the decay applies to every parameter. A leaf that the configuration stores
in bfloat16 keeps its moments in float32 here and is rounded to bfloat16
after each update, as it is stored."""

from __future__ import annotations

from typing import Dict

import torch


class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, max_norm: float = 1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.count = 0

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if norm >= max_norm:
            return {k: g * (max_norm / norm) for k, g in grads.items()}
        return dict(grads)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               stored: Dict[str, torch.dtype]) -> Dict[str, torch.Tensor]:
        """Update `params` in place from `grads` (already clipped by the
        caller with `clip`); `stored` gives each leaf's storage dtype."""
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            mu = self.mu.setdefault(k, torch.zeros_like(p))
            nu = self.nu.setdefault(k, torch.zeros_like(p))
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            step = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + self.weight_decay * p
            p.add_(step, alpha=-self.lr)
            if stored[k] != torch.float32:
                p.copy_(p.to(stored[k]).float())
        return params
