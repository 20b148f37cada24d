"""The page reader in plain PyTorch, from the configuration and a dict of
weights (the port's state_dict names): preprocess (separable bilinear resize
with the tent filter when shrinking, gray broadcast to RGB, normalise to
[-1, 1], patchify), the two-stage vision encoder (windowed blocks, strided
conv, global blocks), the projector, the causal decoder (RMSNorm, RoPE on
halves, GQA, SwiGLU or top-1 Switch-MoE with capacity), the unembed, the
training loss and the extraction logits. Every product takes its operands
through `Precision`; with `checkpoint` each block's activations are
recomputed in the backward, so a batch of the cells' size fits."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .precision import Precision
from .tokens import PAD_ID

NEG_INF = -1e30


def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix; a triangle
    filter widened by the ratio when shrinking (antialiased bilinear)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float64)
    scale = in_size / out_size
    support = max(scale, 1.0)
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        for j in range(int(np.floor(center - support)), int(np.ceil(center + support)) + 1):
            if 0 <= j < in_size:
                out[i, j] += max(0.0, 1.0 - abs(j - center) / support)
        total = out[i].sum()
        if total > 0:
            out[i] /= total
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * scale


def rope(x: torch.Tensor, theta: float, start: int = 0) -> torch.Tensor:
    """Rotary embedding on (B, H, S, D), the two halves of D rotated as pairs."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    pos = torch.arange(start, start + x.shape[2], dtype=torch.float64, device=x.device)
    ang = torch.outer(pos, freqs)
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], prec: Optional[Precision] = None,
                 checkpoint: bool = False):
        self.cfg, self.p, self.prec, self.ckpt = cfg, params, prec or Precision(), checkpoint

    # -- products --------------------------------------------------------
    def lin(self, x: torch.Tensor, name: str, bias: Optional[str] = None) -> torch.Tensor:
        out = torch.matmul(self.prec.op(x), self.prec.op(self.p[name]).t())
        return out if bias is None else out + self.p[bias]

    def _run(self, fn, *args):
        if self.ckpt and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def attention(self, x, prefix, heads, kv_heads, head_dim, causal, rope_theta=None):
        b, s, _ = x.shape
        q = self.lin(x, f"{prefix}.wq.weight").view(b, s, heads, head_dim).transpose(1, 2)
        k = self.lin(x, f"{prefix}.wk.weight").view(b, s, kv_heads, head_dim).transpose(1, 2)
        v = self.lin(x, f"{prefix}.wv.weight").view(b, s, kv_heads, head_dim).transpose(1, 2)
        if rope_theta is not None:
            q, k = rope(q, rope_theta), rope(k, rope_theta)
        group = heads // kv_heads
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        scores = torch.matmul(self.prec.op(q), self.prec.op(k).transpose(-1, -2)) * head_dim ** -0.5
        if causal:
            keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~keep, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(self.prec.op(probs), self.prec.op(v))
        return self.lin(o.transpose(1, 2).reshape(b, s, heads * head_dim), f"{prefix}.wo.weight")

    def swiglu(self, x, prefix):
        return self.lin(F.silu(self.lin(x, f"{prefix}.gate.weight")) * self.lin(x, f"{prefix}.up.weight"),
                        f"{prefix}.down.weight")

    def switch_moe(self, x, prefix, aux: List[torch.Tensor]):
        """Top-1 routing by the f32 router, capacity int(cf * T / E) slots an
        expert taken in (row, position) order, dropped tokens give 0; the
        expert output scaled by the top probability; the load-balancing term
        E * sum(density * mean probability) goes to `aux`."""
        d = self.cfg["decoder"]
        b, s, dim = x.shape
        t, e = b * s, d["num_experts"]
        xt = x.reshape(t, dim)
        logits = torch.matmul(self.prec.op32(xt), self.prec.op32(self.p[f"{prefix}.router.weight"]).t())
        probs = torch.softmax(logits, dim=-1)
        expert = probs.argmax(dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, e)
        slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
        capacity = max(1, int(d["capacity_factor"] * t / e))
        y = xt.new_zeros((t, dim))
        wg, wu, wd = (self.p[f"{prefix}.{n}"] for n in ("w_gate", "w_up", "w_down"))
        for i in range(e):
            idx = torch.nonzero((expert == i) & (slot < capacity))[:, 0]
            if idx.numel() == 0:
                continue
            xi = self.prec.op(xt[idx])
            h = F.silu(xi @ self.prec.op(wg[i])) * (xi @ self.prec.op(wu[i]))
            y = y.index_add(0, idx, self.prec.op(h) @ self.prec.op(wd[i]))
        density = onehot.to(x.dtype).mean(dim=0)
        aux.append(e * torch.sum(density * probs.mean(dim=0)))
        return (y * gate[:, None]).reshape(b, s, dim)

    # -- the model --------------------------------------------------------
    def preprocess(self, pages_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W) uint8 gray pages -> (B, grid * grid, patch * patch * 3) f32."""
        v = self.cfg["vision"]
        n, p = v["image_size"], v["patch"]
        _, h, w = pages_u8.shape
        r_h = torch.from_numpy(bilinear_matrix(h, n)).to(pages_u8.device, torch.float32)
        r_w = torch.from_numpy(bilinear_matrix(w, n)).to(pages_u8.device, torch.float32)
        img = r_h @ pages_u8.float() @ r_w.t()                              # (B, n, n)
        img = (img - 127.5) / 127.5
        g = n // p
        x = img.reshape(-1, g, p, g, p, 1).expand(-1, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(-1, g * g, p * p * 3)

    def _enc_block(self, prefix, heads, dim):
        def run(x):
            x = x + self.attention(rms_norm(x, self.p[f"{prefix}.norm1.scale"]), f"{prefix}.attn",
                                   heads, heads, dim // heads, False)
            return x + self.swiglu(rms_norm(x, self.p[f"{prefix}.norm2.scale"]), f"{prefix}.mlp")
        return run

    def encode(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, grid * grid, patch_dim) -> (B, vision tokens, decoder dim)."""
        v = self.cfg["vision"]
        b = patches.shape[0]
        grid = v["image_size"] // v["patch"]
        win = min(v["window"], grid)
        nw = grid // win
        dl, dg, ds = v["dim_local"], v["dim_global"], v["downsample"]
        x = self.lin(patches, "vision.patch_embed.weight", "vision.patch_embed.bias") + self.p["vision.pos_embed"]
        for i in range(v["depth_local"]):
            xw = x.reshape(b, nw, win, nw, win, dl).permute(0, 1, 3, 2, 4, 5).reshape(b * nw * nw, win * win, dl)
            xw = self._run(self._enc_block(f"vision.local_blocks.{i}", v["heads_local"], dl), xw)
            x = xw.reshape(b, nw, nw, win, win, dl).permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, dl)
        side = grid // ds
        x2d = x.reshape(b, grid, grid, dl).permute(0, 3, 1, 2)
        x2d = F.conv2d(self.prec.op(x2d), self.prec.op(self.p["vision.downsample.weight"]),
                       self.p["vision.downsample.bias"], stride=ds)
        x = x2d.permute(0, 2, 3, 1).reshape(b, side * side, dg)
        for i in range(v["depth_global"]):
            x = self._run(self._enc_block(f"vision.global_blocks.{i}", v["heads_global"], dg), x)
        x = rms_norm(x, self.p["vision.norm_out.scale"])
        return self.lin(x, "proj.weight")

    def _dec_block(self, i: int, moe: bool):
        d = self.cfg["decoder"]
        prefix = f"decoder.blocks.{i}"

        def run(x):
            x = x + self.attention(rms_norm(x, self.p[f"{prefix}.norm1.scale"]), f"{prefix}.attn", d["heads"],
                                   d["kv_heads"], d["head_dim"], True, rope_theta=d["rope_theta"])
            h = rms_norm(x, self.p[f"{prefix}.norm2.scale"])
            if moe:
                aux: List[torch.Tensor] = []
                out = self.switch_moe(h, f"{prefix}.mlp", aux)
                return x + out, aux[0]
            return x + self.swiglu(h, f"{prefix}.mlp"), x.new_zeros(())
        return run

    def decode(self, x: torch.Tensor, aux: List[torch.Tensor]) -> torch.Tensor:
        """Causal decoder over (B, S, dim) embeddings -> final hidden states."""
        d = self.cfg["decoder"]
        every = max(d["expert_every"], 1)
        for i in range(d["depth"]):
            moe = d["num_experts"] > 0 and i % every == 0
            x, a = self._run(self._dec_block(i, moe), x)
            if moe:
                aux.append(a)
        return x

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, self.p["decoder.norm_f.scale"])
        return torch.matmul(self.prec.op32(h), self.prec.op32(self.p["decoder.unembed.weight"]).t())

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.p["decoder.embed.weight"])

    def loss(self, pages_u8: torch.Tensor, ids: torch.Tensor, moe_weight: float = 0.01) -> torch.Tensor:
        """Next-token cross-entropy over the text targets that are not PAD,
        behind the page's vision tokens, plus moe_weight x the MoE terms."""
        vis = self.encode(self.preprocess(pages_u8))
        x = torch.cat([vis, self.embed(ids[:, :-1])], dim=1)
        aux: List[torch.Tensor] = []
        h = self.decode(x, aux)
        logits = self.logits(h[:, vis.shape[1]:])
        targets = ids[:, 1:]
        mask = (targets != PAD_ID).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
        loss = (ce * mask.reshape(-1)).sum() / mask.sum().clamp(min=1.0)
        if aux:
            loss = loss + moe_weight * sum(aux)
        return loss

    @torch.no_grad()
    def served_logits(self, page_u8: torch.Tensor, prompt: List[int], tokens: List[int]) -> torch.Tensor:
        """(len(tokens), vocab) f32: the logits that predict each served
        token, from one page, the prompt and the tokens before it (teacher
        forcing)."""
        vis = self.encode(self.preprocess(page_u8[None]))
        ids = torch.tensor(prompt + tokens[:-1], dtype=torch.long, device=page_u8.device)
        x = torch.cat([vis, self.embed(ids[None])], dim=1)
        h = self.decode(x, [])
        first = vis.shape[1] + len(prompt) - 1
        return self.logits(h[0, first:first + len(tokens)])
