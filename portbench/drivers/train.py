"""Training cells: the port's `train_step` on `device_batch` of the
benchmark's host batches, one step a unit.

Set-up builds the one training object (`make_train_state`, then the
benchmark's seeded weights through `load_whole_params`) and drives it through
the first `checked_steps` steps on batches whose rows all differ, through the
window's own call and feed. From them it keeps each step's loss, each leaf's
first gradient as the optimizer got it (its first moment after one step over
1 - b1) and each leaf's change after the checked steps. The window goes on
with the same object. The check runs the plain reference over the same
batches from the same weights and compares:

- loss_gap: the largest relative gap of a checked step's loss;
- grad_gap: the worst leaf's gap of first-gradient norms, against the larger
  of the reference's norm of that leaf and of the median leaf;
- update_gap: the same of the parameters' change over the checked steps, over
  the leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf below that moves by round-off alone);
- grad_gap_median, update_gap_median: the median leaf's gap of each.
A cell's limits file names the numbers it compares; the rest are printed."""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import traffic as traffic_mod
from .. import weights
from ..reference.model import Reference
from ..reference.optim import AdamW as RefAdamW
from ..reference.precision import Precision, exact_float32
from ..tracing import span
from ..yardstick.flops import train_step_flops
from .common import leaf_gaps, worst_and_median

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam: left out of update_gap.
STILL_LEAF = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = {k: torch.linalg.vector_norm(t, dtype=torch.float32) for k, t in tensors.items()}
    host = torch.stack(list(vals.values())).cpu().tolist()
    return dict(zip(vals, host))


def _change_norms(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of now - start, in f32, one leaf at a time."""
    vals = {k: torch.linalg.vector_norm(now[k].detach().float() - start[k].float()) for k in start}
    host = torch.stack(list(vals.values())).cpu().tolist()
    return dict(zip(vals, host))


class Run:
    def __init__(self, cfg: dict, vlm_cfg, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.vlm_cfg, self.traffic, self.seed, self.device = cfg, vlm_cfg, traffic, seed, device
        self.losses: List[float] = []
        self.grad_norms: Dict[str, float] = {}
        self.update_norms: Dict[str, float] = {}
        self.steps = 0

    # -- the program ----------------------------------------------------------
    def setup(self) -> None:
        from vision_compression_project_tpu_torch.train import data, train_step as ts

        self.ts, self.data = ts, data
        self.batches = traffic_mod.host_batches(self.traffic, self.cfg, self.seed)
        self.model, self.opt, self.state = ts.make_train_state(self.vlm_cfg, device=self.device, seed=self.seed,
                                                               lr=self.traffic["lr"])
        w = weights.make(self.cfg, self.seed, self.device)
        ts.load_whole_params(self.model, w)
        del w
        self.next = 0
        for i in range(self.traffic["checked_steps"]):
            loss = self._step()
            self.losses.append(float(loss))
            if i == 0:
                mu = self.state.opt_state.mu
                scale = {k: float(torch.tensor(1 - self.opt.b1, dtype=m.dtype)) for k, m in mu.items()}
                self.grad_norms = {k: v / scale[k] for k, v in _norms(mu).items()}
        start = weights.make(self.cfg, self.seed, self.device)
        self.update_norms = _change_norms(self.state.params, start)
        del start

    def _step(self):
        batch = self.data.device_batch(self.vlm_cfg, self.batches[self.next % len(self.batches)],
                                       device=self.device)
        self.state, loss = self.ts.train_step(self.model, self.opt, self.state, batch)
        self.next += 1
        return loss

    def unit(self, traced: bool = False) -> None:
        """One training step; a traced one wraps the optimizer's update in
        the span optimizer_ms.train reads, and is not a window step."""
        if traced:
            update = self.opt.update

            def spanned(*a, **k):
                with span("portbench.optimizer"):
                    return update(*a, **k)

            self.opt.update = spanned
            try:
                self._step()
            finally:
                self.opt.update = update
        else:
            self._step()
            self.steps += 1

    def window_stats(self, window_s: float) -> dict:
        b = self.traffic["batch"]
        return {"seconds": window_s, "steps": self.steps, "attempted": self.steps, "failed": 0,
                "pages": self.steps * b,
                "step_flops": train_step_flops(self.cfg, b, self.traffic["text_len"])}

    def end_to_end(self, window: dict) -> dict:
        return {"train_pages_per_s": window["pages"] / window["seconds"]}

    def release(self) -> None:
        for name in ("model", "opt", "state", "ts", "data"):
            self.__dict__.pop(name, None)

    # -- the check --------------------------------------------------------------
    def reference(self, low: bool = False) -> dict:
        """The reference's losses, first-gradient norms and change norms over
        the checked steps, from the same weights and batches (`low`: the
        control's precision)."""
        batches = self.batches
        dev = self.device
        with exact_float32():
            served = weights.make(self.cfg, self.seed, dev)
            stored = {k: v.dtype for k, v in served.items()}
            params = {k: v.float().requires_grad_(True) for k, v in served.items()}
            del served
            start = {k: p.detach().clone() for k, p in params.items()}
            ref = Reference(self.cfg, params, Precision(low), checkpoint=True)
            opt = RefAdamW(self.traffic["lr"])
            losses, grad_norms = [], {}
            names = list(params)
            for i in range(self.traffic["checked_steps"]):
                b = batches[i % len(batches)]
                pages = torch.from_numpy(np.ascontiguousarray(b["pages_u8"])).to(dev)
                ids = torch.from_numpy(np.asarray(b["token_ids"])).to(dev, torch.long)
                loss = ref.loss(pages, ids)
                grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
                grads = RefAdamW.clip(grads, opt.max_norm)
                if i == 0:
                    grad_norms = _norms(grads)
                opt.update(params, grads, stored)
                losses.append(float(loss.detach()))
                del grads, loss
            update_norms = _change_norms(params, start)
        return {"losses": losses, "grad_norms": grad_norms, "update_norms": update_norms}

    def program(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms, "update_norms": self.update_norms}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """The numbers: loss_gap; grad_gap and update_gap by the worst leaf;
        grad_gap_median and update_gap_median by the median leaf, steady where
        one small leaf swings (a Switch-MoE router, whose gradient follows
        top-1 choices that flip near ties)."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        grad_gap, grad_leaf, grad_median = worst_and_median(leaf_gaps(got["grad_norms"], ref["grad_norms"]))
        median_grad = statistics.median(ref["grad_norms"].values())
        moving = [k for k, g in ref["grad_norms"].items() if g >= STILL_LEAF * median_grad]
        update_gap, update_leaf, update_median = worst_and_median(
            leaf_gaps(got["update_norms"], ref["update_norms"], moving))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
                "grad_gap_median": grad_median, "update_gap_median": update_median,
                "_grad_leaf": grad_leaf, "_update_leaf": update_leaf,
                "_still_leaves": len(ref["grad_norms"]) - len(moving)}

    def check(self) -> Dict[str, float]:
        found = self.compare(self.program(), self.reference())
        print(f"portbench: worst leaves: gradient {found['_grad_leaf']}, change {found['_update_leaf']}; "
              f"{found['_still_leaves']} leaves left out of update_gap", file=sys.stderr)
        return {k: v for k, v in found.items() if not k.startswith("_")}
