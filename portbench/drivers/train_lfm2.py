"""Training cells of an LFM2 configuration (traffic kind `train_lfm2`): the
port's `train_step` on `device_batch`, as drivers/train.py drives the
repo's presets, with LFM2's own weights (weights_lfm2.py), plain reference
(reference/lfm2.py) and FLOP count (yardstick/lfm2_flops.py).

The checked steps are train.py's, and so are its numbers, printed beside
this driver's own. Three things differ:

- the routing: rounding flips top-k choices whose biased scores lie close,
  and a flipped token moves every later position through the convs and
  attention, so the reference routes as the program did. Set-up keeps each
  checked step's choices, weights and router logits of every `TopKMoE`
  (its first call a step, the forward's), and the reference takes those
  choices in place of its own (`reference.lfm2.Lfm2Reference.route`);
- the numbers: with the routing shared, the first gradients are compared
  as vectors. Set-up keeps each leaf's first gradient as the optimizer got
  it (its first moment over 1 - b1) on the host, and the check compares:
  - grad_vec_gap: the worst leaf's |program - reference| of its first
    gradient, in L2, against the larger of the reference's norm of that
    leaf and of the median leaf; grad_vec_gap_median: the median leaf's;
  - route_miss: the share of the program's (token, expert) pairs over the
    checked steps that the reference's own choice does not hold;
  - route_choice_gap and route_weight_gap: the routing step alone, free of
    the hidden states' rounding. The reference's formulas
    (`reference.lfm2.choose` and `weigh`) on the program's own router
    logits, with the seeded expert biases, over the checked steps: the
    share of the program's pairs that `choose` does not pick, and the
    relative L2 gap of the program's weights against `weigh`'s on its
    choices;
- the state: the expert biases are buffers, loaded with the weights and
  never a leaf of the optimizer, so no change or gradient of theirs is
  compared; and the reference streams its gradients and holds the bf16
  experts in bf16 (`reference.lfm2.train_steps`), since the f32 state of
  5.3B parameters with their gradients and moments would not fit on one
  card."""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Optional

import torch

from .. import traffic as traffic_mod
from .. import weights_lfm2
from ..reference.lfm2 import Lfm2Reference, choose, train_steps, weigh
from ..reference.optim import AdamW as RefAdamW
from ..reference.precision import Precision, exact_float32
from ..yardstick.lfm2_flops import train_step_flops
from . import train
from .common import worst_and_median


def _params_only(w: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    drop = set(weights_lfm2.buffers(cfg))
    return {k: v for k, v in w.items() if k not in drop}


class Run(train.Run):
    def setup(self) -> None:
        from vision_compression_project_tpu_torch.models.layers import TopKMoE
        from vision_compression_project_tpu_torch.train import data, train_step as ts

        self.ts, self.data = ts, data
        self.batches = traffic_mod.host_batches(self.traffic, self.cfg, self.seed)
        self.model, self.opt, self.state = ts.make_train_state(self.vlm_cfg, device=self.device, seed=self.seed,
                                                               lr=self.traffic["lr"])
        w = weights_lfm2.make(self.cfg, self.seed, self.device)
        ts.load_whole_params(self.model, w)
        del w
        self.next = 0
        self.routes: List[Dict[str, tuple]] = []
        moes = {name: m for name, m in self.model.named_modules() if isinstance(m, TopKMoE)}
        for name, m in moes.items():
            m.routing = self._recording(name, m)
        try:
            for i in range(self.traffic["checked_steps"]):
                self.routes.append({})
                loss = self._step()
                self.losses.append(float(loss))
                self.routes[-1] = {k: tuple(t.cpu() for t in v) for k, v in self.routes[-1].items()}
                if i == 0:
                    mu = self.state.opt_state.mu
                    self.grad_scale = {k: float(torch.tensor(1 - self.opt.b1, dtype=m.dtype)) for k, m in mu.items()}
                    self.grad_norms = {k: v / self.grad_scale[k] for k, v in train._norms(mu).items()}
                    self.first_grads = {k: m.to("cpu", copy=True) for k, m in mu.items()}
        finally:
            for m in moes.values():
                del m.routing
        start = _params_only(weights_lfm2.make(self.cfg, self.seed, self.device), self.cfg)
        self.update_norms = train._change_norms(self.state.params, start)
        del start

    def _recording(self, name: str, moe):
        """`moe.routing` that keeps the current step's first (choices,
        weights, router logits) under the reference's prefix `name`."""
        def routing(x32):
            choice, w = type(moe).routing(moe, x32)
            if name not in self.routes[-1]:
                with torch.no_grad():
                    self.routes[-1][name] = (choice.clone(), w.detach().clone(), moe.router(x32))
            return choice, w
        return routing

    def window_stats(self, window_s: float) -> dict:
        stats = super().window_stats(window_s)
        stats["step_flops"] = train_step_flops(self.cfg, self.traffic["batch"], self.traffic["text_len"])
        return stats

    def program(self) -> dict:
        return {**super().program(), "routes": self.routes, "first_grads": self.first_grads,
                "grad_scale": self.grad_scale}

    def reference(self, low: bool = False, against: Optional[dict] = None, keep: bool = False) -> dict:
        """The reference's losses, first-gradient norms and change norms over
        the checked steps, from the same weights and batches (`low`: the
        control's precision). `against`: a program's readings, whose routing
        the reference takes and whose first gradients it measures its own
        against ("grad_vectors": leaf -> [gap, reference norm]; "route": the
        routing's tallies, with those of `_formulas`). `keep`: the result
        holds its own routing and first gradients as a program's."""
        gaps: Dict[str, torch.Tensor] = {}
        kept: Dict[str, torch.Tensor] = {}

        def first_grad(k, g):
            if against is not None:
                p = against["first_grads"][k].to(g.device, torch.float32) / against["grad_scale"][k]
                gaps[k] = torch.stack([torch.linalg.vector_norm(p - g), torch.linalg.vector_norm(g)])
            if keep:
                kept[k] = g.to(stored[k]).cpu()

        with exact_float32():
            served = weights_lfm2.make(self.cfg, self.seed, self.device)
            stored = {k: v.dtype for k, v in served.items()}
            fixed = set(weights_lfm2.buffers(self.cfg))
            # The bf16 experts stay bf16, their exact values (reference.lfm2.train_steps).
            for k, v in served.items():
                v.requires_grad_(k not in fixed)
            params = {k: v for k, v in served.items() if k not in fixed}
            ref = Lfm2Reference(self.cfg, served, Precision(low), checkpoint=True)
            formulas = None if against is None else self._formulas(against["routes"], served)
            opt = RefAdamW(self.traffic["lr"])
            found = train_steps(ref, params, stored, self.batches, opt, self.traffic["checked_steps"], self.device,
                                routes=None if against is None else against["routes"], record=keep,
                                first_grad=first_grad)
            opt.mu.clear()
            opt.nu.clear()
            start = _params_only(weights_lfm2.make(self.cfg, self.seed, self.device), self.cfg)
            found["update_norms"] = train._change_norms(params, start)
        if formulas is not None:
            found["route"].update(formulas)
        if gaps:
            found["grad_vectors"] = dict(zip(gaps, torch.stack(list(gaps.values())).cpu().tolist()))
        if keep:
            found.update(first_grads=kept, grad_scale={k: 1.0 for k in kept})
        return found

    def _formulas(self, routes: List[Dict[str, tuple]], served: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The tallies of `choose` and `weigh` on a program's own router
        logits: the pairs, those of the program's that `choose` does not
        pick, and the squared sums of the weights' gap and of `weigh`'s."""
        k = self.cfg["decoder"]["experts_per_token"]
        sums = torch.zeros(4, dtype=torch.float64, device=self.device)
        for step in routes:
            for name, (choice, w, logits) in step.items():
                scores = torch.sigmoid(logits.to(self.device, torch.float32))
                choice = choice.to(self.device)
                picked = choose(scores, served[f"{name}.expert_bias"], k)
                want = weigh(scores, choice)
                sums += torch.stack([torch.tensor(choice.numel(), device=self.device),
                                     (choice[:, :, None] != picked[:, None, :]).all(dim=-1).sum(),
                                     (w.to(self.device) - want).square().sum(), want.square().sum()]).double()
        return dict(zip(("formula_pairs", "formula_missed", "weight_gap", "weight"), sums.tolist()))

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """train.py's numbers, and, where the reference ran against the
        program, grad_vec_gap, grad_vec_gap_median, route_miss,
        route_choice_gap and route_weight_gap (the module docstring)."""
        found = train.Run.compare(got, ref)
        if "grad_vectors" in ref:
            vec = ref["grad_vectors"]
            floor = statistics.median(norm for _, norm in vec.values())
            worst, leaf, median = worst_and_median({k: gap / max(norm, floor) for k, (gap, norm) in vec.items()})
            found.update(grad_vec_gap=worst, grad_vec_gap_median=median, _grad_vec_leaf=leaf)
        if "route" in ref:
            r = ref["route"]
            found.update(route_miss=r["missed"] / r["pairs"], route_choice_gap=r["formula_missed"] / r["formula_pairs"],
                         route_weight_gap=math.sqrt(r["weight_gap"] / r["weight"]))
        return found

    def check(self) -> Dict[str, float]:
        got = self.program()
        found = self.compare(got, self.reference(against=got))
        print(f"portbench: worst leaves: gradient {found['_grad_leaf']}, gradient vector {found['_grad_vec_leaf']}, "
              f"change {found['_update_leaf']}; {found['_still_leaves']} leaves left out of update_gap",
              file=sys.stderr)
        return {k: v for k, v in found.items() if not k.startswith("_")}
