"""Extraction cells: `VLMRunner.extract_batch_async` then `collect_extract`
on one batch of the benchmark's pages a unit, as pipeline/extract.py's
`_extract_chunk` calls them.

Set-up builds the runner with the benchmark's seeded weights and runs one
warm-up batch. The window keeps every batch's tokens as the timed path
produced them. The check draws a sample of the finished pages from the seed,
the page with the most served tokens among them, and runs the plain
reference once over each page, its prompt and its served tokens:

- logit_gap: the widest gap, over every served token of the sample, by which
  the served token's masked logit lies below the reference's best masked
  logit at that position."""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import traffic as traffic_mod
from .. import weights
from ..reference.model import Reference
from ..reference.precision import Precision, exact_float32
from ..reference.tokens import BOS_ID, EOS_ID, TASK_EXTRACT_ID, extract_mask
from ..yardstick.flops import extract_batch_flops

PROMPT = [BOS_ID, TASK_EXTRACT_ID]


def served_rows(toks: np.ndarray) -> List[List[int]]:
    """Each row's served tokens, up to and with its EOS."""
    out = []
    for row in toks.tolist():
        out.append(row[: row.index(EOS_ID) + 1] if EOS_ID in row else row)
    return out


def decode_steps(rows: List[List[int]], max_new: int) -> int:
    """The decode steps VLMRunner.generate took for a batch: it stops once
    every row has emitted EOS, or after max_new - 1 steps."""
    last = [len(r) - 1 if r and r[-1] == EOS_ID else max_new - 1 for r in rows]
    return min(max_new - 1, max(last))


class Run:
    def __init__(self, cfg: dict, vlm_cfg, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.vlm_cfg, self.traffic, self.seed, self.device = cfg, vlm_cfg, traffic, seed, device
        self.done: List[dict] = []
        self.next = 0

    def setup(self) -> None:
        from vision_compression_project_tpu_torch.models.vlm import VLMRunner

        self.batches = traffic_mod.host_batches(self.traffic, self.cfg, self.seed)
        w = weights.make(self.cfg, self.seed, self.device)
        self.runner = VLMRunner(self.vlm_cfg, params=w, device=self.device, max_new_default=self.traffic["max_new"])
        del w
        self._batch(self.batches[0]["pages_u8"])           # warm-up: every shape the window uses

    def _batch(self, pages: np.ndarray):
        numbers = list(range(1, pages.shape[0] + 1))
        handle = self.runner.extract_batch_async(pages, numbers, max_new=self.traffic["max_new"])
        records = self.runner.collect_extract(handle)
        return handle[0], records

    def unit(self, traced: bool = False) -> None:
        """One extraction batch; a traced one is not a window batch."""
        index = self.next % len(self.batches)
        pages = self.batches[index]["pages_u8"]
        t0 = time.perf_counter()
        toks, records = self._batch(pages)
        seconds = time.perf_counter() - t0
        self.next += 1
        if not traced:
            came = sum(1 for r in records if set(r) >= {"page_number", "markdown"})
            self.done.append({"pool": index, "toks": toks, "seconds": seconds, "pages": len(records),
                              "failed": pages.shape[0] - came})

    def _finish(self, units: List[dict]) -> None:
        for u in units:
            if "rows" not in u:
                u["rows"] = served_rows(u["toks"].cpu().numpy())
                u["decode_steps"] = decode_steps(u["rows"], self.traffic["max_new"])
                u["flops"] = extract_batch_flops(self.cfg, [len(r) for r in u["rows"]])
                del u["toks"]

    def window_stats(self, window_s: float) -> dict:
        self._finish(self.done)
        for i, u in enumerate(self.done):
            print(f"portbench: batch {i}: {u['decode_steps']} decode steps, {u['seconds']:.4f} s", file=sys.stderr)
        return {"seconds": window_s, "units": self.done,
                "attempted": sum(self.traffic["batch"] for _ in self.done),
                "failed": sum(u["failed"] for u in self.done),
                "pages": sum(u["pages"] for u in self.done)}

    def end_to_end(self, window: dict) -> dict:
        return {"extract_pages_per_s": window["pages"] / window["seconds"]}

    def release(self) -> None:
        self.__dict__.pop("runner", None)

    # -- the check --------------------------------------------------------------
    def sample(self) -> List[tuple]:
        """(pool batch, row, served tokens) of the sampled pages: the one with
        the most served tokens, and sample_rows - 1 more drawn from the seed."""
        every = [(u["pool"], r, row) for u in self.done for r, row in enumerate(u["rows"])]
        longest = max(range(len(every)), key=lambda i: len(every[i][2]))
        rng = traffic_mod.rng_for(self.seed, 2)
        rest = [i for i in range(len(every)) if i != longest]
        k = min(self.traffic["sample_rows"] - 1, len(rest))
        picked = [longest] + [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
        return [every[i] for i in picked]

    def reference_logits(self, picks: List[tuple], low: bool = False) -> List[torch.Tensor]:
        """The reference's masked logits at every served position of each pick."""
        dev = self.device
        d = self.cfg["decoder"]
        mask = torch.from_numpy(extract_mask(d["tokenizer"], d["vocab"])).to(dev)
        out = []
        with exact_float32():
            served = weights.make(self.cfg, self.seed, dev)
            params = {k: v.float() for k, v in served.items()}
            del served
            ref = Reference(self.cfg, params, Precision(low))
            for pool, row, toks in picks:
                page = torch.from_numpy(np.ascontiguousarray(self.batches[pool]["pages_u8"][row])).to(dev)
                out.append(ref.served_logits(page, PROMPT, toks) + mask)
        return out

    @staticmethod
    def gap(logits: List[torch.Tensor], tokens: List[List[int]]) -> float:
        widest = 0.0
        for lg, toks in zip(logits, tokens):
            idx = torch.tensor(toks, device=lg.device)
            g = (lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]).max()
            widest = max(widest, float(g))
        return widest

    def check(self) -> Dict[str, float]:
        picks = self.sample()
        logits = self.reference_logits(picks)
        return {"logit_gap": self.gap(logits, [t for _, _, t in picks])}
