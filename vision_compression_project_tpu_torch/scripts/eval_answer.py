"""Generated-answer quality: does the LM answer engine reproduce the
extractive teacher on fresh synthetic QA examples? The port of
scripts/eval_answer.py, with its arguments, printed lines and JSON.

The answer task (scripts/train_answer.py) supervises the LM with the
extractive engine's cited-markdown format (train/data.py::
_synthetic_qa_example). --task imitate reports the SequenceMatcher
similarity of generated and teacher answers and the rate of well-formed
citations; --task agg the key-fact accuracy on cross-page aggregation
questions, head to head with the extractive and analytic engines. Runs on
RUNTIME.device (VCP_DEVICE, the card unless it says "cpu"):

    python -m vision_compression_project_tpu_torch.scripts.eval_answer \\
        --ckpt_dir checkpoints/default/ocr_bpe --task agg --data real --json_out agg.json
"""

import argparse
import difflib
import json
import re
from pathlib import Path

import numpy as np

from .. import config

_PAGE_HEADER = re.compile(r"\[Page (\d+) \| memory_id=(\S+)\]")


def _agg_keyfact_ok(got: str, facts: dict) -> bool:
    """The aggregate claim appears in the answer: for counts and totals a
    value no evidence sentence holds; for superlatives the winning name and
    value and the comparative ('most'), not the winning row quoted by luck."""
    if not re.search(rf"\b{facts['value']}\b", got):
        return False
    if facts["kind"] == "max":
        low = got.lower()
        if facts["name"] not in low or "most" not in low:
            return False
    return True


def _pack_results(evidence_pack: str) -> list:
    """The per-page results an evidence pack was built from."""
    results = []
    for section in evidence_pack.split("\n\n---\n\n"):
        header, _, content = section.partition("\n")
        m = _PAGE_HEADER.match(header)
        if m:
            results.append({"id": m.group(2), "content": content, "metadata": {"page": int(m.group(1))}})
    return results


def _extractive_answer_for_pack(question: str, evidence_pack: str) -> str:
    """The extractive engine on the evidence the LM saw: per-page results
    rebuilt from the pack, then the quoted-sentence answer."""
    from ..models import EmbedderConfig, HashNGramEmbedder
    from ..pipeline.qa import _compose_extractive_answer

    embedder = HashNGramEmbedder(EmbedderConfig(dim=256, ngram_buckets=4096), device=config.RUNTIME.device)
    return _compose_extractive_answer(question, _pack_results(evidence_pack), None, "doc", 1500, embedder)


def _eval_agg(runner, rng, n_examples: int, sentence_pool=None) -> dict:
    from ..pipeline.aggregate import try_analytic_answer
    from ..train.data import _synthetic_agg_qa_example

    lm_ok = ex_ok = an_ok = auto_ok = 0
    lm_cited = auto_cited = 0.0
    sample = None
    for _ in range(n_examples):
        q, ev, teacher, facts = _synthetic_agg_qa_example(rng, sentence_pool=sentence_pool)
        got = runner.answer(q, ev).strip()
        extractive = _extractive_answer_for_pack(q, ev)
        analytic = try_analytic_answer(q, _pack_results(ev), None, "doc", 1500)
        served = analytic if analytic is not None else got  # engine 'auto'
        lm_ok += _agg_keyfact_ok(got, facts)
        ex_ok += _agg_keyfact_ok(extractive, facts)
        an_ok += analytic is not None and _agg_keyfact_ok(analytic, facts)
        auto_ok += _agg_keyfact_ok(served, facts)
        need = facts["cited"]
        lm_cited += sum(f"p.{p}" in got for p in need) / len(need)
        auto_cited += sum(f"p.{p}" in served for p in need) / len(need)
        if sample is None:
            sample = (q, teacher, got, extractive, analytic)
    print(
        f"aggregation key-fact accuracy over {n_examples} fresh examples:\n"
        f"  auto (SERVED: analytic->lm): {auto_ok}/{n_examples}\n"
        f"  analytic (deterministic):    {an_ok}/{n_examples}\n"
        f"  lm (generative):             {lm_ok}/{n_examples}\n"
        f"  extractive baseline:         {ex_ok}/{n_examples}\n"
        f"  lm citation coverage:  {lm_cited / n_examples:.2f}\n"
        f"  auto citation coverage: {auto_cited / n_examples:.2f}"
    )
    q, t, g, e, a = sample
    print(f"\nsample question: {q}")
    print(f"teacher:    {t!r}")
    print(f"analytic:   {a!r}")
    print(f"lm:         {g!r}")
    print(f"extractive: {e!r}")
    return {
        "task": "agg",
        "examples": n_examples,
        "auto_keyfact_accuracy": auto_ok / n_examples,
        "analytic_keyfact_accuracy": an_ok / n_examples,
        "lm_keyfact_accuracy": lm_ok / n_examples,
        "extractive_keyfact_accuracy": ex_ok / n_examples,
        "lm_citation_coverage": lm_cited / n_examples,
        "auto_citation_coverage": auto_cited / n_examples,
    }


def _positive_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("--examples must be >= 1")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="ocr_bpe")
    parser.add_argument("--ckpt_dir", required=True)
    parser.add_argument("--examples", type=_positive_int, default=16)
    parser.add_argument("--seed", type=int, default=4242)
    parser.add_argument("--max_new", type=int, default=128)
    parser.add_argument(
        "--task", choices=["imitate", "agg"], default="imitate",
        help="imitate: similarity to the extractive-format teacher; agg: key-fact accuracy on cross-page "
        "aggregation questions, scored head to head against the extractive engine (which only quotes sentences)",
    )
    parser.add_argument("--data", choices=["words", "real"], default="words",
                        help="evidence distribution: 'real' draws held-out real-language corpus sentences")
    parser.add_argument("--json_out", default=None,
                        help="write machine-readable results here (the answer-hop driver gates shipping on them)")
    args = parser.parse_args(argv)

    from ..models import get_preset
    from ..train import checkpoint
    from ..train.data import _synthetic_qa_example, qa_sentence_pool

    rng = np.random.default_rng(args.seed)
    # Held-out split: sentences the answer hop never trained on.
    pool = qa_sentence_pool("heldout") if args.data == "real" else None
    runner = checkpoint.load_runner(get_preset(args.preset), args.ckpt_dir, max_new_default=args.max_new,
                                    device=config.RUNTIME.device)
    if args.task == "agg":
        result = _eval_agg(runner, rng, args.examples, sentence_pool=pool)
        if args.json_out:
            Path(args.json_out).write_text(json.dumps(result, indent=1))
        return
    examples = [_synthetic_qa_example(rng, sentence_pool=pool) for _ in range(args.examples)]
    sims, cited = [], 0
    sample = None
    for question, evidence, teacher in examples:
        got = runner.answer(question, evidence).strip()
        sims.append(difflib.SequenceMatcher(None, teacher, got).ratio())
        if re.search(r"\(doc p\.\d+\)", got):
            cited += 1
        if sample is None:
            sample = (question, teacher, got)
    print(f"answer similarity over {args.examples} fresh examples: "
          f"mean={np.mean(sims):.3f} min={min(sims):.3f} max={max(sims):.3f}")
    print(f"citation well-formed rate: {cited}/{args.examples}")
    q, t, g = sample
    print(f"\nsample question: {q}")
    print(f"teacher: {t!r}")
    print(f"generated: {g!r}")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "task": "imitate",
            "examples": args.examples,
            "similarity_mean": float(np.mean(sims)),
            "similarity_min": float(min(sims)),
            "citation_rate": cited / args.examples,
        }, indent=1))


if __name__ == "__main__":
    main()
