"""The port's eval command lines (scripts/eval_extract.py, eval_ocr.py and
eval_answer.py in the port) against the repository's own, on the CPU, with
load_runner replaced in both packages by the same deterministic stub runner:
each script renders or generates the same inputs, hands them to the stub and
scores what it returns. The JSON files must equal the JAX scripts' byte for
byte and the printed lines exactly (only the seconds of eval_extract's
progress lines are masked). This holds the data, scoring and reporting code
against the reference; the models are held by the logits tests. One
unstubbed run of the port's eval_extract on `tiny` checks the CPU path.

Every data kind of eval_extract runs: words, real and jumble on a small
shared sentence pool, golden on a temporary VCP_GOLDEN_MD file, golden_png
on temporary page PNGs (written by PIL; the port reads them with its own
reader) and their page JSONs under VCP_GOLDEN_PAGES.
"""

import dataclasses
import json
import re
import sys

import numpy as np
import pytest
from PIL import Image

from vision_compression_project_tpu.train import checkpoint as jcheckpoint
from vision_compression_project_tpu.train import corpus as jcorpus
from vision_compression_project_tpu_torch import config as tconfig
from vision_compression_project_tpu_torch.scripts import eval_answer as teval_answer
from vision_compression_project_tpu_torch.scripts import eval_extract as teval_extract
from vision_compression_project_tpu_torch.scripts import eval_ocr as teval_ocr
from vision_compression_project_tpu_torch.train import checkpoint as tcheckpoint
from vision_compression_project_tpu_torch.train import corpus as tcorpus

from torch_parity import jax_script

_WORDS = "model data page table figure result method train loss token image system value".split()


class StubRunner:
    """A deterministic stand-in for VLMRunner: a page's record is made from
    the count of its dark pixels, an answer from the question and the
    evidence pack's text."""

    def __init__(self, *args, **kwargs):
        pass

    def extract_batch(self, pages, page_numbers, max_new=None):
        out = []
        for page, n in zip(np.asarray(pages), page_numbers):
            ink = int((page[..., 0] < 128).sum())
            words = [_WORDS[(ink + 7 * i) % len(_WORDS)] for i in range(4 + ink % 5)]
            markdown = f"# Page {n}\n\n" + " ".join(words).capitalize() + f". Code {ink % 997} {ink % 89}."
            out.append({"page_number": n, "markdown": markdown, "summary": " ".join(words[:3]),
                        "entities": words[:2]})
        return out

    def answer(self, question, evidence_pack, max_new=None):
        body = evidence_pack.split("\n", 1)[1] if "\n" in evidence_pack else evidence_pack
        sentence = body.split(". ")[0].split("\n")[0].rstrip(".")
        produced = re.findall(r"(\w+) produced (\d+)", evidence_pack)
        extra = ""
        if produced:
            values = [int(v) for _, v in produced]
            extra = f" {sum(values)} in total; {produced[int(np.argmax(values))][0].lower()} the most"
        if "How many pages" in question:
            extra += f" {evidence_pack.count('module is covered')} pages"
        return f"  Based on the retrieved pages (doc p.1):\n\n- {sentence}.{extra} (doc p.1)\n"


@pytest.fixture
def stubbed(monkeypatch):
    """load_runner replaced in both packages; the port on the CPU."""
    monkeypatch.setattr(jcheckpoint, "load_runner", StubRunner)
    monkeypatch.setattr(tcheckpoint, "load_runner", StubRunner)
    monkeypatch.setattr(tconfig, "RUNTIME", dataclasses.replace(tconfig.RUNTIME, device="cpu"))


@pytest.fixture
def small_pool(monkeypatch):
    """Both corpora on one seeded pool, so real and jumble pages and real
    evidence need no harvest of the installed packages."""
    rng = np.random.default_rng(0)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel", "india", "juliet",
             "kilometre", "lighthouse", "mountains", "november", "produced", "module"]
    pool = [" ".join(rng.choice(words, size=int(rng.integers(4, 16)))).capitalize() + "." for _ in range(600)]
    for module in (tcorpus, jcorpus):
        monkeypatch.setattr(module, "_sentences_cache", {"_all": list(pool)})
    return pool


def _run_both(name, args, tmp_path, capsys, monkeypatch, port_module):
    """(port stdout, JAX stdout, port json, JAX json) of one command line,
    with --json_out into a file of each side's own when `args` has it."""
    outs = []
    for side in ("port", "jax"):
        side_args = [a.replace("{out}", str(tmp_path / f"{side}.json")) for a in args]
        if side == "port":
            port_module.main(side_args)
        else:
            monkeypatch.setattr(sys, "argv", [f"{name}.py", *side_args])
            jax_script(name).main()
        text = capsys.readouterr().out
        path = tmp_path / f"{side}.json"
        outs.append((text, path.read_text() if path.exists() else None))
    (port_out, port_json), (jax_out, jax_json) = outs
    return port_out, jax_out, port_json, jax_json


def _mask_seconds(text):
    return re.sub(r"^eval pages (\d+)/(\d+) \(\d+s\)$", r"eval pages \1/\2 (Ns)", text, flags=re.M)


GOLDEN_MD = """# Golden Report

The audit team reviewed every invoice in the third quarter of the year.
The night shift rejected twelve defect reports after the inspection round.

Results were stored in the archive for the billing service! Were the totals correct in every region?
They were checked twice by the finance group before the report went out.
"""


def _golden_pages(tmp_path):
    """Three page PNGs (gray, RGB and RGBA, of different sizes) with their
    page JSONs, and a fourth whose raw_response has no markdown."""
    pages = tmp_path / "golden_pages"
    pages.mkdir()
    rng = np.random.default_rng(4)
    for i, (mode, shape) in enumerate([("L", (90, 70)), ("RGB", (80, 96, 3)), ("RGBA", (100, 64, 4)),
                                       ("RGB", (40, 40, 3))], start=1):
        px = np.where(rng.random(shape) < 0.2, 0, 255).astype(np.uint8)
        Image.fromarray(px, mode).save(pages / f"page_{i:03d}.png")
        record = {"markdown": f"# Page {i}\n\nModel data page {i} table figure."} if i < 4 else {"text": "x"}
        (pages / f"page_{i:03d}.json").write_text(json.dumps({"raw_response": json.dumps(record)}))
    return pages


@pytest.mark.parametrize(
    "data,extra",
    [("words", []), ("real", []), ("jumble", ["--vocab_cap", "8", "--jumble_plain", "1"]), ("golden", []),
     ("golden_png", [])],
)
def test_eval_extract_equals_jax(stubbed, small_pool, tmp_path, capsys, monkeypatch, data, extra):
    md = tmp_path / "combined.md"
    md.write_text(GOLDEN_MD)
    monkeypatch.setenv("VCP_GOLDEN_MD", str(md))
    monkeypatch.setenv("VCP_GOLDEN_PAGES", str(_golden_pages(tmp_path)))
    args = ["--ckpt_dir", str(tmp_path / "none"), "--data", data, "--pages", "5", "--chunk", "2",
            "--dpi", "30", "--lines", "4", "--seed", "7", "--json_out", "{out}", *extra]
    port_out, jax_out, port_json, jax_json = _run_both("eval_extract", args, tmp_path, capsys, monkeypatch,
                                                       teval_extract)
    assert _mask_seconds(port_out) == _mask_seconds(jax_out)
    assert port_json == jax_json and port_json is not None
    result = json.loads(port_json)
    assert result["data"] == data and 0.0 <= result["markdown_similarity_mean"] <= 1.0
    n_progress = 2 if data == "golden_png" else 3  # 3 readable pages there, in chunks of 2
    assert port_out.count("eval pages") == n_progress


def test_eval_ocr_equals_jax(stubbed, tmp_path, capsys, monkeypatch):
    args = ["--ckpt_dir", str(tmp_path / "none"), "--pages", "3", "--dpi", "30", "--lines", "3"]
    port_out, jax_out, _, _ = _run_both("eval_ocr", args, tmp_path, capsys, monkeypatch, teval_ocr)
    assert port_out == jax_out and "digit-sequence similarity over 3 fresh pages:" in port_out


@pytest.mark.parametrize("task", ["imitate", "agg"])
@pytest.mark.parametrize("data", ["words", "real"])
def test_eval_answer_equals_jax(stubbed, small_pool, tmp_path, capsys, monkeypatch, task, data):
    args = ["--ckpt_dir", str(tmp_path / "none"), "--task", task, "--data", data, "--examples", "6",
            "--json_out", "{out}"]
    port_out, jax_out, port_json, jax_json = _run_both("eval_answer", args, tmp_path, capsys, monkeypatch,
                                                       teval_answer)
    assert port_out == jax_out
    assert port_json == jax_json and json.loads(port_json)["task"] == task


def test_eval_answer_refuses_zero_examples(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        teval_answer.main(["--ckpt_dir", str(tmp_path), "--examples", "0"])
    assert err.value.code == 2 and "--examples must be >= 1" in capsys.readouterr().err


def test_eval_extract_runs_tiny_on_the_cpu(tmp_path, capsys, monkeypatch):
    """No stub: the port's eval_extract with fresh `tiny` weights on the CPU,
    two pages, a short decode."""
    monkeypatch.setattr(tconfig, "RUNTIME", dataclasses.replace(tconfig.RUNTIME, device="cpu"))
    out = tmp_path / "e.json"
    teval_extract.main(["--preset", "tiny", "--ckpt_dir", str(tmp_path / "none"), "--pages", "2", "--dpi", "30",
                        "--max_new", "8", "--json_out", str(out)])
    result = json.loads(out.read_text())
    assert result["pages"] == 2 and result["render"]["dpi"] == 30
    for key in ("markdown_similarity_mean", "markdown_similarity_min", "summary_similarity_mean",
                "entities_similarity_mean"):
        assert 0.0 <= result[key] <= 1.0
    assert "eval pages 2/2" in capsys.readouterr().out
