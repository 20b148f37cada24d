"""The port's retrieval harness (scripts/eval_retrieval.py in the port)
against the repository's own, on the CPU: the same corpus and questions, and
the same hit@k for each mode with the hash embedder, whose vectors equal the
JAX package's to 1e-6. The 40-page form runs on the card in
tests/test_torch_gpu.py."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

from vision_compression_project_tpu_torch.scripts import eval_retrieval as teval

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture(scope="module")
def jeval():
    """The repository's scripts/eval_retrieval.py, imported as its command
    line imports it (scripts/ on the path for its _bootstrap)."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        spec = importlib.util.spec_from_file_location("jax_eval_retrieval", SCRIPTS / "eval_retrieval.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(SCRIPTS))


def test_corpus_equal(jeval):
    for n in (1, 20, 45):
        assert teval.build_corpus(n) == jeval.build_corpus(n)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_hit_rate_equal(jeval, mode, monkeypatch):
    from vision_compression_project_tpu_torch import config

    monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, device="cpu"))
    pages, questions = teval.build_corpus(30)
    got = teval.evaluate(mode, "hash", pages, questions, 1)
    assert got == jeval.evaluate(mode, "hash", pages, questions, 1)
    assert got >= 0.9
