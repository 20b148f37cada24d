"""The real-language corpus of the PyTorch port reads the reference's
files on any machine: with `sysconfig`'s purelib pointed at an empty
directory (an interpreter installed elsewhere), the port's `_harvest` gives
the JAX package's sentences, in order, and both golden defaults are one path.
"""

import sysconfig
from pathlib import Path

from vision_compression_project_tpu.train import corpus as jcorpus
from vision_compression_project_tpu_torch.train import corpus as tcorpus


def test_harvest_equals_the_jax_packages_whatever_the_interpreter(tmp_path, monkeypatch):
    paths = dict(sysconfig.get_paths(), purelib=str(tmp_path), platlib=str(tmp_path))
    monkeypatch.setattr(sysconfig, "get_paths", lambda *a, **k: dict(paths))
    want = jcorpus._harvest()
    got = tcorpus._harvest()
    assert len(got) == len(want) and got == want


def test_golden_defaults_are_the_jax_packages(monkeypatch):
    monkeypatch.delenv(tcorpus.GOLDEN_MD_ENV, raising=False)
    monkeypatch.delenv("VCP_GOLDEN_PAGES", raising=False)
    assert tcorpus._DEFAULT_GOLDEN_MD == Path(jcorpus._DEFAULT_GOLDEN_MD)
    assert tcorpus.golden_pages_dir() == Path(jcorpus._DEFAULT_GOLDEN_MD).parent / "pages"
