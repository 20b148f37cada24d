"""The key a kernel library is built under (kernels.build_key): it covers the
kernel's source, every header beside it and the compiler flags, so a changed
shared header rebuilds every library; kernels.build reuses a library whose
key is on disk and compiles anew when a header changes. Runs without nvcc:
the compiler is a stub that writes the output file."""

import shutil
import subprocess
from pathlib import Path

import pytest

from vision_compression_project_tpu_torch import kernels

NAMES = kernels.SOURCES
HERE = Path(kernels.__file__).resolve().parent


@pytest.fixture
def src(tmp_path):
    """A copy of the package's kernel sources and headers."""
    d = tmp_path / "src"
    d.mkdir()
    for f in HERE.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, d / f.name)
    return d


def test_both_attention_kernels_include_the_shared_header():
    assert (HERE / "hopper.cuh").exists()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in (HERE / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", NAMES)
def test_key_of_a_copy_is_the_packages(name, src):
    assert kernels.build_key(name, src) == kernels.build_key(name)


@pytest.mark.parametrize("name", NAMES)
def test_key_changes_with_a_headers_bytes(name, src):
    before = kernels.build_key(name, src)
    header = src / "hopper.cuh"
    header.write_bytes(header.read_bytes().replace(b"PRODUCER_REGS = 40", b"PRODUCER_REGS = 48"))
    assert kernels.build_key(name, src) != before


@pytest.mark.parametrize("name", NAMES)
def test_key_changes_with_a_new_header(name, src):
    before = kernels.build_key(name, src)
    (src / "more.cuh").write_text("// another shared header\n")
    assert kernels.build_key(name, src) != before


def test_key_changes_with_its_own_source_only(src):
    before = {name: kernels.build_key(name, src) for name in NAMES}
    path = src / "flash_attention.cu"
    path.write_bytes(path.read_bytes() + b"\n")
    after = {name: kernels.build_key(name, src) for name in NAMES}
    assert after["flash_attention"] != before["flash_attention"]
    assert {n: after[n] for n in NAMES[1:]} == {n: before[n] for n in NAMES[1:]}


def test_key_ignores_files_that_are_not_sources(src):
    before = {name: kernels.build_key(name, src) for name in NAMES}
    (src / "notes.txt").write_text("not a source\n")
    (src / "scratch.cu.orig").write_text("not a source either\n")
    assert {name: kernels.build_key(name, src) for name in NAMES} == before


def test_key_changes_with_the_flags(monkeypatch, src):
    before = kernels.build_key("flash_attention", src)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.build_key("flash_attention", src) != before


def test_build_reuses_a_library_and_rebuilds_after_a_header_change(monkeypatch, src, tmp_path):
    monkeypatch.setattr(kernels, "_HERE", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info: 0 bytes spill stores\n", stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", fake_nvcc)
    first = kernels.build("flash_attention")
    assert first.name == f"flash_attention-{kernels.build_key('flash_attention', src)}.so"
    assert first.exists() and len(calls) == 1 and calls[0][-1] == str(src / "flash_attention.cu")
    assert first.with_suffix(".log").read_text() == "ptxas info: 0 bytes spill stores\n"
    assert kernels.build("flash_attention") == first and len(calls) == 1

    header = src / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// a changed helper\n")
    second = kernels.build("flash_attention")
    assert second != first and second.exists() and len(calls) == 2
    assert kernels.build("flash_attention_bwd").name.endswith(f"-{kernels.build_key('flash_attention_bwd', src)}.so")
    assert len(calls) == 3
