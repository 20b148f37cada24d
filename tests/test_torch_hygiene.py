"""The PyTorch port stands alone: importing every module of it, and what
chip_smoke.py imports, loads nothing of JAX, flax, optax, orbax, tensorstore,
zstandard, safetensors, triton, pydantic, fastapi, PIL or the JAX package; building its host
libraries writes nothing into the JAX package; and asking for the card where
there is none raises instead of running on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    # Importing JAX, flax, optax, orbax, tensorstore, zstandard, safetensors,
    # triton, pydantic, fastapi, PIL or the JAX package fails here.
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "safetensors", "triton",
                   "pydantic", "pydantic_core", "fastapi", "starlette", "PIL", "vision_compression_project_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocked())
sys.path.insert(0, sys.argv[1])
import vision_compression_project_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""

BANNED_PREFIXES = ("jax", "flax", "optax", "orbax", "tensorstore", "zstandard", "safetensors", "triton", "pydantic",
                   "fastapi", "starlette", "PIL")
JAX_PACKAGE = "vision_compression_project_tpu"


def _banned(name):
    # Exact package match: the port's own name starts with the JAX package's.
    return name.startswith(BANNED_PREFIXES) or name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + ".")


def test_port_and_chip_smoke_import_nothing_of_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO)], capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "vision_compression_project_tpu_torch.kernels" in modules
    for name in (
        "models.vlm", "models.embedder", "ops.topk", "index.vector_index", "index.multivector", "index.store",
        "pipeline.ingest", "pipeline.aggregate", "pipeline.qa", "config", "utils.metrics",
        "utils.json_utils", "native", "train.ocdbt", "train.checkpoint", "train.pages",
        "raster.rasterizer", "raster.pdfgen", "raster.ttf", "pipeline.textmd", "ops.glyph_render",
        "pipeline.extract", "utils.env", "utils.dirs", "utils.retry", "schemas", "serve", "serve.httpd",
        "serve.batching", "serve.ui", "serve.app", "scripts", "scripts.serve", "scripts.extract_pdf",
        "scripts.extract_page", "scripts.ingest_to_index", "scripts.qa_query",
        "scripts.eval_retrieval", "ops.attention", "train.train_step", "train.data", "train.corpus",
        "train.embedder_train", "weights", "scripts.train_vlm", "scripts.train_embedder",
        "raster.png", "scripts.eval_extract", "scripts.eval_ocr", "scripts.train_answer", "scripts.eval_answer",
        "scripts.ship_checkpoint", "scripts.run_answer_hop", "scripts.export_stage_params",
        "scripts.run_curriculum", "scripts.train_bpe", "parallel", "parallel.mesh", "parallel.sharding",
        "parallel.collectives", "parallel.launch", "ops.ring_attention", "ops.dct", "raster.page_store",
        "scripts.bench_index",
    ):
        assert f"vision_compression_project_tpu_torch.{name}" in modules
    assert [m for m in modules if _banned(m)] == []


def _tree_state(root):
    return sorted((str(p.relative_to(root)), p.stat().st_size, p.stat().st_mtime_ns)
                  for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts)


def test_building_the_host_libraries_writes_only_into_the_port(tmp_path, monkeypatch):
    """Both g++ libraries build from the port's own sources into the port's
    build directory, and the JAX package's tree is left as it was, its own
    engine library included. The zstd library builds afresh (into a new
    directory); the PDF engine builds where the other tests load it from."""
    from vision_compression_project_tpu_torch import native
    from vision_compression_project_tpu_torch.raster import rasterizer

    port_build = native.BUILD_DIR
    assert port_build == REPO / "vision_compression_project_tpu_torch" / "_build"
    assert rasterizer._CPP_DIR == REPO / "vision_compression_project_tpu_torch" / "raster" / "cpp"
    jax_package = REPO / JAX_PACKAGE
    before = _tree_state(jax_package)
    engine = rasterizer.build_library()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    fresh = native.build_zstd()
    assert engine.parent == port_build and fresh.parent == tmp_path / "_build"
    assert engine.exists() and fresh.exists()
    assert _tree_state(jax_package) == before


def test_banned_name_matching_is_exact():
    assert _banned("jaxlib.xla_client") and _banned("flax.linen")
    assert _banned("pydantic_core._pydantic_core") and _banned("fastapi.routing")
    assert _banned("optax._src.alias")
    assert _banned("vision_compression_project_tpu") and _banned("vision_compression_project_tpu.ops")
    assert not _banned("vision_compression_project_tpu_torch.ops")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from vision_compression_project_tpu_torch import VLMRunner, get_preset

    with pytest.raises(RuntimeError, match="cuda"):
        VLMRunner(get_preset("tiny"))  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        VLMRunner(get_preset("tiny"), device="cuda")
    from vision_compression_project_tpu_torch.index import VectorIndex
    from vision_compression_project_tpu_torch.models.embedder import HashNGramEmbedder

    with pytest.raises(RuntimeError, match="cuda"):
        VectorIndex(8)
    with pytest.raises(RuntimeError, match="cuda"):
        HashNGramEmbedder()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
