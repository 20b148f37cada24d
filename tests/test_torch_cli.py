"""The port's command lines against the JAX package's library calls.

`python -m vision_compression_project_tpu_torch.scripts.<name>` runs as a
subprocess with VCP_DEVICE=cpu on tests/test_cli.py's 2-page PDF (its text
layer takes the text engine), in a workspace of its own. The JAX side does
the same work in-process through the library functions its scripts call
(its own CLI test is marked slow), in a second workspace with the same
relative paths. What the port writes must equal it: page JSON, manifest.json
keys and values, combined.md, the PNGs' pixels, supermemory_manifest.json,
the answer file's sections, and the stdout lines the JAX scripts print.
Timestamps and memory ids are masked; nothing else is. The training command
lines (`train_vlm`, `train_embedder`) run 2 steps at small widths on the CPU:
their step and checkpoint lines, and checkpoints the library loads.
"""

import json
import os
import re
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vision_compression_project_tpu import config as jconfig
from vision_compression_project_tpu.index import IndexStore as JIndexStore
from vision_compression_project_tpu.models import HashNGramEmbedder as JHashNGramEmbedder
from vision_compression_project_tpu.pipeline import extract as jextract
from vision_compression_project_tpu.pipeline import ingest as jingest
from vision_compression_project_tpu.pipeline import qa as jqa
from vision_compression_project_tpu.raster import PdfDocument as JPdfDocument
from vision_compression_project_tpu.raster import make_pdf
from vision_compression_project_tpu.utils import env as jenv
from vision_compression_project_tpu_torch.utils import env as tenv

REPO = Path(__file__).resolve().parent.parent
QUESTION = "How is renewable energy stored?"
_MEMORY_ID = re.compile(r"\b[A-Za-z0-9]{22}\b")
_ANSWER_FILE = re.compile(r"output/answers/\d{8}_\d{6}_answer\.md")


def _run(module, args, cwd):
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO), VCP_DEVICE="cpu", VCP_ANSWER_ENGINE="extractive")
    proc = subprocess.run(
        [sys.executable, "-m", f"vision_compression_project_tpu_torch.scripts.{module}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-1000:]
    return proc.stdout


def _mask(text):
    return _ANSWER_FILE.sub("output/answers/<ts>_answer.md", _MEMORY_ID.sub("<memory_id>", text))


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """(port workspace, JAX workspace), each with data/sample.pdf."""
    out = []
    for name in ("port", "jax"):
        ws = tmp_path_factory.mktemp(f"cli_{name}")
        (ws / "data").mkdir()
        make_pdf(["Energy Review\nBatteries store renewable energy efficiently.",
                  "Grid Systems\nTransmission lines carry power across regions."], ws / "data" / "sample.pdf")
        out.append(ws)
    return tuple(out)


@pytest.fixture(scope="module")
def jax_side(workspaces):
    """The JAX package's extract_pdf, ingest_to_index and qa_query work in
    its workspace, with the default embedder and a store under its tmp/."""
    ws = workspaces[1]
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        stats = jextract.extract_pdf_to_page_jsons("data/sample.pdf", Path("output/pages"),
                                                   images_dir=Path("output/pages"), dpi=72)
        jextract.create_manifest("data/sample.pdf", Path("output/manifest.json"), stats, dpi=72, start_page=1,
                                 end_page=None, model_name=f"vcp-tpu-{jconfig.resolve_model_preset()}")
        jextract.create_combined_markdown(Path("output/pages"), Path("output/combined.md"))
        embedder = JHashNGramEmbedder()
        store = JIndexStore(Path("tmp/_index"), dim=embedder.dim, mode="single")
        manifest_path = Path("output/supermemory_manifest.json")
        manifest = jingest.ingest_pages_dir("output/pages", "data/sample.pdf", "sample", manifest_path,
                                            embedder=embedder, store=store)
        manifest["created_at"] = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        manifest_path.write_text(json.dumps(manifest, indent=2, ensure_ascii=False), encoding="utf-8")
        smoke = store.search(embedder.embed(["Summarize the document"]), top_k=10, doc_id="sample")[0]
        phrases = jqa.rewrite_query_learned(QUESTION, embedder)
        result = jqa.answer_question(doc_id="sample", question="; ".join(phrases), top_k=8, max_chars_per_page=1500,
                                     manifest_path=manifest_path, store=store, embedder=embedder)
    finally:
        os.chdir(cwd)
    return {"stats": stats, "manifest": manifest, "smoke": smoke, "phrases": phrases, "result": result}


@pytest.fixture(scope="module")
def port_side(workspaces):
    """The port's four command lines, in a user's order, in its workspace:
    {name: stdout}."""
    ws = workspaces[0]
    return {
        "extract_pdf": _run("extract_pdf", ["--pdf", "data/sample.pdf", "--dpi", "72"], ws),
        "ingest_to_index": _run("ingest_to_index", ["--pdf_path", "data/sample.pdf"], ws),
        "qa_query": _run("qa_query", ["--question", QUESTION, "--rewrite_query"], ws),
        "extract_page": _run("extract_page", ["--pdf", "data/sample.pdf", "--dpi", "72"], ws),
    }


def _same_files(workspaces, names):
    for name in names:
        got, want = ((ws / name).read_bytes() for ws in workspaces)
        assert got == want, name


def _same_pixels(got_path, want):
    got = np.asarray(Image.open(got_path))
    assert got.shape == want.shape and np.array_equal(got, want), got_path


def test_extract_pdf(workspaces, jax_side, port_side):
    out = port_side["extract_pdf"]
    assert out.splitlines() == ["Processed 2/2 pages; 0 failed", "Manifest: output/manifest.json",
                                "Combined markdown: output/combined.md"]
    _same_files(workspaces, ["output/pages/page_001.json", "output/pages/page_002.json", "output/combined.md"])
    got, want = (json.loads((ws / "output" / "manifest.json").read_text()) for ws in workspaces)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "timestamp"} == {k: v for k, v in want.items() if k != "timestamp"}
    for i in (1, 2):
        _same_pixels(workspaces[0] / "output" / "pages" / f"page_{i:03d}.png",
                     np.asarray(Image.open(workspaces[1] / "output" / "pages" / f"page_{i:03d}.png")))


def test_ingest_to_index(workspaces, jax_side, port_side):
    out = port_side["ingest_to_index"]
    want = ["Ingested 2 pages as doc_id='sample'; 0 failed", "Manifest: output/supermemory_manifest.json", "",
            "Smoke test query: 'Summarize the document'"]
    want += [f"  {rank:2d}. page={r['metadata'].get('page')} memory_id={r['id']} score={r['score']:.3f}"
             for rank, r in enumerate(jax_side["smoke"], 1)]
    assert _mask(out).splitlines() == _mask("\n".join(want)).splitlines()
    got = json.loads((workspaces[0] / "output" / "supermemory_manifest.json").read_text())
    want_manifest = jax_side["manifest"]
    assert list(got) == list(want_manifest) == ["doc_id", "pdf_path", "pages", "failed_pages", "created_at"]
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", got["created_at"])
    assert _mask(json.dumps({**got, "created_at": ""})) == _mask(json.dumps({**want_manifest, "created_at": ""}))


def test_qa_query(workspaces, jax_side, port_side):
    out = port_side["qa_query"]
    result = jax_side["result"]
    want = [f"Rewritten query phrases: {jax_side['phrases']}", "", "=== Answer ===", "", result["answer_md"], "",
            "=== Retrieved ==="]
    want += [f"- page {r['page']} ({r['memory_id'][:8]}…)" for r in result["retrieved"]]
    want += ["", "Saved: output/answers/<ts>_answer.md"]
    masked = re.sub(r"\(\w{8}…\)", "(<id>…)", _mask(out))
    assert masked.splitlines() == re.sub(r"\(\w{8}…\)", "(<id>…)", _mask("\n".join(want))).splitlines()
    (answer,) = (workspaces[0] / "output" / "answers").glob("*_answer.md")
    assert re.fullmatch(r"\d{8}_\d{6}_answer\.md", answer.name)
    pages = "\n".join(f"- Page {r['page']}: memory_id={r['memory_id']}" for r in result["retrieved"])
    want_text = (f"# Question\n\n{QUESTION}\n\n# Answer\n\n{result['answer_md']}\n\n---\n\n"
                 f"# Retrieved Pages (for debugging)\n\n{pages}\n")
    assert _mask(answer.read_text()) == _mask(want_text)
    assert "(sample p.1" in out


def test_extract_page(workspaces, jax_side, port_side):
    out = port_side["extract_page"]
    page = json.loads((workspaces[1] / "output" / "pages" / "page_001.json").read_text())
    assert out.splitlines() == ["PDF has 2 pages", "Saved image: output/page_1.png (612x792)",
                                "Saved JSON: output/page_1.json", f"Summary: {page['summary'][:200]}"]
    assert (workspaces[0] / "output" / "page_1.json").read_text() == json.dumps(page, indent=2, ensure_ascii=False)
    with JPdfDocument(workspaces[1] / "data" / "sample.pdf") as doc:
        _same_pixels(workspaces[0] / "output" / "page_1.png", doc.render_page(0, dpi=72))


def test_env_chain_is_the_reference_chain(tmp_path, monkeypatch):
    """Both loaders look for the same .env files in the same order, the first
    being the repo root's."""
    seen = {}
    for name, module in (("port", tenv), ("jax", jenv)):
        calls = seen.setdefault(name, [])
        monkeypatch.setattr(Path, "exists", lambda self, calls=calls: calls.append(str(self.resolve())) and False)
        assert module.load_env_chain() is None
        monkeypatch.undo()
    assert seen["port"] == seen["jax"] and seen["port"][0] == str(REPO / ".env")


def test_config_reads_the_env_file_at_import(tmp_path):
    """A .env that sets VCP_EXTRACT_ENGINE and VCP_TMP_DIR reaches the port's
    RUNTIME and BASE_TMP_DIR, as it reaches the JAX package's."""
    (tmp_path / ".env").write_text('# deployment\nVCP_EXTRACT_ENGINE="text"\nVCP_TMP_DIR=served\n')
    chain = [REPO / ".env", tmp_path / ".env"]
    values = tenv._parse_env_file(next(p for p in chain if p.exists()))
    env = {k: v for k, v in os.environ.items() if not k.startswith("VCP_")}
    env.update(PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", "from vision_compression_project_tpu_torch import config as c; "
                               "print(c.RUNTIME.extract_engine, c.BASE_TMP_DIR)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [values.get("VCP_EXTRACT_ENGINE", "auto"), values.get("VCP_TMP_DIR", "tmp")]


_STEP_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  pages/s \d+\.\d  \(inst \d+\.\d\)  host enqueue ms/step "
                        r"feed (\d+\.\d\d|-) forward (\d+\.\d\d|-) backward (\d+\.\d\d|-) optimizer (\d+\.\d\d|-)$")


def test_train_vlm_two_steps_on_the_cpu(tmp_path):
    """`train_vlm --preset tiny --steps 2`: the JAX script's step lines and
    checkpoint line, a checkpoint load_runner reads, and a warm start from
    it."""
    from vision_compression_project_tpu_torch.models import get_preset
    from vision_compression_project_tpu_torch.train import checkpoint as tckpt

    out = _run("train_vlm", ["--preset", "tiny", "--steps", "2", "--batch", "2", "--log_every", "1",
                             "--text_len", "64", "--ckpt_dir", "ck"], tmp_path).splitlines()
    assert out[0] == "device: cpu (cpu)"
    assert len(out) == 4 and all(_STEP_LINE.match(line) for line in out[1:3]), out
    assert all("-" not in _STEP_LINE.match(line).groups() for line in out[1:3]), out
    assert out[3] == f"final checkpoint: {(tmp_path / 'ck' / 'step_00000002').resolve()}"
    runner = tckpt.load_runner(get_preset("tiny"), tmp_path / "ck", device="cpu")
    fresh = tckpt.load_runner(get_preset("tiny"), tmp_path / "none", device="cpu")
    assert any(not bool((runner.model.state_dict()[k] == v).all()) for k, v in fresh.model.state_dict().items())
    warm = _run("train_vlm", ["--preset", "tiny", "--steps", "1", "--batch", "1", "--text_len", "32",
                              "--init_from", "ck", "--ckpt_dir", "ck2"], tmp_path).splitlines()
    assert warm[1] == "warm-started params from ck" and _STEP_LINE.match(warm[2])


def test_train_vlm_pipeline_parallel_on_the_cpu(tmp_path):
    """`train_vlm --pp_microbatches 2` alone: the decoder through one GPipe
    stage, the reference's PP line, the step lines and a checkpoint that
    load_runner reads."""
    from vision_compression_project_tpu_torch.models import get_preset
    from vision_compression_project_tpu_torch.train import checkpoint as tckpt

    out = _run("train_vlm", ["--preset", "tiny", "--steps", "2", "--batch", "4", "--text_len", "32",
                             "--pp_microbatches", "2", "--log_every", "1", "--ckpt_dir", "ck"], tmp_path).splitlines()
    assert out[:2] == ["device: cpu (cpu)", "PP training: 2 microbatches over 1 pipeline stage(s)"]
    assert len(out) == 5 and all(_STEP_LINE.match(line) for line in out[2:4]), out
    # The pipelined step times the feed and the optimizer, not train_step's forward and backward.
    assert all(_STEP_LINE.match(line).groups()[1:3] == ("-", "-") for line in out[2:4]), out
    assert out[4] == f"final checkpoint: {(tmp_path / 'ck' / 'step_00000002').resolve()}"
    runner = tckpt.load_runner(get_preset("tiny"), tmp_path / "ck", device="cpu")
    assert sorted(runner.model.state_dict()) == sorted(tckpt.load_runner(get_preset("tiny"), tmp_path / "none",
                                                                          device="cpu").model.state_dict())


def test_train_vlm_refuses_a_batch_the_microbatches_do_not_divide(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), VCP_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "vision_compression_project_tpu_torch.scripts.train_vlm", "--batch", "3",
         "--pp_microbatches", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2 and proc.stderr.splitlines()[-1].endswith(
        "error: --batch must be divisible by --pp_microbatches")
    assert not (tmp_path / "checkpoints").exists()


def test_train_embedder_two_steps_on_the_cpu(tmp_path):
    from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
    from vision_compression_project_tpu_torch.models.embedder import NeuralEmbedder
    from vision_compression_project_tpu_torch.train import checkpoint as tckpt
    from vision_compression_project_tpu_torch.weights import params_from_jax

    out = _run("train_embedder", ["--steps", "2", "--batch", "4", "--dim", "64", "--depth", "1",
                                  "--log_every", "1", "--ckpt_dir", "ck"], tmp_path).splitlines()
    assert [re.sub(r"\d+\.\d{4}", "L", re.sub(r"pairs/s \d+", "pairs/s R", line)) for line in out[:2]] == [
        "step     1  loss L  pairs/s R", "step     2  loss L  pairs/s R"]
    assert out[2] == f"checkpoint: {(tmp_path / 'ck' / 'step_00000002').resolve()}"
    params = params_from_jax(tckpt.load_params(tmp_path / "ck"))
    embedder = NeuralEmbedder(EmbedderConfig(dim=64, depth=1), params=params, device="cpu")
    vec = embedder.embed(["a trained embedder reads this"])
    assert vec.shape == (1, 64) and abs(float((vec ** 2).sum()) - 1.0) < 1e-5
